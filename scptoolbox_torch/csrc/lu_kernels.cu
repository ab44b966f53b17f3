// Batched small-block LU with partial pivoting, and its substitution solve,
// for NVIDIA Hopper (sm_90a). Plain C interface, loaded with ctypes from
// scptoolbox_torch/ops/lu_kernels.py.
//
// Replaces the TPU kernels of scptoolbox_tpu/ops/pallas_kernels.py:
//   lu_factor_*  <- _lu_factor_kernel (:373) behind lu_factor_lanes (:554)
//   lu_solve_*   <- _lu_solve_kernel (:449) behind lu_solve_lanes (:599)
// They compute what those compute (scipy's lu_factor / lu_solve contract:
// unit-L below the diagonal, U on and above it, the per-step pivot-row
// record; pivot = first index of max |a_ij| at or below the diagonal; a
// pivot below 1e-30 in magnitude is floored with its sign kept). The TPU's
// batch-in-128-lanes layout, (8, 128) padding and identity padding do not
// carry over.
//
// What bounds them on this card. At the main path's shapes (s = 158 or
// 145, 32..512 matrices; s = 29 or 16, 128..2048 matrices; K = 2, 37 or s
// columns) neither bytes nor flops: the factor is s dependent steps of
// (argmax, swap, rank-1 update), the solve 2s dependent substitution steps.
//
// The factor has three designs, chosen by the launcher from s:
// * s <= 32: a warp per matrix, four matrices a block. Lane i holds row i
//   in registers; the pivot search is two warp reductions (the largest
//   key, then the smallest position holding it), the pivot row reaches
//   every lane by shuffles, and the swap only exchanges two lanes' row
//   positions (the rows are written out by position at the end). No block
//   barrier at all.
// * s > 32: one block per matrix, the matrix in shared memory (copied in
//   with cp.async), in 32-column panels. Swaps are virtual: a position ->
//   physical row map, so no row ever moves in shared memory. The panel's
//   rows (all rows at or below it) are held a row a thread in registers;
//   one block barrier a column: each warp offers its best candidate row,
//   every thread picks the same winner (vector loads and selects, no
//   branch), the rows update the next column first so that the next
//   step's warp reductions overlap the rest of the row update, and
//   threads without a row build the panel's 32 rows of U right of it, a
//   column each, as the pivot rows arrive. Then the trailing block, a
//   warp per 4 rows and up to 128 columns in registers (4 x CT tiles),
//   each entry taking the panel's 32 updates in column order: two block
//   barriers a panel. A panel of at most 32 rows (the last) is one warp's,
//   as in the small design.
// * beyond a block's shared memory (float64 above s = 168, float32 above
//   239: the staged sweeps' arrow Schur complements, 694 wide on the
//   softplus quadrotor): a cooperative grid, G blocks a matrix (all the
//   SMs for one), the matrix in device memory (a workspace by physical
//   row, L2-resident), in 32-column panels. What bounds it is the chain of
//   s pivot steps and the barriers of the grid between panels (the bound
//   by bytes and flops is 3.3 us at 694 float64). Per panel, two grid
//   barriers: (1) one block of 512 threads factors the panel, a row a
//   thread in registers and the rows past 512 staged in shared memory (up
//   to 3 a thread; past what shared memory holds, about s = 1300 in
//   float64 and 2048 in float32, the rest of a panel's rows stay in the
//   workspace and take each step through L2: s up to ~22000 in float64),
//   one block barrier a column; each warp offers its candidate row, the
//   row itself copied into a shared buffer, so that the winner's row is
//   read from there; the swaps are virtual (a position map in device
//   memory that every block reads); (2) every SM takes 64 x 64 tiles of
//   the trailing block: a tile solves its columns' 32 rows of U with the
//   panel's unit-L diagonal block (warp shuffles, a lane a row; the tiles
//   of a column solve them alike, the first writes them out), then each
//   entry takes the panel's 32 products in column
//   order in a register tile. Each trailing entry crosses L2 once a
//   panel, not once a column.
//   At s = 694: 45 grid barriers instead of 695. A look-ahead (the next
//   panel factored while the trailing update runs) was left out: the next
//   panel's columns would first need the whole panel's update on one SM,
//   about as long as the factor itself.
// The solve runs in 32-row panels (panel_solve.cuh): three barriers a panel
// instead of one a row, the factor's panels copied coalesced into shared
// memory one panel ahead with cp.async, the diagonal blocks chained by warp
// shuffles (few columns) or in a thread's registers (many), the rows past a
// panel updated in register tiles. The swaps are composed into one
// permutation by every thread at once and applied while loading the RHS.
// Few columns are split over blocks while the card has idle SMs; many go in
// tiles of up to 64 columns, the matrix index slowest, so that a matrix's
// tiles read its factor from L2 together.
// Where two of the factor's 32-column panels do not fit in shared memory
// (float64 above s = 427, float32 above 842: the softplus quadrotor's
// 694-wide arrow), a few matrices take thread-block clusters
// (cluster_solve.cuh): the panels dealt over a cluster of 8 blocks (16
// where 8 do not hold their rows, float64 above s ~ 3000), X's rows in
// their shared memory, every block gathering its rows of B through the
// composed swaps, the factor's row segments staged coalesced ahead of
// their step, one cluster barrier a panel in each pass; as many clusters a
// matrix as the card holds share its columns. Past that (more matrices
// than the card holds clusters, or float64 above s ~ 6100), one block per
// matrix and up to 32 columns keeps X's rows in shared memory and reads
// the factor from device memory: the same 32-row panels, the diagonal
// block a thread per column in registers, the rows past it a thread per
// entry.
//
// Built with -fmad=false so that multiplications and subtractions round
// exactly as the plain PyTorch version's separate operations do. Every
// entry of the factor takes the plain version's updates in its order (a
// blocked order changes which entries are updated when, not the operations
// an entry sees), so the tableau and the pivot record agree with the plain
// version's bit for bit.

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cluster_solve.cuh"
#include "panel_solve.cuh"

namespace {

namespace cg = cooperative_groups;
constexpr unsigned kAll = 0xffffffffu;
constexpr int kPW = 32;              // panel width
constexpr int kPanelThreads = 256;
constexpr int kPanelWarps = kPanelThreads / 32;
constexpr int kRT = 4;               // trailing tiles: rows a warp task
constexpr int kSmallWarps = 4;       // s <= 32: matrices a block
using panel::pivot_recip;

// The pivot search's order key of an entry: the bits of |a| plus one, NaN
// counted as +inf; a row that takes no part has key 0. A larger key is a
// larger |a|, equal keys equal |a|.
template <typename T> struct KeyOf;
template <> struct KeyOf<float> { using type = unsigned; };
template <> struct KeyOf<double> { using type = unsigned long long; };

__device__ __forceinline__ unsigned pivot_key(float a) {
  const unsigned u = __float_as_uint(a) & 0x7fffffffu;
  return (u > 0x7f800000u ? 0x7f800000u : u) + 1u;
}
__device__ __forceinline__ unsigned long long pivot_key(double a) {
  const unsigned long long u =
      (unsigned long long)__double_as_longlong(a) & 0x7fffffffffffffffULL;
  return (u > 0x7ff0000000000000ULL ? 0x7ff0000000000000ULL : u) + 1ULL;
}

// the warp's largest key
__device__ __forceinline__ unsigned warp_max(unsigned k) {
  return __reduce_max_sync(kAll, k);
}
__device__ __forceinline__ unsigned long long warp_max(unsigned long long k) {
  const unsigned hi = __reduce_max_sync(kAll, (unsigned)(k >> 32));
  const unsigned lo = __reduce_max_sync(
      kAll, (unsigned)(k >> 32) == hi ? (unsigned)k : 0u);
  return ((unsigned long long)hi << 32) | lo;
}

// Factor columns j0 .. j0 + w - 1 (w <= KS) of the rows one warp holds,
// a row a lane in registers: v[t] is column j0 + t of the lane's row, pos
// its position (lanes without a row hold positions no step reaches, and
// has_row false). A step: the pivot is the lane the step's reductions
// found (the largest key, then the smallest position holding it); its
// pivot reciprocal and row reach every lane by shuffles; the swap only
// exchanges two positions. The next column is updated first and its
// reductions start before the rest of the row is updated, and every lane
// takes its own pivot reciprocal beside them, so the chain a step is two
// reductions, a ballot and two shuffles. rec: lane t's is step j0 + t's
// pivot position.
template <typename T, int KS>
__device__ __forceinline__ void warp_lu(T (&v)[KS], int& pos, int& rec,
                                        bool has_row, int j0, int w,
                                        int lane) {
  using K = typename KeyOf<T>::type;
  K key = has_row ? pivot_key(v[0]) : K(0);
  T dn = pivot_recip(v[0]);
  K best = warp_max(key);
  int r = (int)__reduce_min_sync(kAll, key == best ? (unsigned)pos
                                                   : 0xffffffffu);
#pragma unroll
  for (int jj = 0; jj < KS; ++jj) {
    if (jj >= w) break;
    const int j = j0 + jj;
    const int src = __ffs(__ballot_sync(kAll, pos == r)) - 1;
    if (lane == jj) rec = r;
    const T d = __shfl_sync(kAll, dn, src);
    if (pos == r) pos = j;
    else if (pos == j) pos = r;
    const bool upd = has_row && pos > j;
    const T l = v[jj] * d;
    if (jj + 1 < KS) {
      const T u1 = __shfl_sync(kAll, v[jj + 1], src);
      if (upd) v[jj + 1] = v[jj + 1] - l * u1;
      key = upd ? pivot_key(v[jj + 1]) : K(0);
      dn = pivot_recip(v[jj + 1]);
      best = warp_max(key);
      r = (int)__reduce_min_sync(kAll, key == best ? (unsigned)pos
                                                   : 0xffffffffu);
    }
#pragma unroll
    for (int c = jj + 2; c < KS; ++c) {
      const T u = __shfl_sync(kAll, v[c], src);
      if (upd) v[c] = v[c] - l * u;
    }
    if (upd) v[jj] = l;
  }
}

// s <= 32: a warp per matrix. Lane i holds row i (KS = 16 or 32 columns
// in registers; lanes >= s hold no row). S: the warp's staging area, row
// stride s | 1 (odd: a lane per row touches every bank once), filled with
// cp.async.
template <typename T, int KS>
__global__ void __launch_bounds__(kSmallWarps * 32)
lu_factor_warp_kernel(const T* __restrict__ in, T* __restrict__ out,
                      int32_t* __restrict__ perm, long long nb, int s) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long mat = (long long)blockIdx.x * kSmallWarps + warp;
  if (mat >= nb) return;
  const int ld = s | 1;
  T* S = reinterpret_cast<T*>(smem_raw) + warp * KS * (KS | 1);
  const T* src = in + mat * s * s;
  T* dst = out + mat * s * s;

  for (int i = 0; i < s; ++i)
    if (lane < s)
      __pipeline_memcpy_async(S + i * ld + lane, src + (int64_t)i * s + lane,
                              sizeof(T));
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncwarp();
  const bool has_row = lane < s;
  T v[KS];
#pragma unroll
  for (int c = 0; c < KS; ++c)
    v[c] = (has_row && c < s) ? S[lane * ld + c] : T(0);

  int pos = lane;          // the row's position; lanes >= s stay at >= s
  int rec = 0;
  warp_lu<T, KS>(v, pos, rec, has_row, 0, s, lane);

  __syncwarp();
  if (has_row) {
#pragma unroll
    for (int c = 0; c < KS; ++c)
      if (c < s) S[pos * ld + c] = v[c];
  }
  __syncwarp();
  for (int i = 0; i < s; ++i)
    if (lane < s) dst[(int64_t)i * s + lane] = S[i * ld + lane];
  if (lane < s) perm[mat * s + lane] = rec;
}

// The panel design's shared memory: two buffers of each warp's candidate
// pivot row (16-byte aligned, written and read as vectors) and of its
// pivot reciprocal, order key and order word (the position and the warp);
// the matrix by physical row (s x s); the candidates' physical rows; the
// position -> physical row map.
template <typename T>
struct PanelSmem {
  using K = typename KeyOf<T>::type;
  T* Cv;
  T* Cd;
  K* Ck;
  unsigned* Co;
  T* W;
  int* Ch;
  int* Pm;
  __device__ PanelSmem(unsigned char* raw, int s) {
    Cv = reinterpret_cast<T*>(raw);
    Cd = Cv + 2 * kPanelWarps * kPW;
    Ck = reinterpret_cast<K*>(Cd + 2 * kPanelWarps);
    Co = reinterpret_cast<unsigned*>(Ck + 2 * kPanelWarps);
    W = reinterpret_cast<T*>(Co + 2 * kPanelWarps + 4);   // 16-byte aligned
    Ch = reinterpret_cast<int*>(W + (size_t)s * s);
    Pm = Ch + 2 * kPanelWarps;
  }
};

template <typename T>
__host__ __device__ constexpr size_t panel_smem_bytes(int s) {
  return (2 * kPanelWarps * (kPW + 1) + (size_t)s * s) * sizeof(T) +
         2 * kPanelWarps * sizeof(typename KeyOf<T>::type) +
         (2 * kPanelWarps + 4) * sizeof(unsigned) +
         (2 * kPanelWarps + (size_t)s) * sizeof(int);
}

// A candidate's order word: larger for a smaller position; the warp in the
// low byte. Among equal keys the largest word is the first position.
__device__ __forceinline__ unsigned order_word(int pos, int warp) {
  return ((0xffffu - (unsigned)pos) << 8) | (unsigned)warp;
}

// The winner's order word among the kPanelWarps candidates at Ck, Co
// (entries at and past nw do not count): the largest key, then the
// largest order word. Loaded as vectors, picked by selects, no branch.
__device__ __forceinline__ unsigned pick_winner(const unsigned* Ck,
                                                const unsigned* Co, int nw) {
  const uint4 k0 = *reinterpret_cast<const uint4*>(Ck);
  const uint4 k1 = *reinterpret_cast<const uint4*>(Ck + 4);
  const uint4 o0 = *reinterpret_cast<const uint4*>(Co);
  const uint4 o1 = *reinterpret_cast<const uint4*>(Co + 4);
  const unsigned kk[8] = {k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w};
  const unsigned oo[8] = {o0.x, o0.y, o0.z, o0.w, o1.x, o1.y, o1.z, o1.w};
  unsigned long long c[8];
#pragma unroll
  for (int q = 0; q < 8; ++q)
    c[q] = q < nw ? ((unsigned long long)kk[q] << 32) | oo[q] : 0ULL;
#pragma unroll
  for (int h = 1; h < 8; h *= 2) {
#pragma unroll
    for (int q = 0; q + h < 8; q += 2 * h)
      c[q] = c[q] > c[q + h] ? c[q] : c[q + h];
  }
  return (unsigned)c[0];
}
__device__ __forceinline__ unsigned pick_winner(const unsigned long long* Ck,
                                                const unsigned* Co, int nw) {
  unsigned long long kk[8];
#pragma unroll
  for (int q = 0; q < 8; q += 2) {
    const ulonglong2 t = *reinterpret_cast<const ulonglong2*>(Ck + q);
    kk[q] = t.x;
    kk[q + 1] = t.y;
  }
  const uint4 o0 = *reinterpret_cast<const uint4*>(Co);
  const uint4 o1 = *reinterpret_cast<const uint4*>(Co + 4);
  unsigned oo[8] = {o0.x, o0.y, o0.z, o0.w, o1.x, o1.y, o1.z, o1.w};
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    kk[q] = q < nw ? kk[q] : 0ULL;
    oo[q] = q < nw ? oo[q] : 0u;
  }
#pragma unroll
  for (int h = 1; h < 8; h *= 2) {
#pragma unroll
    for (int q = 0; q + h < 8; q += 2 * h) {
      const bool t = kk[q + h] > kk[q] ||
                     (kk[q + h] == kk[q] && oo[q + h] > oo[q]);
      kk[q] = t ? kk[q + h] : kk[q];
      oo[q] = t ? oo[q + h] : oo[q];
    }
  }
  return oo[0];
}

// 16-byte vectors of a row in shared memory, and (through L2) in device
// memory
template <typename T> constexpr int kVec = 16 / sizeof(T);
__device__ __forceinline__ void ldcg_vec(const float* p, float* o) {
  const float4 t = __ldcg(reinterpret_cast<const float4*>(p));
  o[0] = t.x; o[1] = t.y; o[2] = t.z; o[3] = t.w;
}
__device__ __forceinline__ void ldcg_vec(const double* p, double* o) {
  const double2 t = __ldcg(reinterpret_cast<const double2*>(p));
  o[0] = t.x; o[1] = t.y;
}
__device__ __forceinline__ void stcg_vec(float* p, const float* v) {
  __stcg(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}
__device__ __forceinline__ void stcg_vec(double* p, const double* v) {
  __stcg(reinterpret_cast<double2*>(p), make_double2(v[0], v[1]));
}
__device__ __forceinline__ void ld_vec(const float* p, float* o) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  o[0] = t.x; o[1] = t.y; o[2] = t.z; o[3] = t.w;
}
__device__ __forceinline__ void ld_vec(const double* p, double* o) {
  const double2 t = *reinterpret_cast<const double2*>(p);
  o[0] = t.x; o[1] = t.y;
}
__device__ __forceinline__ void st_vec(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void st_vec(double* p, const double* v) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}

// A full panel (columns p0 .. p0 + 31) over more than 32 rows, by the
// whole block, one block barrier a column. Thread t holds the row at
// position p0 + t (at the start) in registers; the last nc threads each
// own a column right of the panel, p0 + 32 + (nt - 1 - t), and build its
// 32 rows of U as the pivot rows arrive. A step: after the barrier every
// thread picks the same winner among the warps' candidates (the largest
// key, the smallest position among equal keys; vector loads and selects)
// and reads its pivot reciprocal; the rows below read the pivot row as
// vectors, update their next column, start the next step's warp
// reductions, then update the rest of the row; each warp offers its next
// candidate in the other buffer; the column owners take the pivot row's
// multipliers.
template <typename T>
__device__ __forceinline__ void factor_panel_block(const PanelSmem<T>& sm,
                                                   int32_t* __restrict__ prec,
                                                   int s, int p0, int nw,
                                                   int nc, int tid, int nt) {
  using K = typename KeyOf<T>::type;
  constexpr int V = kVec<T>;
  const int warp = tid >> 5;
  const bool rows = warp < nw;               // the warp holds rows
  const bool has_row = tid < s - p0;
  const int ph = has_row ? sm.Pm[p0 + tid] : 0;
  int pos = has_row ? p0 + tid : s + tid;    // no row: a position never used
  T v[kPW];
#pragma unroll
  for (int c = 0; c < kPW; ++c)
    v[c] = has_row ? sm.W[(size_t)ph * s + p0 + c] : T(0);
  const int q = nt - 1 - tid;
  const bool has_col = q < nc;
  const int col = p0 + kPW + q;
  T x[kPW];               // column col's rows of U, by step
  int rec = 0;            // thread j: step p0 + j's pivot position

  // step 0's candidates
  if (rows) {
    const K key = has_row ? pivot_key(v[0]) : K(0);
    const T dn = pivot_recip(v[0]);
    const K best = warp_max(key);
    const unsigned bpos = __reduce_min_sync(
        kAll, key == best ? (unsigned)pos : 0xffffffffu);
    if ((unsigned)pos == bpos) {
#pragma unroll
      for (int c = 0; c < kPW; c += V) st_vec(sm.Cv + warp * kPW + c, v + c);
      sm.Cd[warp] = dn;
      sm.Ck[warp] = best;
      sm.Co[warp] = order_word(pos, warp);
      sm.Ch[warp] = ph;
    }
  }
#pragma unroll
  for (int jj = 0; jj < kPW; ++jj) {
    const int j = p0 + jj;
    const int b = (jj & 1) * kPanelWarps;
    __syncthreads();                 // step jj's candidates are offered
    const unsigned won = pick_winner(sm.Ck + b, sm.Co + b, nw);
    const int bw = (int)(won & 0xffu);
    const int r = (int)(0xffffu - (won >> 8));
    const T* urow = sm.Cv + (b + bw) * kPW;
    const T d = sm.Cd[b + bw];
    if (tid == jj) rec = r;
    if (pos == r) pos = j;
    else if (pos == j) pos = r;
    const bool upd = has_row && pos > j;
    if (rows) {
      T u[kPW];           // the pivot row right of the next column's
#pragma unroll
      for (int c = 0; c < kPW; c += V)
        if (c + V > jj + 1) ld_vec(urow + c, u + c);
      const T l = v[jj] * d;
      // the next column, then the next step's warp reductions
      K nbest = K(0);
      unsigned npos = 0xffffffffu;
      T nd = T(0);
      if (jj + 1 < kPW) {
        if (upd) v[jj + 1] = v[jj + 1] - l * u[jj + 1];
        const K key = upd ? pivot_key(v[jj + 1]) : K(0);
        nd = pivot_recip(v[jj + 1]);
        nbest = warp_max(key);
        npos = __reduce_min_sync(kAll, key == nbest ? (unsigned)pos
                                                    : 0xffffffffu);
      }
#pragma unroll
      for (int c = jj + 2; c < kPW; ++c)
        v[c] = upd ? v[c] - l * u[c] : v[c];
      if (upd) v[jj] = l;
      // offer step jj + 1's candidate
      if (jj + 1 < kPW && (unsigned)pos == npos) {
        const int b1 = ((jj + 1) & 1) * kPanelWarps;
#pragma unroll
        for (int c = 0; c < kPW; c += V)
          st_vec(sm.Cv + (b1 + warp) * kPW + c, v + c);
        sm.Cd[b1 + warp] = nd;
        sm.Ck[b1 + warp] = nbest;
        sm.Co[b1 + warp] = order_word(pos, warp);
        sm.Ch[b1 + warp] = ph;
      }
    }
    // column col's row j of U: the pivot row's multipliers in step order
    if (has_col) {
      const int phr = sm.Ch[b + bw];
      T xv = sm.W[(size_t)phr * s + col];
#pragma unroll
      for (int c = 0; c < kPW; c += V) {
        if (c < jj) {
          T u[V];
          ld_vec(urow + c, u);
#pragma unroll
          for (int e = 0; e < V; ++e)
            if (c + e < jj) xv = xv - u[e] * x[c + e];
        }
      }
      x[jj] = xv;
      sm.W[(size_t)phr * s + col] = xv;
    }
  }
  // every thread read its map entry before the first barrier
  if (has_row) {
#pragma unroll
    for (int c = 0; c < kPW; ++c) sm.W[(size_t)ph * s + p0 + c] = v[c];
    sm.Pm[pos] = ph;
  }
  if (tid < kPW) prec[p0 + tid] = rec;
}

// The last panel (columns p0 .. s - 1, at most 32 rows and columns), by
// one warp (warp_lu), no barrier.
template <typename T>
__device__ __forceinline__ void factor_panel_warp(const PanelSmem<T>& sm,
                                                  int32_t* __restrict__ prec,
                                                  int s, int p0, int lane) {
  const int w = s - p0;
  const bool has_row = lane < w;
  const int ph = has_row ? sm.Pm[p0 + lane] : 0;
  int pos = has_row ? p0 + lane : s + lane;
  T v[kPW];
#pragma unroll
  for (int c = 0; c < kPW; ++c)
    v[c] = (has_row && c < w) ? sm.W[(size_t)ph * s + p0 + c] : T(0);
  int rec = 0;
  warp_lu<T, kPW>(v, pos, rec, has_row, p0, w, lane);
  __syncwarp();           // every lane has read its map entry
  if (has_row) {
#pragma unroll
    for (int c = 0; c < kPW; ++c)
      if (c < w) sm.W[(size_t)ph * s + p0 + c] = v[c];
    sm.Pm[pos] = ph;
  }
  if (lane < w) prec[p0 + lane] = rec;
}

// Rows r0 .. r0 + rn - 1 (positions, rn <= kRT) and columns c0 .. c0 + cw
// - 1 (cw <= 32 CT) of the trailing block take the panel's 32 updates in
// registers, lane l holding columns c0 + l + 32 q (a clamped row or column
// is computed twice and stored once). ub[k]: where U row p0 + k starts.
template <typename T, int CT>
__device__ __forceinline__ void trailing_tile(const PanelSmem<T>& sm,
                                              const int* ub, int s, int p0,
                                              int r0, int rn, int c0, int cw,
                                              int lane) {
  int rb[kRT], cc[CT];
#pragma unroll
  for (int p = 0; p < kRT; ++p)
    rb[p] = sm.Pm[r0 + (p < rn ? p : rn - 1)] * s;
#pragma unroll
  for (int q = 0; q < CT; ++q) {
    const int c = lane + 32 * q;
    cc[q] = c0 + (c < cw ? c : cw - 1);
  }
  T acc[kRT][CT];
#pragma unroll
  for (int p = 0; p < kRT; ++p) {
#pragma unroll
    for (int q = 0; q < CT; ++q) acc[p][q] = sm.W[rb[p] + cc[q]];
  }
#pragma unroll
  for (int k = 0; k < kPW; ++k) {
    T l[kRT], u[CT];
#pragma unroll
    for (int p = 0; p < kRT; ++p) l[p] = sm.W[rb[p] + p0 + k];
#pragma unroll
    for (int q = 0; q < CT; ++q) u[q] = sm.W[ub[k] + cc[q]];
#pragma unroll
    for (int p = 0; p < kRT; ++p) {
#pragma unroll
      for (int q = 0; q < CT; ++q) acc[p][q] = acc[p][q] - l[p] * u[q];
    }
  }
#pragma unroll
  for (int p = 0; p < kRT; ++p) {
#pragma unroll
    for (int q = 0; q < CT; ++q)
      if (p < rn && lane + 32 * q < cw) sm.W[rb[p] + cc[q]] = acc[p][q];
  }
}

// The trailing block (positions and columns p0 + 32 .. s - 1): a warp per
// 4 rows and up to 128 columns.
template <typename T>
__device__ __forceinline__ void panel_trailing(const PanelSmem<T>& sm, int s,
                                               int p0, int tid, int nt) {
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nt >> 5;
  const int i0 = p0 + kPW;
  const int n = s - i0;
  const int ngr = (n + kRT - 1) / kRT;
  const int nch = (n + 127) / 128;
  int ub[kPW];
#pragma unroll
  for (int k = 0; k < kPW; ++k) ub[k] = sm.Pm[p0 + k] * s;
  for (int task = warp; task < ngr * nch; task += nwarps) {
    const int g = task / nch;
    const int c0 = i0 + (task - g * nch) * 128;
    const int cw = min(128, s - c0);
    const int r0 = i0 + g * kRT;
    const int rn = min(kRT, s - r0);
    switch ((cw + 31) >> 5) {
      case 1: trailing_tile<T, 1>(sm, ub, s, p0, r0, rn, c0, cw, lane); break;
      case 2: trailing_tile<T, 2>(sm, ub, s, p0, r0, rn, c0, cw, lane); break;
      case 3: trailing_tile<T, 3>(sm, ub, s, p0, r0, rn, c0, cw, lane); break;
      default: trailing_tile<T, 4>(sm, ub, s, p0, r0, rn, c0, cw, lane);
    }
  }
}

// s > 32: one block per matrix, 32-column panels.
template <typename T>
__global__ void __launch_bounds__(kPanelThreads, sizeof(T) == 4 ? 2 : 1)
lu_factor_panel_kernel(const T* __restrict__ in, T* __restrict__ out,
                       int32_t* __restrict__ perm, int s) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const PanelSmem<T> sm(smem_raw, s);
  const int64_t mat = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const T* src = in + mat * (int64_t)s * s;
  int32_t* prec = perm + mat * s;

  constexpr int V = kVec<T>;
  if ((s * s) % V == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    for (int e = tid * V; e < s * s; e += nt * V)     // 16-byte copies
      __pipeline_memcpy_async(sm.W + e, src + e, 16);
  } else {
    for (int e = tid; e < s * s; e += nt)
      __pipeline_memcpy_async(sm.W + e, src + e, sizeof(T));
  }
  __pipeline_commit();
  for (int i = tid; i < s; i += nt) sm.Pm[i] = i;
  __pipeline_wait_prior(0);
  __syncthreads();

  for (int p0 = 0; p0 < s; p0 += kPW) {
    const int nw = (s - p0 + 31) >> 5;      // warps holding the panel's rows
    if (nw > 1)
      factor_panel_block<T>(sm, prec, s, p0, nw, max(0, s - p0 - kPW), tid,
                            nt);
    else if (warp == 0)
      factor_panel_warp<T>(sm, prec, s, p0, lane);
    __syncthreads();                          // the panel is factored
    if (p0 + kPW >= s) break;
    panel_trailing<T>(sm, s, p0, tid, nt);
    __syncthreads();                          // the trailing block is done
  }

  T* dst = out + mat * (int64_t)s * s;
  if (s % V == 0 && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    for (int i = warp; i < s; i += nt >> 5) {         // 16-byte copies
      const T* row = sm.W + (size_t)sm.Pm[i] * s;
      for (int c = lane * V; c < s; c += 32 * V) {
        T t[V];
        ld_vec(row + c, t);
        st_vec(dst + (int64_t)i * s + c, t);
      }
    }
  } else {
    for (int i = warp; i < s; i += nt >> 5) {
      const T* row = sm.W + (size_t)sm.Pm[i] * s;
      for (int c = lane; c < s; c += 32) dst[(int64_t)i * s + c] = row[c];
    }
  }
}

// ---------------------------------------------------------------------------
// Beyond a block's shared memory: the blocked grid design.

constexpr int kGridThreads = 512;
constexpr int kGridWarps = kGridThreads / 32;
constexpr int kSpill = 3;                  // staged panel rows a thread, most
constexpr int kGridMaxS = kGridThreads * (1 + kSpill);
// The staged rows a thread an instance is built for: one while the panel
// has at most 1024 rows (fewer registers), else kSpill.
inline int grid_spill_instance(int s) {
  return s <= 2 * kGridThreads ? 1 : kSpill;
}
constexpr int kGridMaxPos = 0xffff;        // order_word's positions
constexpr int kGLd = kPW + 1;              // staged panel row stride
constexpr int kGT = 64;                    // trailing tiles: rows, columns
constexpr int kGUs = kGT + 1;              // a tile's U strip row stride

// Entries of T in the shared memory that the panel and the trailing tiles
// share: rs staged panel rows, or a tile's unit-L block, U strip and rows
// of L (a multiple of four entries).
__host__ __device__ constexpr size_t grid_union_elems(int rs) {
  return (((size_t)rs * kGLd > (size_t)(kPW * kGLd + kPW * kGUs + kGT * kGLd)
               ? (size_t)rs * kGLd
               : (size_t)(kPW * kGLd + kPW * kGUs + kGT * kGLd)) + 3) / 4 * 4;
}

template <typename T>
__host__ __device__ constexpr size_t grid_smem_bytes(int s, int rs) {
  return (grid_union_elems(rs) + 2 * kGridWarps * (kPW + 1)) * sizeof(T) +
         2 * kGridWarps * (sizeof(typename KeyOf<T>::type) + sizeof(int)) +
         2 * (size_t)s * sizeof(int);
}

// The rows past the registers' a panel at s stages in shared memory.
__host__ __device__ constexpr int grid_spill_rows(int s) {
  return s > kGridThreads ? s - kGridThreads : 0;
}

// The grid design's shared memory (sr: the staged rows it has room for).
template <typename T>
struct GridSmem {
  using K = typename KeyOf<T>::type;
  T* S;          // the staged panel rows, kGLd apart
  T* Ld;         // the panel's unit-L block: Ld[t * kGLd + r] = L(r, t)
  T* Us;         // a tile's U strip: Us[r * kGUs + c]
  T* Lt;         // a tile's rows' panel entries: Lt[r * kGLd + t]
  T* Cv;         // two buffers of each warp's candidate: its row,
  T* Cd;         // pivot reciprocal,
  K* Ck;         // order key
  unsigned* Co;  // and order word
  int* Pm;       // position -> physical row
  int* Ps;       // a panel's slot -> physical row
  __device__ GridSmem(unsigned char* raw, int s, int sr) {
    S = reinterpret_cast<T*>(raw);
    Ld = S;
    Us = Ld + kPW * kGLd;
    Lt = Us + kPW * kGUs;
    Cv = S + grid_union_elems(sr);
    Cd = Cv + 2 * kGridWarps * kPW;
    Ck = reinterpret_cast<K*>(Cd + 2 * kGridWarps);
    Co = reinterpret_cast<unsigned*>(Ck + 2 * kGridWarps);
    Pm = reinterpret_cast<int*>(Co + 2 * kGridWarps);
    Ps = Pm + s;
  }
};

// The winner's order word among the kGridWarps candidates at Ck, Co: the
// largest key, then the largest order word (the first position); every
// warp reduces them alike, lane l reading candidate l mod 16.
template <typename K>
__device__ __forceinline__ unsigned pick_grid(const K* Ck, const unsigned* Co,
                                              int lane) {
  const K k = Ck[lane & (kGridWarps - 1)];
  const unsigned o = Co[lane & (kGridWarps - 1)];
  const K best = warp_max(k);
  return __reduce_max_sync(kAll, k == best ? o : 0u);
}

// A warp's candidate into buffer buf: its row (which: 0 the register row
// v, k + 1 the thread's staged row k, -1 the far row at frow in device
// memory), pivot reciprocal, key and order word.
template <typename T>
__device__ __forceinline__ void grid_publish(
    const GridSmem<T>& sm, const T (&v)[kPW], int buf, int warp, int tid,
    int nt, typename KeyOf<T>::type best, int bp, int which, T bv,
    const T* frow) {
  using K = typename KeyOf<T>::type;
  T* dst = sm.Cv + (buf + warp) * kPW;
  if (which == 0) {
#pragma unroll
    for (int c = 0; c < kPW; c += kVec<T>) st_vec(dst + c, v + c);
  } else if (which < 0) {
#pragma unroll 8
    for (int c = 0; c < kPW; ++c) dst[c] = __ldcg(frow + c);
  } else {
    const T* row = sm.S + (tid + (which - 1) * nt) * kGLd;
#pragma unroll 8
    for (int c = 0; c < kPW; ++c) dst[c] = row[c];
  }
  sm.Cd[buf + warp] = pivot_recip(bv);
  sm.Ck[buf + warp] = best;
  sm.Co[buf + warp] = best != K(0) ? order_word(bp, warp) : 0u;
}

// Panel columns p0 .. p0 + 31 of one matrix over its rows at positions p0
// .. s - 1 (more than 32 of them), by one block, one block barrier a
// column. Slot r is the row at position p0 + r when the panel starts
// (physical row Ps[r]): slot t < 512 lies in thread t's registers, slot
// 512 + m (m < SR, the rows S has room for) in S[m], owned by thread m %
// 512; with kFar, the slots past those (far rows) stay in wk, owned by
// thread f % 512 for far row f, their positions in fpos. A step: every
// thread picks the same winner among the warps' candidates (the largest
// key, the smallest position) and reads its row from the candidate
// buffer; the rows below the pivot take their multiplier and update their
// next column (a far row all of its columns, through L2), the warp's
// reductions for the next step start, the rest of the rows are updated,
// and the lane holding the warp's candidate copies its row, key, order
// word and pivot reciprocal into the other buffer.
template <typename T, int kSp, bool kFar>
__device__ void grid_panel(const GridSmem<T>& sm, T* wk, int* gmap,
                           int* fpos, int32_t* prec, int s, int p0, int sr) {
  using K = typename KeyOf<T>::type;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nt >> 5;
  const int R = s - p0;
  const int RX = R > nt ? R - nt : 0;          // rows past the registers'
  const int RS = kFar && RX > sr ? sr : RX;    // staged rows
  const int RF = RX - RS;                      // far rows
  const int F0 = nt + RS;                      // the first far row's slot
  for (int r = tid; r < R; r += nt) sm.Ps[r] = sm.Pm[p0 + r];
  __syncthreads();
  const bool has0 = tid < R;
  // a row's 32 entries as 16-byte vectors where the rows allow it
  constexpr int V = kVec<T>;
  const bool vec = ((size_t)s * sizeof(T)) % 16 == 0;
  T v[kPW];
  {
    const T* src = wk + (int64_t)(has0 ? sm.Ps[tid] : 0) * s + p0;
    if (vec) {
#pragma unroll
      for (int c = 0; c < kPW; c += V) ldcg_vec(src + c, v + c);
    } else {
#pragma unroll
      for (int c = 0; c < kPW; ++c) v[c] = __ldcg(src + c);
    }
    if (!has0) {
#pragma unroll
      for (int c = 0; c < kPW; ++c) v[c] = T(0);
    }
  }
#pragma unroll 4
  for (int m = warp; m < RS; m += nwarps)
    sm.S[m * kGLd + lane] =
        __ldcg(wk + (int64_t)sm.Ps[nt + m] * s + p0 + lane);
  __syncthreads();

  int pos0 = has0 ? p0 + tid : s;              // s: no row
  int pos[kSp];
#pragma unroll
  for (int k = 0; k < kSp; ++k) {
    const int m = tid + k * nt;
    pos[k] = m < RS ? p0 + nt + m : s;
  }
  // far row f's physical row
  auto far_row = [&](int f) { return wk + (int64_t)sm.Ps[F0 + f] * s + p0; };
  if constexpr (kFar)
    for (int f = tid; f < RF; f += nt) fpos[f] = p0 + F0 + f;
  // the warp's candidate: the largest key bk among its lanes', then the
  // smallest position bp; which: 0 the register row, k + 1 staged row k,
  // -1 the far row at bf
  auto reduce = [&](K bk, int bp, K& best) {
    best = warp_max(bk);
    const unsigned wp =
        __reduce_min_sync(kAll, bk == best ? (unsigned)bp : 0xffffffffu);
    return best != K(0) ? (bk == best && (unsigned)bp == wp) : lane == 0;
  };
  {
    K bk = has0 ? pivot_key(v[0]) : K(0);
    int bp = pos0, which = 0;
    T bv = v[0];
#pragma unroll
    for (int k = 0; k < kSp; ++k) {
      if (pos[k] < s) {
        const T x = sm.S[(tid + k * nt) * kGLd];
        const K key = pivot_key(x);
        if (key > bk || (key == bk && pos[k] < bp)) {
          bk = key;
          bp = pos[k];
          which = k + 1;
          bv = x;
        }
      }
    }
    const T* bf = nullptr;
    if constexpr (kFar) {
      for (int f = tid; f < RF; f += nt) {
        const T* row = far_row(f);
        const T x = __ldcg(row);
        const K key = pivot_key(x);
        if (key > bk || (key == bk && p0 + F0 + f < bp)) {
          bk = key;
          bp = p0 + F0 + f;
          which = -1;
          bv = x;
          bf = row;
        }
      }
    }
    K best;
    if (reduce(bk, bp, best))
      grid_publish(sm, v, 0, warp, tid, nt, best, bp, which, bv, bf);
  }

  int rec = 0;            // thread jj: step p0 + jj's pivot position
#pragma unroll
  for (int jj = 0; jj < kPW; ++jj) {
    const int j = p0 + jj;
    const int b = (jj & 1) * kGridWarps;
    __syncthreads();                 // the candidates of step jj
    const unsigned won = pick_grid(sm.Ck + b, sm.Co + b, lane);
    const int bw = (int)(won & 0xffu);
    const int rp = (int)(0xffffu - (won >> 8));
    const T* urow = sm.Cv + (b + bw) * kPW;
    const T d = sm.Cd[b + bw];
    if (tid == jj) rec = rp;
    if (pos0 == rp)
      pos0 = j;
    else if (pos0 == j)
      pos0 = rp;
#pragma unroll
    for (int k = 0; k < kSp; ++k) {
      if (pos[k] == rp)
        pos[k] = j;
      else if (pos[k] == j)
        pos[k] = rp;
    }
    // the multipliers and the next column first
    K bk = K(0);
    int bp = 0x7fffffff, which = 0;
    T bv = T(0);
    const bool up0 = has0 && pos0 > j;
    const T l0 = v[jj] * d;
    if (jj + 1 < kPW && up0) {
      v[jj + 1] = v[jj + 1] - l0 * urow[jj + 1];
      bk = pivot_key(v[jj + 1]);
      bp = pos0;
      bv = v[jj + 1];
    }
    T lm[kSp];
#pragma unroll
    for (int k = 0; k < kSp; ++k) {
      lm[k] = T(0);
      if (pos[k] < s && pos[k] > j) {
        T* row = sm.S + (tid + k * nt) * kGLd;
        lm[k] = row[jj] * d;
        if (jj + 1 < kPW) {
          const T x = row[jj + 1] - lm[k] * urow[jj + 1];
          row[jj + 1] = x;
          const K key = pivot_key(x);
          if (key > bk || (key == bk && pos[k] < bp)) {
            bk = key;
            bp = pos[k];
            which = k + 1;
            bv = x;
          }
        }
      }
    }
    // the far rows: the swap, then the whole step (the entries through L2,
    // each taking its one product and difference as in registers)
    const T* bf = nullptr;
    if constexpr (kFar) {
      for (int f = tid; f < RF; f += nt) {
        int p = fpos[f];
        if (p == rp || p == j) fpos[f] = p = p == rp ? j : rp;
        if (p <= j) continue;
        T* row = far_row(f);
        const T l = __ldcg(row + jj) * d;
        if (jj + 1 < kPW) {
          const T x = __ldcg(row + jj + 1) - l * urow[jj + 1];
          __stcg(row + jj + 1, x);
          const K key = pivot_key(x);
          if (key > bk || (key == bk && p < bp)) {
            bk = key;
            bp = p;
            which = -1;
            bv = x;
            bf = row;
          }
        }
        for (int c = jj + 2; c < kPW; ++c)
          __stcg(row + c, __ldcg(row + c) - l * urow[c]);
        __stcg(row + jj, l);
      }
    }
    K best = K(0);
    const bool mine = jj + 1 < kPW && reduce(bk, bp, best);
    // the rest of the rows (the pivot row read as 16-byte vectors)
#pragma unroll
    for (int c0 = 0; c0 < kPW; c0 += V) {
      if (c0 + V > jj + 2) {
        T u[V];
        ld_vec(urow + c0, u);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          if (c0 + e >= jj + 2)
            v[c0 + e] = up0 ? v[c0 + e] - l0 * u[e] : v[c0 + e];
        }
      }
    }
    if (up0) v[jj] = l0;
#pragma unroll
    for (int k = 0; k < kSp; ++k) {
      if (pos[k] < s && pos[k] > j) {
        T* row = sm.S + (tid + k * nt) * kGLd;
#pragma unroll 4
        for (int c = jj + 2; c < kPW; ++c) row[c] = row[c] - lm[k] * urow[c];
        row[jj] = lm[k];
      }
    }
    if (mine)
      grid_publish(sm, v, b ^ kGridWarps, warp, tid, nt, best, bp, which,
                   bv, bf);
  }
  __syncthreads();                   // every row is done
  // the rows back into wk, the map, the record
  if (has0) {
    T* dst = wk + (int64_t)sm.Ps[tid] * s + p0;
    if (vec) {
#pragma unroll
      for (int c = 0; c < kPW; c += V) stcg_vec(dst + c, v + c);
    } else {
#pragma unroll
      for (int c = 0; c < kPW; ++c) __stcg(dst + c, v[c]);
    }
    sm.Pm[pos0] = sm.Ps[tid];
    __stcg(gmap + pos0, sm.Ps[tid]);
  }
#pragma unroll
  for (int k = 0; k < kSp; ++k) {
    if (pos[k] < s) {
      const int ph = sm.Ps[nt + tid + k * nt];
      sm.Pm[pos[k]] = ph;
      __stcg(gmap + pos[k], ph);
    }
  }
  if constexpr (kFar) {
    for (int f = tid; f < RF; f += nt) {
      const int ph = sm.Ps[F0 + f];
      sm.Pm[fpos[f]] = ph;
      __stcg(gmap + fpos[f], ph);
    }
  }
  for (int m = warp; m < RS; m += nwarps)
    __stcg(wk + (int64_t)sm.Ps[nt + m] * s + p0 + lane,
           sm.S[m * kGLd + lane]);
  if (tid < kPW) prec[p0 + tid] = rec;
}

// The last panel (columns p0 .. s - 1, at most 32 rows and columns), on
// one warp (warp_lu), the rows in registers, no barrier.
template <typename T>
__device__ void grid_panel_warp(const GridSmem<T>& sm, T* wk, int* gmap,
                                int32_t* prec, int s, int p0) {
  const int lane = threadIdx.x & 31;
  const int w = s - p0;
  const bool has_row = lane < w;
  const int ph = has_row ? sm.Pm[p0 + lane] : 0;
  int pos = has_row ? p0 + lane : s + lane;
  T* row = wk + (int64_t)ph * s + p0;
  T v[kPW];
#pragma unroll
  for (int c = 0; c < kPW; ++c)
    v[c] = (has_row && c < w) ? __ldcg(row + c) : T(0);
  int rec = 0;
  warp_lu<T, kPW>(v, pos, rec, has_row, p0, w, lane);
  __syncwarp();           // every lane has read its map entry
  if (has_row) {
#pragma unroll
    for (int c = 0; c < kPW; ++c)
      if (c < w) __stcg(row + c, v[c]);
    sm.Pm[pos] = ph;
    __stcg(gmap + pos, ph);
    prec[p0 + lane] = rec;
  }
}

// The trailing block of the panel at p0 (positions and columns p0 + 32 ..
// s - 1) in kGT x kGT tiles dealt over the group's G blocks; Pm is the
// map after the panel. A tile solves its columns' 32 rows of U (positions
// p0 .. p0 + 31) with the panel's unit-L block, a warp per 4 columns and a
// lane per row, the steps chained by shuffles (every tile of a column
// solves them alike; the first row of tiles writes them to out, where
// those rows are final), then takes the panel's 32 updates in registers,
// thread (tr, tc) keeping rows tr + 32 u and columns tc + 16 q. A tile's
// loads from L2 are all issued before its first barrier.
template <typename T>
__device__ void grid_trailing(const GridSmem<T>& sm, T* wk, T* out, int s,
                              int p0, int b, int G) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int i0 = p0 + kPW;
  const int nct = (s - i0 + kGT - 1) / kGT;
  const int ntiles = nct * nct;
  if (b >= ntiles) return;
  for (int e = tid; e < kPW * kPW; e += nt) {
    const int r = e >> 5, t = e & 31;
    sm.Ld[t * kGLd + r] =
        t < r ? __ldcg(wk + (int64_t)sm.Pm[p0 + r] * s + p0 + t) : T(0);
  }
  const T* urow = wk + (int64_t)sm.Pm[p0 + lane] * s;
  const int tr = tid >> 4, tc = tid & 15;
  for (int t = b; t < ntiles; t += G) {
    const int ti = t / nct, tk = t - ti * nct;
    const int r0 = i0 + ti * kGT, c0 = i0 + tk * kGT;
    // the tile's entries, its columns' rows of U and its rows of L
    int64_t rb[2];
    T acc[2][4];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int pos = r0 + tr + 32 * u;
      rb[u] = pos < s ? (int64_t)sm.Pm[pos] * s : -1;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = c0 + tc + 16 * q;
        acc[u][q] = (rb[u] >= 0 && c < s) ? __ldcg(wk + rb[u] + c) : T(0);
      }
    }
    T x[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = c0 + warp + 16 * q;
      x[q] = c < s ? __ldcg(urow + c) : T(0);
    }
#pragma unroll 4
    for (int e = tid; e < kGT * kPW; e += nt) {
      const int r = e >> 5, tt = e & 31;
      sm.Lt[r * kGLd + tt] =
          r0 + r < s ? __ldcg(wk + (int64_t)sm.Pm[r0 + r] * s + p0 + tt)
                     : T(0);
    }
    __syncthreads();                 // Ld and Lt are staged
    // the U strip: lane l is row p0 + l of columns c0 + warp + 16 q
#pragma unroll 4
    for (int tt = 0; tt < kPW; ++tt) {
      const T lt = sm.Ld[tt * kGLd + lane];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const T xt = __shfl_sync(kAll, x[q], tt);
        if (lane > tt) x[q] = x[q] - lt * xt;
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = warp + 16 * q;
      sm.Us[lane * kGUs + c] = x[q];
      if (ti == 0 && c0 + c < s) out[(int64_t)(p0 + lane) * s + c0 + c] = x[q];
    }
    __syncthreads();                 // the U strip is solved
#pragma unroll 8
    for (int tt = 0; tt < kPW; ++tt) {
      T li[2], uk[4];
#pragma unroll
      for (int u = 0; u < 2; ++u) li[u] = sm.Lt[(tr + 32 * u) * kGLd + tt];
#pragma unroll
      for (int q = 0; q < 4; ++q) uk[q] = sm.Us[tt * kGUs + tc + 16 * q];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[u][q] = acc[u][q] - li[u] * uk[q];
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = c0 + tc + 16 * q;
        if (rb[u] >= 0 && c < s) __stcg(wk + rb[u] + c, acc[u][q]);
      }
    }
    __syncthreads();                 // Lt and Us are free again
  }
}

// Matrices past a block's shared memory. A group of G blocks factors one
// matrix at a time (the groups take the matrices in rounds); wk is the
// matrix by physical row in device memory (L2-resident), gmap the group's
// position -> physical row map, fpos (after it in maps) its far rows'
// positions in a panel (kFar: the panel's rows past the registers' and
// the sr that S has room for). Per 32-column panel two barriers of the
// grid: block 0 of the group factors the panel (grid_panel, or
// grid_panel_warp for the last), then every block takes its tiles of the
// trailing block (grid_trailing). At the end the blocks copy the rows out
// by position: the part of each row left of and in its own panel from wk
// (the part right of it, its row of U, grid_trailing wrote). Every block
// reaches every barrier the same number of times; with G = 1 a block
// barrier serves.
template <typename T, int kSp, bool kFar>
__global__ void __launch_bounds__(kGridThreads, 1)
lu_factor_grid_kernel(const T* __restrict__ in, T* __restrict__ out,
                      int32_t* __restrict__ perm, T* work, int* maps,
                      long long nb, int s, int G, int sr) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const GridSmem<T> sm(smem_raw, s, sr);
  cg::grid_group grid = cg::this_grid();
  const int groups = gridDim.x / G;
  const int g = blockIdx.x / G;
  const int b = blockIdx.x - g * G;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nt >> 5;
  const int64_t ss = (int64_t)s * s;
  int* gmap = maps + (int64_t)g * 2 * s;
  int* fpos = gmap + s;
  auto sync = [&]() {
    if (G > 1)
      grid.sync();
    else
      __syncthreads();
  };
  // the map's entries from position p0 on, as block 0 left them
  auto load_map = [&](int p0) {
    for (int i = p0 + tid; i < s; i += nt) sm.Pm[i] = __ldcg(gmap + i);
    __syncthreads();
  };

  const long long rounds = (nb + groups - 1) / groups;
  for (long long q = 0; q < rounds; ++q) {
    const long long mat = g + q * groups;
    const bool live = mat < nb;                // the same for the group
    T* wk = work + (live ? mat : 0) * ss;
    int32_t* prec = perm + (live ? mat : 0) * s;
    if (live) {
      const T* src = in + mat * ss;
      for (int i = tid; i < s; i += nt) sm.Pm[i] = i;
      if (b == 0)
        for (int i = tid; i < s; i += nt) __stcg(gmap + i, i);
      for (int r = b * nwarps + warp; r < s; r += G * nwarps)
        for (int c = lane; c < s; c += 32)
          __stcg(wk + (int64_t)r * s + c, src[(int64_t)r * s + c]);
    }
    sync();
    int p0 = 0;
    for (;; p0 += kPW) {
      const bool last = s - p0 <= kPW;
      if (live && b == 0) {
        if (!last)
          grid_panel<T, kSp, kFar>(sm, wk, gmap, fpos, prec, s, p0, sr);
        else if (warp == 0)
          grid_panel_warp<T>(sm, wk, gmap, prec, s, p0);
      }
      sync();                                  // the panel is factored
      if (last) break;
      if (live) {
        load_map(p0);
        grid_trailing<T>(sm, wk, out + mat * ss, s, p0, b, G);
      }
      sync();                                  // the trailing block is done
    }
    if (live) {
      load_map(p0);
      T* dst = out + mat * ss;
      for (int i = b * nwarps + warp; i < s; i += G * nwarps) {
        const int cend = min(s, (i & ~(kPW - 1)) + kPW);
        const T* row = wk + (int64_t)sm.Pm[i] * s;
        for (int c = lane; c < cend; c += 32)
          dst[(int64_t)i * s + c] = __ldcg(row + c);
      }
    }
    sync();                  // the group's map is free for the next round
  }
}

// ---------------------------------------------------------------------------
// lu_solve beyond the panel design's shared memory.

constexpr int kRowsThreads = 256;
constexpr int kRowsCols = 32;      // columns a block, at most
constexpr int kD = 32;             // panel rows

template <typename T>
__host__ __device__ constexpr size_t rows_smem_bytes(int s, int kb) {
  return ((size_t)s * kb + kD * (kD + 1) + (size_t)kD * kb + kD) *
             sizeof(T) +
         (size_t)s * sizeof(int);
}

// One block per matrix (blockIdx.y) and kb columns (blockIdx.x). Xs: the
// block's columns of X by row; the diagonal block D of each 32-row panel is
// staged in shared memory, the rows past the panel read the factor from
// device memory (a row's 32 panel entries are contiguous).
template <typename T>
__global__ void __launch_bounds__(kRowsThreads)
lu_solve_rows_kernel(const T* __restrict__ F, const int32_t* __restrict__ perm,
                     const T* __restrict__ B, T* __restrict__ X, int s, int K,
                     int kb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Xs = reinterpret_cast<T*>(smem_raw);      // s x kb
  T* D = Xs + (size_t)s * kb;                  // 32 x 33
  T* Xt = D + kD * (kD + 1);                   // 32 x kb, scaled rows
  T* dd = Xt + kD * kb;                        // 32 pivot reciprocals
  int* idx = reinterpret_cast<int*>(dd + kD);  // the gather map
  const int64_t mat = blockIdx.y;
  const int c0 = blockIdx.x * kb;
  const int kw = min(kb, K - c0);
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const T* f = F + mat * (int64_t)s * s;

  for (int i = tid; i < s; i += nt) idx[i] = i;
  __syncthreads();
  if (tid == 0) {                 // the swaps in order (LAPACK laswp)
    const int32_t* pr = perm + mat * s;
    for (int j = 0; j < s; ++j) {
      const int r = pr[j];
      const int t = idx[j];
      idx[j] = idx[r];
      idx[r] = t;
    }
  }
  __syncthreads();
  for (int e = tid; e < s * kw; e += nt) {
    const int i = e / kw, c = e - (e / kw) * kw;
    Xs[(size_t)i * kb + c] = B[(mat * s + idx[i]) * (int64_t)K + c0 + c];
  }

  // unit-L forward
  for (int p0 = 0; p0 < s; p0 += kD) {
    const int w = min(kD, s - p0);
    for (int e = tid; e < w * w; e += nt) {
      const int a = e / w, t = e - (e / w) * w;
      D[a * (kD + 1) + t] = f[(int64_t)(p0 + a) * s + p0 + t];
    }
    __syncthreads();
    if (tid < kw) {
      T x[kD];
#pragma unroll
      for (int a = 0; a < kD; ++a)
        x[a] = a < w ? Xs[(size_t)(p0 + a) * kb + tid] : T(0);
#pragma unroll
      for (int t = 0; t < kD; ++t) {
#pragma unroll
        for (int a = t + 1; a < kD; ++a)
          if (a < w) x[a] = x[a] - D[a * (kD + 1) + t] * x[t];
      }
#pragma unroll
      for (int a = 0; a < kD; ++a)
        if (a < w) Xs[(size_t)(p0 + a) * kb + tid] = x[a];
    }
    __syncthreads();
    const int r0 = p0 + w;
    for (int e = tid; e < (s - r0) * kw; e += nt) {
      const int i = r0 + e / kw, c = e - (e / kw) * kw;
      const T* fr = f + (int64_t)i * s + p0;
      T acc = Xs[(size_t)i * kb + c];
      for (int t = 0; t < w; ++t)
        acc = acc - fr[t] * Xs[(size_t)(p0 + t) * kb + c];
      Xs[(size_t)i * kb + c] = acc;
    }
    __syncthreads();
  }

  // U backward: x_j = b_j d_j takes part in the rows above it; the output
  // row is the same product
  for (int p0 = ((s - 1) / kD) * kD; p0 >= 0; p0 -= kD) {
    const int w = min(kD, s - p0);
    for (int e = tid; e < w * w; e += nt) {
      const int a = e / w, t = e - (e / w) * w;
      D[a * (kD + 1) + t] = f[(int64_t)(p0 + a) * s + p0 + t];
    }
    for (int t = tid; t < w; t += nt)
      dd[t] = pivot_recip(f[(int64_t)(p0 + t) * s + p0 + t]);
    __syncthreads();
    if (tid < kw) {
      T x[kD];
#pragma unroll
      for (int a = 0; a < kD; ++a)
        x[a] = a < w ? Xs[(size_t)(p0 + a) * kb + tid] : T(0);
#pragma unroll
      for (int t = kD - 1; t >= 0; --t) {
        if (t < w) {
          const T xt = x[t] * dd[t];
          Xt[t * kb + tid] = xt;
#pragma unroll
          for (int a = 0; a < t; ++a)
            x[a] = x[a] - D[a * (kD + 1) + t] * xt;
        }
      }
#pragma unroll
      for (int a = 0; a < kD; ++a)
        if (a < w) Xs[(size_t)(p0 + a) * kb + tid] = x[a];
    }
    __syncthreads();
    for (int e = tid; e < p0 * kw; e += nt) {
      const int i = e / kw, c = e - (e / kw) * kw;
      const T* fr = f + (int64_t)i * s + p0;
      T acc = Xs[(size_t)i * kb + c];
      for (int t = w - 1; t >= 0; --t) acc = acc - fr[t] * Xt[t * kb + c];
      Xs[(size_t)i * kb + c] = acc;
    }
    __syncthreads();
  }
  for (int e = tid; e < s * kw; e += nt) {
    const int i = e / kw, c = e - (e / kw) * kw;
    X[(mat * s + i) * (int64_t)K + c0 + c] =
        Xs[(size_t)i * kb + c] * pivot_recip(f[(int64_t)i * s + i]);
  }
}

template <typename T>
int launch_factor(const T* in, T* out, int32_t* perm, long long nb, int s,
                  void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (s <= kPW) {
    const unsigned blocks = (unsigned)((nb + kSmallWarps - 1) / kSmallWarps);
    if (s <= 16) {
      lu_factor_warp_kernel<T, 16><<<blocks, kSmallWarps * 32,
                                     kSmallWarps * 16 * 17 * sizeof(T), st>>>(
          in, out, perm, nb, s);
    } else {
      lu_factor_warp_kernel<T, 32><<<blocks, kSmallWarps * 32,
                                     kSmallWarps * 32 * 33 * sizeof(T), st>>>(
          in, out, perm, nb, s);
    }
    return (int)cudaGetLastError();
  }
  const panel::DeviceInfo* d = nullptr;
  cudaError_t e = panel::device_info(&d);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = panel_smem_bytes<T>(s);
  if (smem > (size_t)d->cap) return (int)cudaErrorInvalidValue;
  // the kernel may use all of a block's shared memory: set once per device
  static bool ready[panel::kMaxDevices];
  if (!ready[d->dev]) {
    e = cudaFuncSetAttribute(lu_factor_panel_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             d->cap);
    if (e != cudaSuccess) return (int)e;
    ready[d->dev] = true;
  }
  lu_factor_panel_kernel<T><<<(unsigned)nb, kPanelThreads, smem, st>>>(
      in, out, perm, s);
  return (int)cudaGetLastError();
}

// The largest s whose panel rows past the registers' all fit in S, on a
// card whose blocks have cap bytes of shared memory.
template <typename T>
int grid_staged_max_s(int cap) {
  int s = kGridMaxS;
  while (s > 0 && grid_smem_bytes<T>(s, grid_spill_rows(s)) > (size_t)cap)
    --s;
  return s;
}

// The largest s the grid design takes (past grid_staged_max_s, with far
// rows; shared memory then holds the two maps of s ints).
template <typename T>
int grid_max_s(int cap) {
  const size_t base = grid_smem_bytes<T>(0, 0);
  const long long s =
      cap > (long long)base ? (cap - (long long)base) / (2 * sizeof(int)) : 0;
  return (int)(s < kGridMaxPos ? s : kGridMaxPos);
}

// The rows S has room for at s past grid_staged_max_s (at most kSpill a
// thread).
template <typename T>
int grid_far_staged(int s, int cap) {
  int rs = kSpill * kGridThreads;
  while (rs > 0 && grid_smem_bytes<T>(s, rs) > (size_t)cap) --rs;
  return rs;
}

// One instance of the grid design's kernel, launched.
template <typename T, int kSp, bool kFar>
int launch_grid(const T* in, T* out, int32_t* perm, T* work, int* maps,
                long long nb, int s, int G, int groups, int sr,
                const panel::DeviceInfo* d, void* stream) {
  static bool ready[panel::kMaxDevices];
  cudaError_t e;
  if (!ready[d->dev]) {
    e = cudaFuncSetAttribute(lu_factor_grid_kernel<T, kSp, kFar>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             d->cap);
    if (e != cudaSuccess) return (int)e;
    ready[d->dev] = true;
  }
  int ss = s, gg = G, rr = sr;
  long long n = nb;
  void* args[] = {(void*)&in,   (void*)&out, (void*)&perm,
                  (void*)&work, (void*)&maps, (void*)&n,
                  (void*)&ss,   (void*)&gg,  (void*)&rr};
  const size_t smem = grid_smem_bytes<T>(s, sr);
  e = cudaLaunchCooperativeKernel(
      (const void*)lu_factor_grid_kernel<T, kSp, kFar>,
                                  dim3((unsigned)(groups * G)),
                                  dim3(kGridThreads), args, smem,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) {
    cudaGetLastError();          // not left for the next launch to report
    return (int)e;
  }
  return (int)cudaGetLastError();
}

// The grid design: groups of G blocks, a group per matrix at a time, one
// block an SM (a cooperative grid must be resident at once).
template <typename T>
int launch_factor_grid(const T* in, T* out, int32_t* perm, T* work,
                       int* maps, long long nb, int s, void* stream) {
  const panel::DeviceInfo* d = nullptr;
  cudaError_t e = panel::device_info(&d);
  if (e != cudaSuccess) return (int)e;
  if (!d->coop) return (int)cudaErrorNotSupported;
  if (s > grid_max_s<T>(d->cap)) return (int)cudaErrorInvalidValue;
  const int groups = (int)(nb < d->sms ? nb : d->sms);
  int G = d->sms / groups;
  G = G < s ? G : s;
  if (s > grid_staged_max_s<T>(d->cap))
    return launch_grid<T, kSpill, true>(in, out, perm, work, maps, nb, s, G,
                                        groups, grid_far_staged<T>(s, d->cap),
                                        d, stream);
  const int sr = grid_spill_rows(s);
  return grid_spill_instance(s) == 1
             ? launch_grid<T, 1, false>(in, out, perm, work, maps, nb, s, G,
                                        groups, sr, d, stream)
             : launch_grid<T, kSpill, false>(in, out, perm, work, maps, nb, s,
                                             G, groups, sr, d, stream);
}

// The panel design where one column's plan fits in shared memory, else
// clusters where the card holds one a matrix and a block's rows fit, else
// the rows design, columns a block halved until it fits.
template <typename T>
int launch_solve(const T* F, const int32_t* perm, const T* B, T* X,
                 long long nb, int s, int K, void* stream) {
  const panel::DeviceInfo* d = nullptr;
  cudaError_t e = panel::device_info(&d);
  if (e != cudaSuccess) return (int)e;
  if (panel::fits<T>(panel::kLU, s, d->cap))
    return (int)panel::launch<T, panel::kLU>(F, perm, B, X, nb, s, K, *d,
                                             (cudaStream_t)stream);
  cluster::Plan cp;
  bool ok = false;
  e = cluster::plan<T, panel::kLU>(nb, s, K, &cp, &ok);
  if (e != cudaSuccess) return (int)e;
  if (ok)
    return (int)cluster::launch<T, panel::kLU>(cp, F, perm, B, X, nb, s, K,
                                               (cudaStream_t)stream);
  int kb = K < kRowsCols ? K : kRowsCols;
  while (kb > 1 && rows_smem_bytes<T>(s, kb) > (size_t)d->cap)
    kb = (kb + 1) / 2;
  const size_t smem = rows_smem_bytes<T>(s, kb);
  if (smem > (size_t)d->cap) return (int)cudaErrorInvalidValue;
  static bool ready[panel::kMaxDevices];
  if (!ready[d->dev]) {
    e = cudaFuncSetAttribute(lu_solve_rows_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             d->cap);
    if (e != cudaSuccess) return (int)e;
    ready[d->dev] = true;
  }
  const dim3 grid((unsigned)((K + kb - 1) / kb), (unsigned)nb);
  lu_solve_rows_kernel<T><<<grid, kRowsThreads, smem, (cudaStream_t)stream>>>(
      F, perm, B, X, s, K, kb);
  return (int)cudaGetLastError();
}

// lu_solve's design (see lu_design).
template <typename T>
int solve_design(long long nb, int s, int K, const panel::DeviceInfo* d) {
  if (panel::fits<T>(panel::kLU, s, d->cap)) return 0;
  cluster::Plan cp;
  bool ok = false;
  if (cluster::plan<T, panel::kLU>(nb, s, K, &cp, &ok) != cudaSuccess)
    return -1;
  return !ok ? 1 : cp.C > cluster::kPortable ? 3 : 2;
}

}  // namespace

extern "C" {

int lu_factor_f32(const float* in, float* out, int32_t* perm, long long nb,
                  int s, void* stream) {
  return launch_factor<float>(in, out, perm, nb, s, stream);
}

int lu_factor_f64(const double* in, double* out, int32_t* perm,
                  long long nb, int s, void* stream) {
  return launch_factor<double>(in, out, perm, nb, s, stream);
}

int lu_factor_grid_f32(const float* in, float* out, int32_t* perm,
                       float* work, int* maps, long long nb, int s,
                       void* stream) {
  return launch_factor_grid<float>(in, out, perm, work, maps, nb, s, stream);
}

int lu_factor_grid_f64(const double* in, double* out, int32_t* perm,
                       double* work, int* maps, long long nb, int s,
                       void* stream) {
  return launch_factor_grid<double>(in, out, perm, work, maps, nb, s, stream);
}

// 64-bit words of the grid design's position maps at s (two maps of s
// ints a group, at most one group an SM).
int lu_factor_grid_words(int s) {
  const panel::DeviceInfo* d = nullptr;
  if (panel::device_info(&d) != cudaSuccess) return -1;
  return (int)((long long)d->sms * s);
}

// The largest s the grid design takes on the current device (esize: 4 or
// 8); -1 on an error.
int lu_factor_grid_max_s(int esize) {
  const panel::DeviceInfo* d = nullptr;
  if (panel::device_info(&d) != cudaSuccess) return -1;
  return esize == 8 ? grid_max_s<double>(d->cap) : grid_max_s<float>(d->cap);
}

int lu_solve_f32(const float* F, const int32_t* perm, const float* B,
                 float* X, long long nb, int s, int K, void* stream) {
  return launch_solve<float>(F, perm, B, X, nb, s, K, stream);
}

int lu_solve_f64(const double* F, const int32_t* perm, const double* B,
                 double* X, long long nb, int s, int K, void* stream) {
  return launch_solve<double>(F, perm, B, X, nb, s, K, stream);
}

// Shared memory a launch of lu_factor at s x s needs (esize: 4 or 8).
int lu_factor_shared_bytes(int s, int esize) {
  if (s <= kPW) return kSmallWarps * (s <= 16 ? 16 * 17 : 32 * 33) * esize;
  return (int)(esize == 8 ? panel_smem_bytes<double>(s)
                          : panel_smem_bytes<float>(s));
}

// The design a launch takes on the current device (esize: 4 or 8):
// lu_factor (which 0) at s x s 0 a warp a matrix, 1 panels, 2 the grid
// (32-column panels over the SMs); lu_solve (which 1) of nb matrices at s
// x s and K columns 0 panels, 1 rows, 2 clusters of 8 blocks, 3 clusters
// of 16; -1 on an error. Nothing is launched.
int lu_design(int which, long long nb, int s, int K, int esize) {
  const panel::DeviceInfo* d = nullptr;
  if (panel::device_info(&d) != cudaSuccess) return -1;
  if (which == 0) {
    if (s <= kPW) return 0;
    const size_t need = esize == 8 ? panel_smem_bytes<double>(s)
                                   : panel_smem_bytes<float>(s);
    return need <= (size_t)d->cap ? 1 : 2;
  }
  return esize == 8 ? solve_design<double>(nb, s, K, d)
                    : solve_design<float>(nb, s, K, d);
}

int lu_max_shared_bytes() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  return v;
}

}  // extern "C"
