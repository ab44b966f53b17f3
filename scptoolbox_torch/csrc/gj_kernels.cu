// Batched in-place Gauss-Jordan (Jordan exchange) inverse of small square
// blocks, for NVIDIA Hopper (sm_90a). Plain C interface, loaded with ctypes
// from scptoolbox_torch/ops/gj_kernels.py.
//
// Replaces the TPU kernel _gj_kernel (scptoolbox_tpu/ops/pallas_kernels.py
// :252) behind gj_inverse (:308). It computes what that computes: s steps,
// pivots taken in order on the diagonal with no search; step j takes
// p = M[j][j], d = (p < 0 ? -1 : 1) / max(|p|, 1e-30) (NaN kept), and sets
//   M[j][k] = M[j][k] * d            (k != j),   M[j][j] = d,
//   M[i][j] = -M[i][j] * d           (i != j),
//   M[i][k] = M[i][k] - M[i][j] * (M[j][k] * d)   (i, k != j).
// After s steps the block holds its inverse. The TPU wrapper's identity
// padding to sublane and lane multiples and its batch-in-lanes transpose
// change no entry of the result and do not carry over.
//
// What bounds it on this card. A step is a rank-1 update of the whole block
// that needs the previous step complete: s dependent steps of s^2 entries,
// 2 s^3 flops and 2 s^2 elements of device traffic per block, far under the
// card's rates at the staged KKT's shapes (s = 145..158, 4..512 blocks).
// Each entry's value is one product and one difference a step, and the two
// must round apart (the plain version's separate operations), so a step is
// no matrix product for wgmma, and TMA has nothing to stream: the chain of
// s steps bounds it, each step the issue of its products and differences
// and of the step's bookkeeping over the SM that holds the matrix, plus one
// barrier.
//
// The design. The matrix lives in registers. Its rows come in chunks of 16:
// a block of 16 warps holds R chunks, row 16 c + w in warp w, and lane l
// holds columns l + 32 b (b < CC), an R x CC tile with its loop bounds fixed
// at compile time: a step is R + CC shared-memory reads (two of them vector
// reads) and R CC products and differences, with no division and no branch
// per entry. The steps run chunk by chunk with the chunk unrolled, so the
// owners of row j and column j are compile-time tile indices. Row j, scaled
// by d, and d itself are double-buffered in shared memory, one barrier a
// step; the warp that owns row j + 1 computes that row's step j first and
// publishes it, so that the pivot's division and the broadcast overlap the
// other warps' updates.
//
// One block holds a matrix whose tile fits in 64 registers a thread
// (float32 up to s = 160, float64 up to 128). A larger one is dealt over a
// cluster of 2-4 blocks (float32 above 160, float64 above 128, so float64
// at the Starship shapes): row j + 1 goes to every block through
// distributed shared memory, column j + 1 stays in its rows' block, and the
// barrier is the cluster's, split into arrive and wait around the rest of
// the tile's update. The launcher takes the fewest blocks that fit, from s
// and the dtype alone: on this card a cluster barrier costs more a step
// than the SMs it adds save (its release compiles to a GPU-wide memory
// barrier), so more blocks a matrix made every group slower. s above 256
// is refused.
//
// Built with -fmad=false: each entry's steps apply the plain version's
// operations in its order, one product and one difference, rounded apart;
// the tiling changes no entry's sequence, so kernel and plain version agree
// bit for bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 16;         // warps of a block: 512 threads
constexpr int kMaxWords = 64;      // 32-bit registers of a thread's tile

template <typename T>
__device__ __forceinline__ T pivot_recip(T p) {
  // sign(p) / max(|p|, 1e-30); a NaN pivot gives NaN (fails the compare)
  const T a = fabs(p);
  const T tiny = T(1e-30);
  const T mag = a < tiny ? tiny : a;
  return (p < T(0) ? T(-1) : T(1)) / mag;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

// The warp that owns row jn publishes it: x holds the lane's entries of the
// row (columns lane + 32 b) after step jn - 1, pv the row's pivot (lane
// jn % 32's); the row times the pivot's reciprocal goes to rowbuf[buf] and
// the reciprocal to dbuf[buf] of every block of the cluster.
template <typename T, int CC>
__device__ __forceinline__ void publish_row(const T (&x)[CC], T pv, int jn,
                                            T (*rowbuf)[32 * CC], T* dbuf,
                                            int buf, int C, int lane) {
  pv = __shfl_sync(0xffffffffu, pv, jn & 31);
  const T dn = pivot_recip(pv);
  T y[CC];
#pragma unroll
  for (int b = 0; b < CC; ++b) y[b] = x[b] * dn;
  if (C == 1) {
#pragma unroll
    for (int b = 0; b < CC; ++b) rowbuf[buf][lane + 32 * b] = y[b];
    if (lane == 0) dbuf[buf] = dn;
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();
  for (int r = 0; r < C; ++r) {
    T* dst = cluster.map_shared_rank(&rowbuf[buf][0], r);
#pragma unroll
    for (int b = 0; b < CC; ++b) dst[lane + 32 * b] = y[b];
    if (lane == 0) *cluster.map_shared_rank(&dbuf[buf], r) = dn;
  }
}

// One matrix on a cluster of C blocks of 16 warps (C = 1: a plain launch),
// grid nb C. Rows come in chunks of 16: block q (blockIdx.x % C) holds
// chunks q R .. q R + R - 1, and chunk c's row 16 c + w lies in warp w at
// tile row c - q R; lane l holds columns l + 32 b (b < CC). The steps run
// chunk by chunk, j = 16 c + ww, with c unrolled: the block, tile row and
// tile column (c / 2) that own row j and column j are then compile-time
// constants, and every register array is indexed by constants only (a
// run-time index would put the tile in local memory).
template <typename T, int R, int CC>
__global__ void __launch_bounds__(32 * kWarps)
gj_tile_kernel(const T* __restrict__ Min, T* __restrict__ Mout, int s,
               int C) {
  // a warp's R entries of column j side by side, padded to 16 bytes: one
  // vector load
  constexpr int RP = (R * (int)sizeof(T) + 15) / 16 * 16 / (int)sizeof(T);
  __shared__ T rowbuf[2][32 * CC];     // row j times d, at column k
  __shared__ __align__(16) T colbuf[2][kWarps][RP];   // column j, [w][a]
  __shared__ T dbuf[2];                // d of step j

  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int q = (int)(blockIdx.x % (unsigned)C);
  const int64_t ss = (int64_t)s * s;
  const T* in = Min + (int64_t)(blockIdx.x / (unsigned)C) * ss;
  T* out = Mout + (int64_t)(blockIdx.x / (unsigned)C) * ss;
  const int row0 = 16 * R * q + w;     // the row of tile row 0

  T v[R][CC];
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int b = 0; b < CC; ++b) {
      const int i = row0 + 16 * a;
      const int k = lane + 32 * b;
      v[a][b] = (i < s && k < s) ? in[(int64_t)i * s + k] : T(0);
    }

  if (C > 1) {                         // every block runs: DSMEM is live
    cluster_arrive();
    cluster_wait();
  }
  // step 0's row and column, as loaded
  if (q == 0 && w == 0) {
    T x[CC];
#pragma unroll
    for (int b = 0; b < CC; ++b) x[b] = v[0][b];
    publish_row<T, CC>(x, v[0][0], 0, rowbuf, dbuf, 0, C, lane);
  }
  if (lane == 0) {
#pragma unroll
    for (int a = 0; a < R; ++a) colbuf[0][w][a] = v[a][0];
  }
  if (C > 1) cluster_arrive();

#pragma unroll
  for (int c = 0; c < 2 * CC; ++c) {
    // row j's owner: block QJ, tile row AJ, warp ww; the next chunk's row
    // (row j + 1 where ww = 15): block QN, tile row AN; column j's tile
    // column bb, column j + 1's where l = 31: bn
    const int QJ = c / R, AJ = c % R;
    const int QN = (c + 1) / R, AN = (c + 1) % R;
    const int bb = c >> 1;
    const int bn = bb + 1 < CC ? bb + 1 : bb;
    for (int ww = 0; ww < 16; ++ww) {
      const int j = 16 * c + ww;
      if (j >= s) break;
      const int l = j & 31;
      if (C > 1)
        cluster_wait();
      else
        __syncthreads();
      const int cur = j & 1;
      const T d = dbuf[cur];
      T rv[CC], cv[R];
#pragma unroll
      for (int b = 0; b < CC; ++b) rv[b] = rowbuf[cur][lane + 32 * b];
#pragma unroll
      for (int a = 0; a < R; ++a) cv[a] = colbuf[cur][w][a];

      const bool next = j + 1 < s;
      const bool wrap = l == 31;       // column j + 1 in tile column bn
      const bool last = ww == 15;      // row j + 1 in the next chunk
      if (next) {
        // row j + 1 after step j, first, to every block: the next step
        // waits on it
        if (q == (last ? QN : QJ) && w == ((ww + 1) & 15)) {
          T x[CC];
          const T cr = last ? cv[AN] : cv[AJ];
#pragma unroll
          for (int b = 0; b < CC; ++b)
            x[b] = (last ? v[AN][b] : v[AJ][b]) - cr * rv[b];
          if (lane == l) x[bb] = (-cr) * d;
          publish_row<T, CC>(x, wrap ? x[bn] : x[bb], j + 1, rowbuf, dbuf,
                             cur ^ 1, C, lane);
        }
        if (C > 1) {
          // column j + 1 at this block's rows, then the barrier's arrive
          if (lane == ((l + 1) & 31)) {
            const T r = wrap ? rv[bn] : rv[bb];
#pragma unroll
            for (int a = 0; a < R; ++a) {
              const T u = (wrap ? v[a][bn] : v[a][bb]) - cv[a] * r;
              colbuf[cur ^ 1][w][a] =
                  (a == AJ && q == QJ && w == ww) ? r : u;
            }
          }
          cluster_arrive();
        }
      }

      // step j on the whole tile
#pragma unroll
      for (int a = 0; a < R; ++a)
#pragma unroll
        for (int b = 0; b < CC; ++b) v[a][b] = v[a][b] - cv[a] * rv[b];
      if (lane == l) {                 // column j: -M[i][j] d
        const T nd = -d;
#pragma unroll
        for (int a = 0; a < R; ++a) v[a][bb] = cv[a] * nd;
      }
      if (q == QJ && w == ww) {        // row j
#pragma unroll
        for (int b = 0; b < CC; ++b) v[AJ][b] = rv[b];
        if (lane == l) v[AJ][bb] = d;
      }

      if (C == 1 && next && lane == ((l + 1) & 31)) {
        // one block: column j + 1 from the updated tile (the next step's
        // block barrier waits for every warp anyway)
#pragma unroll
        for (int a = 0; a < R; ++a)
          colbuf[cur ^ 1][w][a] = wrap ? v[a][bn] : v[a][bb];
      }
    }
  }

#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int b = 0; b < CC; ++b) {
      const int i = row0 + 16 * a;
      const int k = lane + 32 * b;
      if (i < s && k < s) out[(int64_t)i * s + k] = v[a][b];
    }
}

// A launch's shape: C blocks a matrix, each of 16 warps holding R x CC
// tiles (16 R rows).
struct Plan {
  int C, R, CC;
};

// The tile's columns a lane: ceil(s / 32), rounded up to an instantiated
// count; 0 above 256.
int lane_columns(int s) {
  const int n = (s + 31) / 32;
  if (n <= 2) return n < 1 ? 1 : n;
  if (n <= 4) return 4;
  if (n == 5) return 5;
  return n <= 8 ? 8 : 0;
}

// The plan at C blocks a matrix (R = ceil(chunks / C), rounded up to an
// instantiated count); false where the tile does not fit in kMaxWords
// registers or C is not the count R gives.
bool plan_at(int words, int s, int C, Plan* p) {
  const int chunks = (s + 15) / 16;
  const int need = (chunks + C - 1) / C;
  p->C = C;
  p->CC = lane_columns(s);
  p->R = need <= 6 ? need : need <= 8 ? 8 : need <= 10 ? 10 : 0;
  return p->CC > 0 && p->R > 0 && p->R * p->CC * words <= kMaxWords &&
         (chunks + p->R - 1) / p->R == C;
}

// The launcher's plan: the fewest blocks a matrix whose tiles fit (a
// cluster barrier a step costs more than the SMs it adds save);
// cudaErrorInvalidValue where none fits (s > 256).
cudaError_t make_plan(int words, int s, Plan* p) {
  for (int C = 1; s >= 1 && C <= 8; ++C)
    if (plan_at(words, s, C, p)) return cudaSuccess;
  return cudaErrorInvalidValue;
}

template <typename T, int R, int CC>
cudaError_t launch_tile(const T* M, T* out, long long nb, const Plan& p,
                        int s, cudaStream_t stream) {
  // the pairs a plan can reach: chunks <= 2 CC, the tile in kMaxWords
  if constexpr (R > 2 * CC || R * CC * (int)(sizeof(T) / 4) > kMaxWords) {
    return cudaErrorInvalidValue;
  } else {
    const dim3 grid((unsigned)(nb * p.C)), block(32 * kWarps);
    if (p.C == 1) {
      gj_tile_kernel<T, R, CC><<<grid, block, 0, stream>>>(M, out, s, 1);
      return cudaGetLastError();
    }
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)p.C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cfg.stream = stream;
    cfg.gridDim = grid;
    cfg.blockDim = block;
    cfg.dynamicSmemBytes = 0;
    cudaError_t e = cudaLaunchKernelEx(&cfg, gj_tile_kernel<T, R, CC>, M, out,
                                       s, p.C);
    return e != cudaSuccess ? e : cudaGetLastError();
  }
}

template <typename T, int R>
cudaError_t launch_r(const T* M, T* out, long long nb, const Plan& p, int s,
                     cudaStream_t stream) {
  switch (p.CC) {
    case 1: return launch_tile<T, R, 1>(M, out, nb, p, s, stream);
    case 2: return launch_tile<T, R, 2>(M, out, nb, p, s, stream);
    case 4: return launch_tile<T, R, 4>(M, out, nb, p, s, stream);
    case 5: return launch_tile<T, R, 5>(M, out, nb, p, s, stream);
    case 8: return launch_tile<T, R, 8>(M, out, nb, p, s, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
int launch_gj(const T* M, T* out, long long nb, int s, void* stream) {
  Plan p;
  cudaError_t e = make_plan((int)(sizeof(T) / 4), s, &p);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (p.R) {
    case 1: return (int)launch_r<T, 1>(M, out, nb, p, s, st);
    case 2: return (int)launch_r<T, 2>(M, out, nb, p, s, st);
    case 3: return (int)launch_r<T, 3>(M, out, nb, p, s, st);
    case 4: return (int)launch_r<T, 4>(M, out, nb, p, s, st);
    case 5: return (int)launch_r<T, 5>(M, out, nb, p, s, st);
    case 6: return (int)launch_r<T, 6>(M, out, nb, p, s, st);
    case 8: return (int)launch_r<T, 8>(M, out, nb, p, s, st);
    case 10: return (int)launch_r<T, 10>(M, out, nb, p, s, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int plan_of(int s, int* out) {
  Plan p;
  cudaError_t e = make_plan((int)(sizeof(T) / 4), s, &p);
  if (e != cudaSuccess) return (int)e;
  out[0] = p.C;
  out[1] = p.R;
  out[2] = p.CC;
  return 0;
}

}  // namespace

extern "C" {

int gj_inverse_f32(const float* M, float* out, long long nb, int s,
                   void* stream) {
  return launch_gj<float>(M, out, nb, s, stream);
}

int gj_inverse_f64(const double* M, double* out, long long nb, int s,
                   void* stream) {
  return launch_gj<double>(M, out, nb, s, stream);
}

// The launcher's plan for blocks of size s: out = {C, R, CC}; returns a
// CUDA error where there is none.
int gj_plan_f32(int s, int* out) { return plan_of<float>(s, out); }

int gj_plan_f64(int s, int* out) { return plan_of<double>(s, out); }

}  // extern "C"
