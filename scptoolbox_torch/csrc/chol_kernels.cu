// Batched dense Cholesky factor and the two triangular solves against it,
// for NVIDIA Hopper (sm_90a). Plain C interface, loaded with ctypes from
// scptoolbox_torch/ops/chol_kernels.py.
//
// Replaces the TPU kernels of scptoolbox_tpu/ops/pallas_kernels.py:
//   cholesky_*       <- _cholesky_kernel (:65) behind cholesky (:96)
//   solve_lower_*    <- _fwd_solve_kernel (:129) behind solve_lower (:214)
//   solve_lower_t_*  <- _bwd_solve_kernel (:154) behind solve_lower_t (:219)
// They compute what those compute. cholesky: the right-looking lower
// factor, step j scales column j by 1/sqrt(d_j) (d_j the current diagonal)
// and subtracts the rank-1 product of the scaled column from the trailing
// block; zeros above the diagonal. A non-positive pivot is not checked: it
// yields NaN or inf, as the Pallas kernel's rsqrt does. solve_lower: Y with
// L Y = B, column by column, y_j = b_j / L_jj then b_i -= L_ij y_j (i > j).
// solve_lower_t: X with L' X = B, x_j = b_j / L_jj then b_i -= L_ji x_j
// (i < j), reading L in place where the TPU wrapper transposes it first.
// The TPU's 128-lane padding with a unit diagonal does not carry over.
//
// What bounds them on this card. At the shapes of the dense Schur KKT
// (n = 60..876, 1..128 matrices, K = 1, 2 or nz columns) the chain of
// dependent steps bounds them, not bytes or flops: a factor is n steps, a
// solve n steps, and a step that needs the whole block to agree costs a
// barrier. The large matrices do not fit in one block's shared memory
// (876^2 doubles are 6.1 MB against 227 KB a block), so they are worked on
// in device memory, where the 50 MB L2 cache holds them, in panels of up
// to 32 columns (rows) kept in shared memory or registers; the lower
// triangle of a batched 314^2 float32 block (in 32-column panels, 220 KB)
// and of the smaller ones does fit, and stays there.
//
// The launchers choose the design from the batch:
// * When the batch alone fills the card, one thread block owns a matrix
//   (more than half as many matrices as SMs), or a matrix and a block of
//   right-hand-side columns. The factor then takes one of three designs,
//   by n:
//   - n <= 32 (cholesky_warp_kernel): a warp per matrix, four a block,
//     lane r holding row r in registers, the n steps chained by shuffles
//     (factor_diag). No block barrier. At n = 1, a thread per matrix
//     (cholesky_one_kernel).
//   - while the lower triangle fits in one block's shared memory
//     (cholesky_smem_kernel; float32 up to n ~ 320, float64 up to ~ 225):
//     the triangle is copied in once with cp.async, stored as 32-column
//     panels, each column-major over its rows below the panel's top, and
//     L is written out once. Per panel, three block barriers: one warp
//     factors the diagonal block in registers (factor_diag), the rows
//     below it are scaled and updated a row a thread, and every warp
//     updates the trailing triangle from shared memory in register tiles
//     of 2 x 32 rows by 4 columns. The block size follows n (64 threads
//     up to n = 64, 128, 256, then 512 in float32; 256 at least for a
//     batch that leaves SMs idle), so that the 1536-matrix groups of
//     StagedCRQD run many blocks an SM. Its bound at the batched shapes
//     is the bytes of the triangle in and the factor out (30 us at 1536 x
//     105^2 float32); it takes about 8x that, the diagonal blocks' chains
//     of 1/sqrt steps overlapped only by the blocks an SM holds at once.
//     At one small matrix that chain is all of it.
//   - larger matrices (none on a path today): cholesky_kernel, the factor
//     in device memory, panels of up to 32 columns in shared memory.
//   For the solves that is the
//   case with more matrices than the card holds clusters of 8 blocks at
//   once (16 on an H100). solve_lower then takes the panel design of
//   panel_solve.cuh (its panels of L staged in shared memory, coalesced,
//   one panel ahead; register tiles), or tri_solve_kernel (L read in
//   device memory) where two panels of n rows do not fit in shared memory;
//   so does solve_lower_t, its panels' rows of L copied transposed.
// * Otherwise (the serial programs factor one matrix at a time) one matrix
//   is spread over many SMs, unless its triangle fits in shared memory and
//   the spread would give it few blocks (smem_over_spread: measured):
//   - cholesky_spread_kernel runs as a cooperative persistent grid of up to
//     one block per SM, with grid.sync() between its phases. A cluster (8,
//     at most 16 blocks) would give cheaper barriers, but the factor of an
//     876^2 float64 matrix lives in L2 and not in a cluster's shared memory
//     either way, and its trailing updates want every SM. Per panel of 32
//     columns, two phases: (A) every block factors the diagonal block
//     redundantly in one warp's registers (the steps chained by shuffles),
//     then the blocks factor the panel's rows below it, one row per thread,
//     rows dealt round-robin over the blocks; (B) the blocks share the
//     update of the trailing lower triangle in 64 x 64 tiles, each staging
//     its two slices of the panel in shared memory and keeping a 4 x 4
//     register tile per thread. 2 grid barriers per panel, 1 + 2 ceil(n/32)
//     in all: 57 at n = 876. What remains is the diagonal block's chain of
//     32 dependent sqrt, division and shuffle steps per panel, which no
//     number of SMs shortens.
//   - solve_cluster_kernel runs both solves on thread-block clusters of up
//     to 8 blocks, one or more per matrix, each on a block of right-hand-
//     side columns. The 32-row panels are dealt round-robin over a
//     cluster's blocks, and each block keeps its panels' rows of X in
//     shared memory. Per panel, in the substitution's order (from the top
//     for solve_lower, from the bottom for solve_lower_t): its owner
//     solves the diagonal block (a warp per column for a few columns; for
//     many a thread per column, the panel's 32 rows in its registers, so
//     that each step's division serves one column) and
//     writes the solved rows into every block's shared memory (distributed
//     shared memory); one cluster barrier; every block applies them to its
//     own rows past the panel. The owner of the next panel brings that
//     panel's rows up to date first, in the same registers, and solves it
//     before it updates its other rows, so that the chain from panel to
//     panel passes 32 rows of one block. The diagonal block and each
//     block's coefficients of the panel (solve_lower: segments of its own
//     rows of L, columns lo..lo+w-1; solve_lower_t: rows lo..lo+w-1 of L
//     at its own columns; contiguous either way) are copied into shared
//     memory with cp.async two panels ahead, issued between the barrier's
//     arrive and its wait; L does not change, so the copies need no
//     barrier of their own.
//   - solve_lower_t takes the cluster design of cluster_solve.cuh (shared
//     with lu_solve) where this one's plan does not fit in shared memory
//     (the free-flyer's 1593-wide float64 factor at K = 403, whose blocks
//     own 224 rows: three staged panels and X's 26 columns need 264 KB)
//     or gives a cluster more than 16 columns (876 x 566): two staged
//     steps where three do not fit, clusters of 16 blocks where 8 do not,
//     the diagonal blocks of many columns a thread a column and the rows
//     past them in 4 x 4 register tiles.
//
// Bit for bit. Each entry takes its updates in the plain version's order:
// in the factor, every trailing entry takes the panels' products in column
// order, one product and one difference at a time, and is scaled by
// 1/sqrt(d) exactly when the right-looking plain version scales it; in the
// solves, every x_i takes its subtractions in the plain substitution's
// order. Built with -fmad=false so that every product and difference rounds
// as the plain PyTorch version's separate operations do; kernel and plain
// version then agree bit for bit, whichever design runs.

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cluster_solve.cuh"
#include "panel_solve.cuh"

namespace cg = cooperative_groups;

namespace {

using panel::device_info;
using panel::DeviceInfo;
using panel::kMaxDevices;

constexpr int kFactorThreads = 512;
constexpr int kMaxPanel = 32;
constexpr int kSolveThreads = 512;
constexpr int kSolveCols = 32;
constexpr int kPanel = 32;
constexpr int kTargetBlocks = 132;  // SMs of an H100 SXM
constexpr int kSpreadThreads = 256;
constexpr int kW = 32;          // panel width of the spread designs
constexpr int kTile = 64;       // trailing tile of the spread factor
constexpr int kCluster = 8;     // blocks of a solve cluster (portable)
constexpr int kClusterThreads = 512;
constexpr int kWarpMats = 4;    // n <= 32: matrices a block
constexpr int kSmemPanels = 16;  // panels of the shared-memory design, most
constexpr int kRB = 2;          // its trailing tiles: 32-row groups a lane

// The factor is blocked into panels of W columns (W from the shared memory
// the card allows, at most kMaxPanel). A panel is loaded into shared memory
// column-major, factored there column by column (scale by 1/sqrt(d), then
// the rank-1 update of the panel's later columns), written back, and then
// applied to the trailing lower triangle in one pass: each trailing entry is
// read once per panel, takes the panel's W updates in column order in a
// register, and is written once. Every entry thus receives the same
// products in the same order as in the column-by-column right-looking
// factor (the plain version), only later. The trailing pass gives each
// thread a 4 x 4 tile: 4 consecutive rows, 4 columns 32 apart (so that a
// warp's loads of the panel in shared memory, and of L in device memory,
// are consecutive).
template <typename T>
__global__ void __launch_bounds__(kFactorThreads)
cholesky_kernel(const T* __restrict__ A, T* __restrict__ Lout, int n,
                int W) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* PT = reinterpret_cast<T*>(smem_raw);   // (w, R) panel, column-major
  __shared__ T s_dinv;

  const int64_t mat = blockIdx.x;
  const int64_t nn = (int64_t)n * n;
  const T* a = A + mat * nn;
  T* l = Lout + mat * nn;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nt >> 5;

  // the lower triangle of A, zeros above the diagonal
  for (int64_t idx = tid; idx < nn; idx += nt) {
    const int i = (int)(idx / n);
    const int k = (int)(idx - (int64_t)i * n);
    l[idx] = (k <= i) ? a[idx] : T(0);
  }
  __syncthreads();

  for (int j0 = 0; j0 < n; j0 += W) {
    const int w = min(W, n - j0);
    const int R = n - j0;           // panel rows j0 .. n-1
    for (int idx = tid; idx < w * R; idx += nt) {
      const int c = idx / R;
      const int r = idx - c * R;
      if (r >= c) {
        const T v = l[(int64_t)(j0 + r) * n + j0 + c];
        PT[c * R + r] = v;
        if (idx == 0) s_dinv = T(1) / sqrt(v);
      }
    }
    __syncthreads();

    for (int c = 0; c < w; ++c) {
      T* colc = PT + c * R;
      const T dinv = s_dinv;
      for (int r = c + tid; r < R; r += nt) colc[r] = colc[r] * dinv;
      __syncthreads();
      // the panel's later columns; the thread that finishes the next
      // diagonal entry forms the next 1/sqrt
      const int cw = w - c - 1;
      for (int idx = tid; idx < cw * R; idx += nt) {
        const int c2 = c + 1 + idx / R;
        const int r = idx % R;
        if (r >= c2) {
          const T v = PT[c2 * R + r] - colc[r] * colc[c2];
          PT[c2 * R + r] = v;
          if (r == c + 1 && c2 == c + 1) s_dinv = T(1) / sqrt(v);
        }
      }
      __syncthreads();
    }

    for (int idx = tid; idx < w * R; idx += nt) {
      const int c = idx / R;
      const int r = idx - c * R;
      if (r >= c) l[(int64_t)(j0 + r) * n + j0 + c] = PT[c * R + r];
    }

    // the trailing lower triangle, rows and columns base .. n-1
    const int base = j0 + w;
    const int Tn = n - base;
    for (int i0 = 4 * warp; i0 < Tn; i0 += 4 * nwarps) {
      for (int cb = 0; cb <= i0 + 3 && cb < Tn; cb += 128) {
        T acc[4][4];
        bool ok[4][4];
#pragma unroll
        for (int p = 0; p < 4; ++p) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int i = i0 + p;
            const int k = cb + lane + 32 * q;
            ok[p][q] = i < Tn && k <= i;
            acc[p][q] = ok[p][q] ? l[(int64_t)(base + i) * n + base + k]
                                 : T(0);
          }
        }
        for (int c = 0; c < w; ++c) {
          const T* pc = PT + c * R + w;   // rows base .. n-1 of column c
          T li[4], lk[4];
#pragma unroll
          for (int p = 0; p < 4; ++p)
            li[p] = (i0 + p < Tn) ? pc[i0 + p] : T(0);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int k = cb + lane + 32 * q;
            lk[q] = (k < Tn) ? pc[k] : T(0);
          }
#pragma unroll
          for (int p = 0; p < 4; ++p) {
#pragma unroll
            for (int q = 0; q < 4; ++q)
              acc[p][q] = acc[p][q] - li[p] * lk[q];
          }
        }
#pragma unroll
        for (int p = 0; p < 4; ++p) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (ok[p][q])
              l[(int64_t)(base + i0 + p) * n + base + cb + lane + 32 * q] =
                  acc[p][q];
          }
        }
      }
    }
    __syncthreads();
  }
}

// L Y = B (kForward: rows in increasing order) or L' X = B (rows in
// decreasing order, L_ji read along row j of L), for one matrix and a block
// of kb right-hand-side columns. X holds B on entry and the solution at the
// end. The rows go in panels of kPanel: one warp per RHS column solves the
// panel's diagonal block, a lane per row, the steps chained by warp
// shuffles; then every thread applies the panel's solved rows to its own
// rows below (above) the panel, in the column order of the plain
// substitution. Two block barriers per panel.
template <typename T, bool kForward>
__global__ void __launch_bounds__(kSolveThreads)
tri_solve_kernel(const T* __restrict__ Lm, const T* __restrict__ Bm,
                 T* __restrict__ Xm, int n, int K, int kb) {
  __shared__ T ys[kPanel][kSolveCols];     // the panel's solved rows

  const int64_t mat = blockIdx.x;
  const int k0 = blockIdx.y * kb;
  const int kw = min(kb, K - k0);
  const T* Lp = Lm + mat * (int64_t)n * n;
  const T* Bp = Bm + mat * (int64_t)n * K + k0;
  T* X = Xm + mat * (int64_t)n * K + k0;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nt >> 5;
  const int c = tid % kb;
  const int row0 = tid / kb;
  const int rstride = nt / kb;
  const bool active = row0 < rstride && c < kw;

  if (active) {
    for (int i = row0; i < n; i += rstride)
      X[(int64_t)i * K + c] = Bp[(int64_t)i * K + c];
  }
  __syncthreads();

  for (int p0 = 0; p0 < n; p0 += kPanel) {
    const int w = min(kPanel, n - p0);
    const int lo = kForward ? p0 : n - p0 - w;   // panel rows lo .. lo+w-1

    // the diagonal block: lane r holds row lo + r of column cc
    for (int cc = warp; cc < kw; cc += nwarps) {
      const int jr = lo + lane;
      T x = (lane < w) ? X[(int64_t)jr * K + cc] : T(0);
      for (int s = 0; s < w; ++s) {
        const int ls = kForward ? s : w - 1 - s;
        const int js = lo + ls;
        T y = T(0);
        if (lane == ls) y = x / Lp[(int64_t)js * n + js];
        y = __shfl_sync(0xffffffffu, y, ls);
        if (lane == ls) x = y;
        if (kForward ? (lane > ls && lane < w) : (lane < ls)) {
          const T lij = kForward ? Lp[(int64_t)jr * n + js]
                                 : Lp[(int64_t)js * n + jr];
          x = x - lij * y;
        }
      }
      if (lane < w) {
        X[(int64_t)jr * K + cc] = x;
        ys[lane][cc] = x;
      }
    }
    __syncthreads();

    // the rows past the panel take its w solved rows, in column order
    if (active) {
      const int i_lo = kForward ? lo + w : 0;
      const int i_hi = kForward ? n : lo;
      for (int i = i_lo + row0; i < i_hi; i += rstride) {
        T v = X[(int64_t)i * K + c];
        if (kForward) {
          const T* li = Lp + (int64_t)i * n + lo;
          for (int s = 0; s < w; ++s) v = v - li[s] * ys[s][c];
        } else {
          for (int s = w - 1; s >= 0; --s)
            v = v - Lp[(int64_t)(lo + s) * n + i] * ys[s][c];
        }
        X[(int64_t)i * K + c] = v;
      }
    }
    __syncthreads();
  }
}

// Phase (A) of the spread factor on one warp, lane r holding row r of the
// diagonal block in x (zeros right of the diagonal): at step c the diagonal
// entry (lane c's) gives 1/sqrt, every row scales its entry c, and row r's
// entries c2 in (c, r] take the product with row c2's entry c. The update
// is computed on every lane and kept where it applies (a select, not a
// branch, so that the unrolled steps schedule as one block); kFull: the
// panel has kW columns and the column guards vanish. The next diagonal
// entry reaches every lane first: lane c + 1 forms its update from its own
// entry c (the product its update takes, operand for operand), so the
// chain from step to step is one shuffle, the 1/sqrt and three operations.
// kSteps < 32 (with kFull): the block's first kSteps rows only, the
// lanes past them holding unit rows (see below).
template <typename T, bool kFull, int kSteps = kW>
__device__ __forceinline__ void factor_diag(T (&x)[kW], int lane, int w,
                                            T* dinv_s) {
  T d = __shfl_sync(0xffffffffu, x[0], 0);
#pragma unroll
  for (int c = 0; c < kSteps; ++c) {
    if (kFull || c < w) {
      const T dinv = T(1) / sqrt(d);
      x[c] = x[c] * dinv;
      if (c + 1 < kSteps)
        d = __shfl_sync(0xffffffffu, x[c + 1] - x[c] * x[c], c + 1);
#pragma unroll
      for (int c2 = c + 1; c2 < kSteps; ++c2) {
        const T lc2 = __shfl_sync(0xffffffffu, x[c], c2);
        const T v = x[c2] - x[c] * lc2;
        x[c2] = ((kFull || c2 < w) && lane >= c2) ? v : x[c2];
      }
      if (lane == 0) dinv_s[c] = dinv;
    }
  }
}

// A short diagonal block (w < 32 rows) runs factor_diag's full steps for
// a count of rows past w, its lanes past w holding unit rows: the real
// rows' entries see exactly the operations of the w steps (a unit row's
// entries left of its diagonal are zeros, or NaN after a NaN pivot, and
// never reach a real row), and the full steps schedule as one block where
// the guarded short ones do not. kSteps: 0 all 32, a single instance of
// the unrolled steps (for a kernel that factors blocks of several widths
// in one launch: in float64 more instances made its steps slower, the
// code fetched anew); 1 the next multiple of 8; 2 also 1, 2 or 4 (the
// warp design, one width a launch).
template <typename T, int kSteps>
__device__ __forceinline__ void factor_diag_padded(T (&x)[kW], int lane,
                                                   int w, T* dinv_s) {
  if constexpr (kSteps == 0) {
    factor_diag<T, true, kW>(x, lane, kW, dinv_s);
    return;
  }
  if constexpr (kSteps == 2) {
    if (w <= 4) {
      if (w == 1)
        factor_diag<T, true, 1>(x, lane, kW, dinv_s);
      else if (w == 2)
        factor_diag<T, true, 2>(x, lane, kW, dinv_s);
      else
        factor_diag<T, true, 4>(x, lane, kW, dinv_s);
      return;
    }
  }
  switch ((w + 7) >> 3) {
    case 1: factor_diag<T, true, 8>(x, lane, kW, dinv_s); break;
    case 2: factor_diag<T, true, 16>(x, lane, kW, dinv_s); break;
    case 3: factor_diag<T, true, 24>(x, lane, kW, dinv_s); break;
    default: factor_diag<T, true, kW>(x, lane, kW, dinv_s);
  }
}

// n <= 32: a warp per matrix, kWarpMats a block. Lane r holds row r of the
// lower triangle (zeros right of the diagonal) and factor_diag runs the
// steps; the lanes write their rows of L, zeros above the diagonal.
template <typename T>
__global__ void __launch_bounds__(kWarpMats * 32)
cholesky_warp_kernel(const T* __restrict__ A, T* __restrict__ Lout,
                     long long nb, int n) {
  __shared__ T dinv_s[kWarpMats][kW];      // factor_diag's 1/sqrt (unread)
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long mat = (long long)blockIdx.x * kWarpMats + warp;
  if (mat >= nb) return;                   // the whole warp
  const int64_t off = mat * (int64_t)n * n + (int64_t)lane * n;
  const T* a = A + off;
  T x[kW];              // lanes past n: a unit row (see above)
#pragma unroll
  for (int c = 0; c < kW; ++c)
    x[c] = lane < n ? (c <= lane ? a[c] : T(0)) : T(c == lane);
  factor_diag_padded<T, 2>(x, lane, n, dinv_s[warp]);
  if (lane < n) {
    T* l = Lout + off;
#pragma unroll
    for (int c = 0; c < kW; ++c)
      if (c < n) l[c] = c <= lane ? x[c] : T(0);
  }
}

// n = 1: a thread per matrix, L = a / sqrt(a) as the plain step forms it
// (the warp kernel's 32 lanes and shuffles cost more than the step).
template <typename T>
__global__ void cholesky_one_kernel(const T* __restrict__ A,
                                    T* __restrict__ Lout, long long nb) {
  const long long mat = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (mat >= nb) return;
  const T a = A[mat];
  Lout[mat] = a * (T(1) / sqrt(a));
}

// The shared-memory design's layout: panel p (columns j0 = 32 p .. j0 + 31)
// column-major over its rows j0 .. n - 1, its columns smem_ld(n - j0)
// apart (the row count rounded up to 16 bytes), the panels one after
// another; entry (i, k), k <= i, of panel p at offset (k - j0) ld + i - j0.
template <typename T>
__host__ __device__ __forceinline__ int smem_ld(int rows) {
  constexpr int V = 16 / sizeof(T);
  return (rows + V - 1) / V * V;
}

// Bytes of the layout, with 4 entries of slack past the end (the trailing
// tiles read a 4-column group whole).
template <typename T>
__host__ __device__ inline size_t smem_chol_bytes(int n) {
  size_t e = 4;
  for (int j0 = 0; j0 < n; j0 += kW) e += (size_t)kW * smem_ld<T>(n - j0);
  return e * sizeof(T);
}

// Threads a block: by n, at most 512 in float32 and 256 in float64 (a
// float64 row of a panel takes 64 registers).
template <typename T>
__host__ __device__ constexpr int smem_chol_max_threads() {
  return sizeof(T) == 8 ? 256 : 512;
}
template <typename T>
int smem_chol_threads(int n) {
  const int t = n <= 64 ? 64 : n <= 128 ? 128 : n <= 256 ? 256 : 512;
  return t < smem_chol_max_threads<T>() ? t : smem_chol_max_threads<T>();
}

// One block per matrix, the lower triangle in shared memory in the panel
// layout above. Per panel: (a) warp 0 factors the diagonal block in its
// registers (factor_diag); (b) every row below it, a row a thread, takes
// 1/sqrt(d) and the diagonal block's products in column order (the
// spread design's phase A); (c) the trailing lower triangle, in tasks of
// 4 columns (k0 .. k0 + 3) by 64 rows (lane l: rows i0 + l and i0 + l +
// 32), each entry taking the panel's 32 products in column order in a
// register. Three block barriers a panel.
// kMaxT threads at most, kMinB blocks an SM: an instance for blocks of at
// most 128 threads keeps a thread to 85 registers, so that a batch of
// small matrices runs six blocks an SM or more.
template <typename T, int kMaxT, int kMinB>
__global__ void __launch_bounds__(kMaxT, kMinB)
cholesky_smem_kernel(const T* __restrict__ A, T* __restrict__ Lout, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* P = reinterpret_cast<T*>(smem_raw);
  __shared__ T dinv_s[kW];
  __shared__ int offs[kSmemPanels + 1];

  const int64_t nn = (int64_t)n * n;
  const T* a = A + blockIdx.x * nn;
  T* l = Lout + blockIdx.x * nn;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nt >> 5;
  const int np = (n + kW - 1) / kW;
  if (tid == 0) {
    int o = 0;
    for (int p = 0; p < np; ++p) {
      offs[p] = o;
      o += kW * smem_ld<T>(n - kW * p);
    }
  }
  __syncthreads();
  // where entry (i, k), k <= i, lies
  auto at = [&](int i, int k) {
    const int j0 = k & ~(kW - 1);
    return offs[k >> 5] + (k - j0) * smem_ld<T>(n - j0) + (i - j0);
  };

  // the lower triangle of A, a row a warp
  for (int i = warp; i < n; i += nwarps) {
    const T* src = a + (int64_t)i * n;
    for (int k = lane; k <= i; k += 32)
      __pipeline_memcpy_async(P + at(i, k), src + k, sizeof(T));
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  for (int p = 0; p < np; ++p) {
    const int j0 = kW * p;
    const int w = min(kW, n - j0);
    const int ld = smem_ld<T>(n - j0);
    T* PT = P + offs[p];            // column c, row j0 + r: PT[c * ld + r]

    // (a) the diagonal block, lane r holding row j0 + r
    if (warp == 0) {
      T x[kW];
#pragma unroll
      for (int c = 0; c < kW; ++c)
        x[c] = lane < w ? (c <= lane ? PT[c * ld + lane] : T(0))
                        : T(c == lane);       // a unit row past w
      factor_diag_padded<T, sizeof(T) == 8 ? 0 : 1>(x, lane, w, dinv_s);
#pragma unroll
      for (int c = 0; c < kW; ++c)
        if (lane < w && c <= lane) PT[c * ld + lane] = x[c];
    }
    __syncthreads();
    if (j0 + kW >= n) break;        // the last panel: nothing below it

    // (b) the panel's rows below the diagonal block, a row a thread
    for (int r = kW + tid; r < n - j0; r += nt) {
      T x[kW];
#pragma unroll
      for (int c = 0; c < kW; ++c) x[c] = PT[c * ld + r];
#pragma unroll
      for (int c = 0; c < kW; ++c) {
        x[c] = x[c] * dinv_s[c];
#pragma unroll
        for (int c2 = c + 1; c2 < kW; ++c2)
          x[c2] = x[c2] - x[c] * PT[c * ld + c2];
      }
#pragma unroll
      for (int c = 0; c < kW; ++c) PT[c * ld + r] = x[c];
    }
    __syncthreads();

    // (c) the trailing lower triangle, rows and columns base .. n - 1
    const int base = j0 + kW;
    const int ng = (n - base + 3) >> 2;
    for (int g = warp; g < ng; g += nwarps) {
      const int k0 = base + 4 * g;       // the group's 4 columns, one panel
      const int jq = k0 & ~(kW - 1);
      const int ldq = smem_ld<T>(n - jq);
      // entry (i, k0 + q) at P[a0 + q ldq + i]
      const int a0 = offs[k0 >> 5] + (k0 - jq) * ldq - jq;
      const T* lk_col = PT + (k0 - j0);  // + c ld + q: L[k0 + q][j0 + c]
      for (int i0 = k0; i0 < n; i0 += 32 * kRB) {
        T acc[kRB][4];
        int ri[kRB];
#pragma unroll
        for (int u = 0; u < kRB; ++u) {
          const int i = i0 + lane + 32 * u;
          ri[u] = min(i, n - 1) - j0;
#pragma unroll
          for (int q = 0; q < 4; ++q)
            acc[u][q] = (i < n && k0 + q <= i) ? P[a0 + q * ldq + i] : T(0);
        }
#pragma unroll 8
        for (int c = 0; c < kW; ++c) {
          T lk[4], li[kRB];
          const T* kp = lk_col + c * ld;
          if constexpr (sizeof(T) == 4) {
            const float4 v = *reinterpret_cast<const float4*>(kp);
            lk[0] = v.x; lk[1] = v.y; lk[2] = v.z; lk[3] = v.w;
          } else {
            const double2 v0 = *reinterpret_cast<const double2*>(kp);
            const double2 v1 = *reinterpret_cast<const double2*>(kp + 2);
            lk[0] = v0.x; lk[1] = v0.y; lk[2] = v1.x; lk[3] = v1.y;
          }
#pragma unroll
          for (int u = 0; u < kRB; ++u) li[u] = PT[c * ld + ri[u]];
#pragma unroll
          for (int u = 0; u < kRB; ++u) {
#pragma unroll
            for (int q = 0; q < 4; ++q)
              acc[u][q] = acc[u][q] - li[u] * lk[q];
          }
        }
#pragma unroll
        for (int u = 0; u < kRB; ++u) {
          const int i = i0 + lane + 32 * u;
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (i < n && k0 + q <= i) P[a0 + q * ldq + i] = acc[u][q];
        }
      }
    }
    __syncthreads();
  }

  // L, zeros above the diagonal, a row a warp
  for (int i = warp; i < n; i += nwarps) {
    T* dst = l + (int64_t)i * n;
    for (int k = lane; k < n; k += 32) dst[k] = k <= i ? P[at(i, k)] : T(0);
  }
}

// The factor of one matrix over bpm blocks (a cooperative grid of nb * bpm
// blocks, bpm per matrix). Every block reaches every grid.sync() below the
// same number of times. The factor in device memory is read with __ldcg
// (through L2, past the SM's own L1), since other blocks write it.
template <typename T>
__global__ void __launch_bounds__(kSpreadThreads)
cholesky_spread_kernel(const T* __restrict__ A, T* __restrict__ Lout, int n,
                       int bpm) {
  __shared__ T D[kW][kW + 1];        // the factored diagonal block
  __shared__ T dinv_s[kW];
  __shared__ T PI[kW][kTile + 1];    // panel entries of the tile's rows
  __shared__ T PK[kW][kTile + 1];    // panel entries of the tile's columns

  cg::grid_group grid = cg::this_grid();
  const int64_t mat = blockIdx.x / bpm;
  const int b = blockIdx.x % bpm;
  const int64_t nn = (int64_t)n * n;
  const T* a = A + mat * nn;
  T* l = Lout + mat * nn;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // the lower triangle of A, zeros above the diagonal
  for (int64_t idx = (int64_t)b * nt + tid; idx < nn;
       idx += (int64_t)bpm * nt) {
    const int i = (int)(idx / n);
    const int k = (int)(idx - (int64_t)i * n);
    l[idx] = (k <= i) ? a[idx] : T(0);
  }
  grid.sync();

  for (int j0 = 0; j0 < n; j0 += kW) {
    const int w = min(kW, n - j0);

    // (A) the diagonal block, lane r holding row j0 + r: at step c the
    // diagonal entry (lane c's) gives 1/sqrt, every row scales its entry
    // c, and row r's entries c2 in (c, r] take the product with row c2's
    if (warp == 0) {
      T x[kW];
      const T* src = l + (int64_t)(j0 + lane) * n + j0;
#pragma unroll
      for (int c = 0; c < kW; ++c)
        x[c] = (lane < w && c <= lane) ? __ldcg(src + c) : T(0);
      if (w == kW)
        factor_diag<T, true>(x, lane, w, dinv_s);
      else
        factor_diag<T, false>(x, lane, w, dinv_s);
#pragma unroll
      for (int c = 0; c < kW; ++c)
        if (lane < w && c <= lane) D[lane][c] = x[c];
    }
    __syncthreads();

    // (A) the panel's rows below the diagonal block: row j0 + w + r on
    // block r % bpm, thread r / bpm. Only a full panel has rows below it.
    const int R = n - j0 - w;
    for (int r = b + bpm * tid; r < R; r += bpm * nt) {
      T* row = l + (int64_t)(j0 + w + r) * n + j0;
      T x[kW];
#pragma unroll
      for (int c = 0; c < kW; ++c) x[c] = __ldcg(row + c);
#pragma unroll
      for (int c = 0; c < kW; ++c) {
        x[c] = x[c] * dinv_s[c];
#pragma unroll
        for (int c2 = c + 1; c2 < kW; ++c2)
          x[c2] = x[c2] - x[c] * D[c2][c];
      }
#pragma unroll
      for (int c = 0; c < kW; ++c) row[c] = x[c];
    }
    grid.sync();

    // (B) every block has read the diagonal block; block 0 of the matrix
    // now stores its factor
    if (b == 0) {
      for (int idx = tid; idx < w * w; idx += nt) {
        const int r = idx / w;
        const int c = idx - r * w;
        if (c <= r) l[(int64_t)(j0 + r) * n + j0 + c] = D[r][c];
      }
    }
    // (B) the trailing lower triangle, rows and columns base .. n-1, in
    // 64 x 64 tiles t = ti (ti + 1) / 2 + tk (tk <= ti) dealt over blocks;
    // thread (tr, tc) keeps rows tr + 16 p and columns tc + 16 q
    const int base = j0 + w;
    const int Tn = n - base;
    const int nti = (Tn + kTile - 1) / kTile;
    const int ntiles = nti * (nti + 1) / 2;
    const int tr = tid >> 4;
    const int tc = tid & 15;
    for (int t = b; t < ntiles; t += bpm) {
      int ti = (int)((sqrt(8.0 * t + 1.0) - 1.0) * 0.5);
      while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
      while (ti * (ti + 1) / 2 > t) --ti;
      const int i0 = ti * kTile;
      const int k0 = (t - ti * (ti + 1) / 2) * kTile;
      T acc[4][4];
      bool ok[4][4];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = i0 + tr + 16 * p;
          const int k = k0 + tc + 16 * q;
          ok[p][q] = i < Tn && k <= i;
          acc[p][q] = ok[p][q]
              ? __ldcg(l + (int64_t)(base + i) * n + base + k) : T(0);
        }
      }
      for (int idx = tid; idx < kTile * kW; idx += nt) {
        const int r = idx / kW;
        const int c = idx - r * kW;
        PI[c][r] = (c < w && i0 + r < Tn)
            ? __ldcg(l + (int64_t)(base + i0 + r) * n + j0 + c) : T(0);
        PK[c][r] = (c < w && k0 + r < Tn)
            ? __ldcg(l + (int64_t)(base + k0 + r) * n + j0 + c) : T(0);
      }
      __syncthreads();
      for (int c = 0; c < w; ++c) {
        T li[4], lk[4];
#pragma unroll
        for (int p = 0; p < 4; ++p) li[p] = PI[c][tr + 16 * p];
#pragma unroll
        for (int q = 0; q < 4; ++q) lk[q] = PK[c][tc + 16 * q];
#pragma unroll
        for (int p = 0; p < 4; ++p) {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            acc[p][q] = acc[p][q] - li[p] * lk[q];
        }
      }
#pragma unroll
      for (int p = 0; p < 4; ++p) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (ok[p][q])
            l[(int64_t)(base + i0 + tr + 16 * p) * n + base + k0 + tc +
              16 * q] = acc[p][q];
        }
      }
      __syncthreads();
    }
    grid.sync();
  }
}

// One warp's column of a cluster-solve panel's diagonal block, lane r
// holding row lo + r in x, with dd[s * 33 + r] the coefficient of x_s in
// row r (backward: L[lo + s][lo + r]; forward: L[lo + r][lo + s]). At each
// step s (backward from the bottom, forward from the top) lane s divides by
// L[s][s], the quotient reaches every lane by shuffle, and the lanes still
// to solve subtract their coefficient times it. A full panel goes four rows
// a round: their values reach every lane by four independent shuffles,
// every lane solves the four among themselves (the operations of the rows'
// own lanes, in their order), and the rows past them take the four updates
// in order.
template <typename T, bool kFwd>
__device__ __forceinline__ T solve_lanes(T x, const T* dd, int w, int lane) {
  constexpr int G = 4;
  constexpr int S = kW + 1;
  if (w == kW) {
#pragma unroll
    for (int g = 0; g < kW; g += G) {
      const int t0 = kFwd ? g : kW - G - g;
      T v[G], y[G];
#pragma unroll
      for (int j = 0; j < G; ++j) v[j] = __shfl_sync(0xffffffffu, x, t0 + j);
#pragma unroll
      for (int jj = 0; jj < G; ++jj) {
        const int j = kFwd ? jj : G - 1 - jj;
        T u = v[j];
#pragma unroll
        for (int kk = 0; kk < jj; ++kk) {
          const int k = kFwd ? kk : G - 1 - kk;
          u = u - dd[(t0 + k) * S + t0 + j] * y[k];
        }
        y[j] = u / dd[(t0 + j) * S + t0 + j];
      }
#pragma unroll
      for (int j = 0; j < G; ++j)
        if (lane == t0 + j) x = y[j];
      if (kFwd ? lane >= t0 + G : lane < t0) {
#pragma unroll
        for (int kk = 0; kk < G; ++kk) {
          const int k = kFwd ? kk : G - 1 - kk;
          x = x - dd[(t0 + k) * S + lane] * y[k];
        }
      }
    }
    return x;
  }
  for (int k = 0; k < w; ++k) {
    const int s = kFwd ? k : w - 1 - k;
    const T lsr = dd[s * S + lane];
    T y = (lane == s) ? x / lsr : T(0);
    y = __shfl_sync(0xffffffffu, y, s);
    if (lane == s) x = y;
    if (kFwd ? lane > s : lane < s) x = x - lsr * y;
  }
  return x;
}

// One thread's column of a cluster-solve panel, its rows r = 0..31 in x:
// first (if ls) the solved rows y_s of the panel before it, x_r -= c_sr y_s
// in the substitution's order, with c_sr = ls[s * ss + r * rs] and
// ys[s * kc] = y_s; then the panel's own diagonal block, x_s /= L[s][s]
// and x_r -= dd[s * 33 + r] x_s for the rows r still to solve. Each x_r
// thus takes its subtractions in the plain substitution's order. kFull:
// the panel has 32 rows.
template <typename T, bool kFwd, bool kFull>
__device__ __forceinline__ void solve_column(T (&x)[kW], const T* ls,
                                             int ss, int rs, const T* ys,
                                             int kc, const T* dd, int w) {
  if (ls != nullptr) {
    for (int k = 0; k < kW; ++k) {
      const int s = kFwd ? k : kW - 1 - k;
      const T y = ys[s * kc];
#pragma unroll
      for (int r = 0; r < kW; ++r)
        x[r] = x[r] - ls[(int64_t)s * ss + r * rs] * y;
    }
  }
#pragma unroll
  for (int k = 0; k < kW; ++k) {
    const int s = kFwd ? k : kW - 1 - k;
    if (kFull || s < w) {
      const T y = x[s] / dd[s * (kW + 1) + s];
      x[s] = y;
#pragma unroll
      for (int r = 0; r < kW; ++r) {
        if (kFwd ? r > s : r < s) x[r] = x[r] - dd[s * (kW + 1) + r] * y;
      }
    }
  }
}

// L Y = B (kFwd) or L' X = B for one matrix and kc right-hand-side columns
// on one cluster of C blocks (grid: C * column groups by nb). Panel q is
// the q-th in the order of the substitution: forward rows lo_q = 32 q ..
// hi_q - 1, hi_q = min(lo_q + 32, n); backward hi_q = n - 32 q, lo_q =
// max(hi_q - 32, 0). It belongs to block q % C, which keeps it as its local
// panel q / C: local row t = 32 (q / C) + r is row lo_q + r. Shared memory
// (T): Xs[kc][rows + 1] (the block's rows of X), Ls[3] (three panels'
// coefficients at the block's rows: backward [32][rows], c_st =
// L[lo + s][row t]; forward [rows][33], c_st = L[row t][lo + s]),
// Ds[3][32][33] (three diagonal blocks, on their owner), xs[3][32][kc]
// (three panels' solved rows, written by their owner into every block of
// the cluster).
template <typename T, bool kFwd>
__global__ void __launch_bounds__(kClusterThreads)
solve_cluster_kernel(const T* __restrict__ Lm, const T* __restrict__ Bm,
                     T* __restrict__ Xm, int n, int K, int kc, int rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int xstride = rows + 1;  // odd: a warp's columns fall in other banks
  // a coefficient c_st of a staged panel: Ls[buf][s * ss + t * ts]
  const int ss = kFwd ? 1 : rows;
  const int ts = kFwd ? kW + 1 : 1;
  const int64_t lsz = (int64_t)rows * (kFwd ? kW + 1 : kW);
  T* Xs = reinterpret_cast<T*>(smem_raw);
  T* Ls = Xs + (int64_t)kc * xstride;
  T* Ds = Ls + 3 * lsz;
  T* xs = Ds + 3 * kW * (kW + 1);

  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int64_t mat = blockIdx.y;
  const int k0 = (blockIdx.x / C) * kc;
  const int kw = min(kc, K - k0);
  const T* L = Lm + mat * (int64_t)n * n;
  const T* B = Bm + mat * (int64_t)n * K + k0;
  T* X = Xm + mat * (int64_t)n * K + k0;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nt >> 5;
  const int np = (n + kW - 1) / kW;
  const int nu = rank < np ? (np - 1 - rank) / C + 1 : 0;   // local panels
  const int nrows = kW * nu;

  // panel q's rows lo .. hi - 1
  auto bounds = [&](int q, int* lo, int* hi) {
    if (kFwd) {
      *lo = kW * q;
      *hi = min(*lo + kW, n);
    } else {
      *hi = n - kW * q;
      *lo = max(*hi - kW, 0);
    }
  };
  // local row t -> its row of the matrix, or -1 past a short last panel
  auto row_of = [&](int t) {
    int lo, hi;
    bounds(rank + C * (t / kW), &lo, &hi);
    const int i = lo + t % kW;
    return i < hi ? i : -1;
  };
  // the first local row past panel q (in the substitution's order)
  auto first_above = [&](int q) {
    return q >= rank ? kW * ((q - rank) / C + 1) : 0;
  };
  // one cp.async group: panel q's coefficients at this block's rows past it
  // into Ls[buf] and, on the panel's owner, its diagonal block into Ds[buf]
  // (buf = q % 3: copies run two panels ahead); each copy reads along a row
  // of L
  auto stage = [&](int q, int buf) {
    int lo, hi;
    bounds(q, &lo, &hi);
    const int w = hi - lo;
    const int t0 = first_above(q);
    const int na = nrows - t0;
    T* dst = Ls + buf * lsz;
    for (int idx = tid; idx < w * na; idx += nt) {
      const int a = idx / (kFwd ? w : na);
      const int b = idx - a * (kFwd ? w : na);
      const int s = kFwd ? b : a;
      const int t = t0 + (kFwd ? a : b);
      const int i = row_of(t);
      if (i >= 0)
        __pipeline_memcpy_async(
            dst + (int64_t)s * ss + (int64_t)t * ts,
            kFwd ? L + (int64_t)i * n + lo + s : L + (int64_t)(lo + s) * n + i,
            sizeof(T));
    }
    if (q % C == rank) {
      T* dd = Ds + buf * kW * (kW + 1);
      for (int idx = tid; idx < w * w; idx += nt) {
        const int a = idx / w;
        const int b = idx - a * w;   // along a row of L: dd[s][r] = c_sr
        __pipeline_memcpy_async(
            kFwd ? dd + b * (kW + 1) + a : dd + a * (kW + 1) + b,
            L + (int64_t)(lo + a) * n + lo + b, sizeof(T));
      }
    }
    __pipeline_commit();
  };

  // this block's local rows ta .. tb-1 (all past panel q) take panel q's
  // solved rows, in the substitution's order
  auto update = [&](int q, int ta, int tb) {
    int lo, hi;
    bounds(q, &lo, &hi);
    const int w = hi - lo;
    const T* ls = Ls + (q % 3) * lsz;
    const T* xq = xs + (q % 3) * kW * kc;
    const int na = tb - ta;
    for (int idx = tid; idx < na * kw; idx += nt) {
      const int cc = idx / na;
      const int t = ta + idx - cc * na;
      if (row_of(t) < 0) continue;
      T v = Xs[(int64_t)cc * xstride + t];
      for (int k = 0; k < w; ++k) {
        const int s = kFwd ? k : w - 1 - k;
        v = v - ls[(int64_t)s * ss + (int64_t)t * ts] * xq[s * kc + cc];
      }
      Xs[(int64_t)cc * xstride + t] = v;
    }
  };

  // panel q's owner: bring the panel's rows up to date with panel q - 1's
  // solved rows (if prev), solve its diagonal block, then write the solved
  // rows to X and into xs[q % 3] of every block of the cluster. A few
  // columns take a warp each, lanes as rows, the steps chained by
  // shuffles; many take a thread each, the panel's 32 rows in registers,
  // so that each step's division serves one column (a warp's instructions
  // issue once for all 32 lanes).
  auto solve_panel = [&](int q, bool prev) {
    int lo, hi;
    bounds(q, &lo, &hi);
    const int w = hi - lo;
    const T* dd = Ds + (q % 3) * kW * (kW + 1);
    const int t0 = kW * (q / C);
    if (kw <= nwarps) {
      if (prev) {
        update(q - 1, t0, t0 + kW);
        __syncthreads();
      }
      if (warp < kw) {
        T* xc = Xs + (int64_t)warp * xstride + t0;
        const T x = solve_lanes<T, kFwd>((lane < w) ? xc[lane] : T(0), dd, w,
                                         lane);
        if (lane < w) xc[lane] = x;
      }
    } else {
      const T* ls = prev ? Ls + ((q - 1) % 3) * lsz + (int64_t)t0 * ts
                         : nullptr;
      const T* ys = xs + ((q + 2) % 3) * kW * kc;    // panel q - 1's
      for (int c = tid; c < kw; c += nt) {
        T x[kW];
        T* xc = Xs + (int64_t)c * xstride + t0;
#pragma unroll
        for (int r = 0; r < kW; ++r) x[r] = (r < w) ? xc[r] : T(0);
        if (w == kW)
          solve_column<T, kFwd, true>(x, ls, ss, ts, ys + c, kc, dd, w);
        else
          solve_column<T, kFwd, false>(x, ls, ss, ts, ys + c, kc, dd, w);
#pragma unroll
        for (int r = 0; r < kW; ++r)
          if (r < w) xc[r] = x[r];
      }
    }
    __syncthreads();
    const int xo = (q % 3) * kW * kc;
    for (int idx = tid; idx < w * kw; idx += nt) {
      const int r = idx / kw;
      const int c = idx - r * kw;
      const T v = Xs[(int64_t)c * xstride + t0 + r];
      X[(int64_t)(lo + r) * K + c] = v;
      for (int b = 0; b < C; ++b)
        cluster.map_shared_rank(xs, b)[xo + r * kc + c] = v;
    }
  };

  for (int idx = tid; idx < kw * nrows; idx += nt) {
    const int cc = idx / nrows;
    const int t = idx - cc * nrows;
    const int i = row_of(t);
    if (i >= 0) Xs[(int64_t)cc * xstride + t] = B[(int64_t)i * K + cc];
  }
  cluster.sync();                 // every block runs: its xs may be written
  stage(0, 0);
  if (np > 1)
    stage(1, 1);
  else
    __pipeline_commit();
  __pipeline_wait_prior(1);
  __syncthreads();
  if (rank == 0) solve_panel(0, false);

  // Per panel q, one cluster barrier, split: the copies for two panels
  // ahead are issued between its arrive and its wait. After it, the owner
  // of panel q + 1 first brings that panel's rows up to date, solves and
  // publishes it, and only then updates its other rows: the chain from
  // panel to panel passes one block's 32 rows, not all of them.
  for (int q = 0; q < np; ++q) {
    __syncthreads();              // this block is done with panel q - 1
    asm volatile("barrier.cluster.arrive.release;" ::: "memory");
    if (q + 2 < np)
      stage(q + 2, (q + 2) % 3);
    else
      __pipeline_commit();
    asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
    __pipeline_wait_prior(2);     // this thread's copies of panel q
    __syncthreads();              // and everyone's
    const int t0 = first_above(q);
    if (q + 1 < np && (q + 1) % C == rank) {
      __pipeline_wait_prior(1);   // panel q + 1's diagonal block
      __syncthreads();
      solve_panel(q + 1, true);   // its rows come first
      update(q, t0 + kW, nrows);
    } else {
      update(q, t0, nrows);
    }
  }
}

// Blocks of the spread factor one SM holds at once, once per device and T.
template <typename T>
cudaError_t spread_per_sm(int* per_sm) {
  static int cache[kMaxDevices];   // 0: not asked yet
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cache[dev] == 0) {
    int v = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &v, cholesky_spread_kernel<T>, kSpreadThreads, 0);
    if (e != cudaSuccess) return e;
    cache[dev] = v > 0 ? v : -1;
  }
  *per_sm = cache[dev] > 0 ? cache[dev] : 0;
  return cudaSuccess;
}

// Blocks per matrix of the spread factor: the SMs the batch leaves, at most
// the first panel's trailing tiles; 1 means the one-block kernel.
inline int spread_blocks(long long nb, int n, int sms) {
  const int tn = n - kW;
  const int nti = (tn + kTile - 1) / kTile;
  const int most = nti * (nti + 1) / 2;
  const long long free = sms / nb;
  return tn <= 0 ? 1 : (int)(free < most ? free : most);
}

// Blocks a matrix for nb matrices of size n: 2 or more on the cooperative
// spread, else 1 (cholesky_kernel).
template <typename T>
cudaError_t cholesky_blocks(long long nb, int n, const DeviceInfo* d,
                            int* out) {
  int bpm = spread_blocks(nb, n, d->sms);
  if (d->coop && bpm >= 2) {
    int per_sm = 0;
    cudaError_t e = spread_per_sm<T>(&per_sm);
    if (e != cudaSuccess) return e;
    // a cooperative grid must be resident at once
    const long long most = (long long)per_sm * d->sms / nb;
    bpm = (int)(bpm < most ? bpm : most);
  }
  *out = d->coop && bpm >= 2 ? bpm : 1;
  return cudaSuccess;
}

// Whether the lower triangle of an n x n matrix fits the shared-memory
// design (its layout beside the kernel's few static bytes).
template <typename T>
bool smem_chol_fits(int n, int cap) {
  return n <= kW * kSmemPanels && smem_chol_bytes<T>(n) + 512 <= (size_t)cap;
}

// The design cholesky takes for nb matrices of size n: 0 a warp a matrix,
// 1 a block a matrix in shared memory, 2 a block a matrix in device memory
// (cholesky_kernel), 3 the cooperative spread; bpm, when given, receives
// the spread's blocks a matrix (what the spread would take, whichever
// design runs).
// Where the triangle fits in shared memory, the one-block design also
// takes the few matrices that the spread would give up to 3 blocks each,
// and, in float64, one matrix up to n = 212: measured faster there on an
// H100 (scripts/torch_chol_switch.py: 0.57-0.89x the spread's time; the
// spread stays faster at one float32 matrix of 200 or 314, one float64
// matrix of 224, and at 8 float32 matrices of 314).
template <typename T>
bool smem_over_spread(long long nb, int n, int bpm) {
  return bpm <= 3 || (nb == 1 && sizeof(T) == 8 && n <= 212);
}

template <typename T>
cudaError_t cholesky_variant(long long nb, int n, const DeviceInfo* d,
                             int* variant, int* bpm_out = nullptr) {
  int bpm = 1;
  cudaError_t e = cholesky_blocks<T>(nb, n, d, &bpm);
  if (e != cudaSuccess) return e;
  if (bpm_out != nullptr) *bpm_out = bpm;
  const bool fits = n > kW && smem_chol_fits<T>(n, d->cap);
  *variant = n <= kW ? 0
             : bpm >= 2 && !(fits && smem_over_spread<T>(nb, n, bpm)) ? 3
             : fits ? 1
                    : 2;
  return cudaSuccess;
}

// One instance of the shared-memory design.
template <typename T, int kMaxT, int kMinB>
int launch_smem(const T* A, T* L, long long nb, int n, int threads,
                const DeviceInfo* d, void* stream) {
  // the kernel may use all of a block's shared memory: set once per device
  static bool ready[kMaxDevices];
  if (!ready[d->dev]) {
    cudaError_t e = cudaFuncSetAttribute(
        cholesky_smem_kernel<T, kMaxT, kMinB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, d->cap - 512);
    if (e != cudaSuccess) return (int)e;
    ready[d->dev] = true;
  }
  cholesky_smem_kernel<T, kMaxT, kMinB>
      <<<(unsigned)nb, threads, smem_chol_bytes<T>(n),
         (cudaStream_t)stream>>>(A, L, n);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_cholesky(const T* A, T* L, long long nb, int n, void* stream) {
  const DeviceInfo* d = nullptr;
  cudaError_t e = device_info(&d);
  if (e != cudaSuccess) return (int)e;
  const int cap = d->cap;
  int bpm = 1, variant = 0;
  e = cholesky_variant<T>(nb, n, d, &variant, &bpm);
  if (e != cudaSuccess) return (int)e;
  if (variant == 3) {
    int nn = n, b = bpm;
    void* args[] = {(void*)&A, (void*)&L, (void*)&nn, (void*)&b};
    e = cudaLaunchCooperativeKernel(
        (const void*)cholesky_spread_kernel<T>, dim3((unsigned)(nb * bpm)),
        dim3(kSpreadThreads), args, 0, (cudaStream_t)stream);
    return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
  }
  if (variant == 0 && n == 1) {
    cholesky_one_kernel<T><<<(unsigned)((nb + 127) / 128), 128, 0,
                             (cudaStream_t)stream>>>(A, L, nb);
    return (int)cudaGetLastError();
  }
  if (variant == 0) {
    cholesky_warp_kernel<T><<<(unsigned)((nb + kWarpMats - 1) / kWarpMats),
                              kWarpMats * 32, 0, (cudaStream_t)stream>>>(
        A, L, nb, n);
    return (int)cudaGetLastError();
  }
  if (variant == 1) {
    // a batch that leaves SMs idle: more threads for the copies in and out
    int threads = smem_chol_threads<T>(n);
    if (nb <= d->sms && threads < 256) threads = 256;
    if constexpr (sizeof(T) == 4) {
      if (threads <= 128)
        return launch_smem<T, 128, 6>(A, L, nb, n, threads, d, stream);
    }
    return launch_smem<T, smem_chol_max_threads<T>(), 1>(A, L, nb, n,
                                                          threads, d, stream);
  }
  const size_t col = (size_t)n * sizeof(T);
  // the dynamic panel, beside the kernel's few static bytes
  int W = cap > 64 ? (int)((size_t)(cap - 64) / col) : 0;
  W = W < kMaxPanel ? W : kMaxPanel;
  if (W < 1) return (int)cudaErrorInvalidValue;   // the wrapper checks first
  const size_t smem = (size_t)W * col;
  e = cudaFuncSetAttribute(cholesky_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  cholesky_kernel<T><<<(unsigned)nb, kFactorThreads, smem,
                       (cudaStream_t)stream>>>(A, L, n, W);
  return (int)cudaGetLastError();
}

// Columns per block: up to kSolveCols, fewer while that leaves SMs idle.
inline int solve_cols(long long nb, int K) {
  int kb = K < kSolveCols ? K : kSolveCols;
  while (kb > 1 && nb * ((K + kb - 1) / kb) < kTargetBlocks) kb >>= 1;
  return kb;
}

// One block per matrix and block of columns, L read in device memory: the
// design for batches whose panels do not fit in shared memory.
template <typename T, bool kForward>
int launch_rows(const T* L, const T* B, T* X, long long nb, int n, int K,
                void* stream) {
  const int kb = solve_cols(nb, K);
  dim3 grid((unsigned)nb, (unsigned)((K + kb - 1) / kb));
  tri_solve_kernel<T, kForward><<<grid, kSolveThreads, 0,
                                  (cudaStream_t)stream>>>(L, B, X, n, K, kb);
  return (int)cudaGetLastError();
}

// The cluster solve's plan: kc columns a cluster, rows per block, threads
// and shared memory, for `per` clusters a matrix.
struct SolvePlan {
  int kc, rows, threads;
  size_t smem;
};

template <typename T>
SolvePlan solve_plan(bool fwd, int n, int K, int C, long long per) {
  SolvePlan p;
  const long long kc = (K + per - 1) / per;
  p.kc = (int)(kc < 64 ? kc : 64);   // at most two columns a warp
  p.rows = kW * ((n + kW * C - 1) / (kW * C));
  const size_t ls = (size_t)(fwd ? kW + 1 : kW) * p.rows;
  p.smem = ((size_t)p.kc * (p.rows + 1) + 3 * ls + 3 * kW * (kW + 1) +
            3 * (size_t)kW * p.kc) * sizeof(T);
  // a warp a column up to 16 columns, else about 8 update pairs a thread
  const int t = p.kc <= 16 ? 32 * p.kc : (8 * p.kc + 31) / 32 * 32;
  p.threads = t < 128 ? 128 : (t > kClusterThreads ? kClusterThreads : t);
  return p;
}

// The cluster kernel may use all of a block's shared memory; set once per
// device and kernel (T, direction).
template <typename T, bool kFwd>
cudaError_t allow_cluster_smem(int cap) {
  static bool done[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || done[dev]) return e;
  e = cudaFuncSetAttribute(solve_cluster_kernel<T, kFwd>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, cap);
  done[dev] = e == cudaSuccess;
  return e;
}

// The solve clusters the card holds at once for a launch shape, remembered
// per kernel (T, direction: each instance has its own cache) and per
// (device, cluster size, threads, shared memory): a few shapes recur.
// cached = false asks the card again and leaves the cache as it is.
template <typename T, bool kFwd>
cudaError_t clusters_fit(const cudaLaunchConfig_t* cfg, int C, int* fit,
                         bool cached = true) {
  struct Entry {
    int dev, C, threads, fit;
    size_t smem;
  };
  constexpr int kEntries = 64;
  static Entry cache[kEntries];
  static int used = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const int threads = (int)cfg->blockDim.x;
  for (int i = 0; cached && i < used; ++i) {
    const Entry& c = cache[i];
    if (c.dev == dev && c.C == C && c.threads == threads &&
        c.smem == cfg->dynamicSmemBytes) {
      *fit = c.fit;
      return cudaSuccess;
    }
  }
  e = cudaOccupancyMaxActiveClusters(fit, solve_cluster_kernel<T, kFwd>,
                                     cfg);
  if (e == cudaSuccess && cached && used < kEntries)
    cache[used++] = Entry{dev, C, threads, *fit, cfg->dynamicSmemBytes};
  return e;
}

// The cluster launch for nb matrices: as many clusters per matrix as the
// card holds at once, each on a block of kc columns. *ok = false when the
// card does not hold a cluster per matrix (or a block's rows do not fit in
// shared memory, or the plan gives a cluster more than max_kc columns):
// the caller takes another design. fit_out, when given, receives the
// clusters the card holds at the first plan's size, asked with or without
// the cache, and nothing is launched; nor is anything launched on a dry
// run, which only sets *ok.
template <typename T, bool kFwd>
cudaError_t launch_cluster(const T* L, const T* B, T* X, long long nb, int n,
                           int K, void* stream, bool* ok,
                           int* fit_out = nullptr, bool cached = true,
                           bool dry_run = false, int max_kc = 64) {
  *ok = false;
  const panel::DeviceInfo* d = nullptr;
  cudaError_t e = panel::device_info(&d);
  if (e != cudaSuccess) return e;
  const int cap = d->cap, sms = d->sms;
  const int np = (n + kW - 1) / kW;
  const int C = np < kCluster ? np : kCluster;
  long long per = sms / C / nb;                  // clusters per matrix
  if (C < 2 || per < 1) return cudaSuccess;
  SolvePlan p = solve_plan<T>(kFwd, n, K, C, per);
  if (p.smem > (size_t)cap) return cudaSuccess;
  e = allow_cluster_smem<T, kFwd>(cap);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cfg.stream = (cudaStream_t)stream;
  cfg.blockDim = dim3((unsigned)p.threads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.gridDim = dim3((unsigned)(C * per), (unsigned)nb);
  // the clusters the card holds at once at this size (the GPCs, not the
  // SM count, decide): fewer clusters, each with more columns
  int fit = 0;
  e = clusters_fit<T, kFwd>(&cfg, C, &fit, cached);
  if (e != cudaSuccess) return e;
  if (fit_out != nullptr) {
    *fit_out = fit;
    return cudaSuccess;
  }
  if (fit / nb < per) {
    per = fit / nb;
    if (per < 1) return cudaSuccess;
    p = solve_plan<T>(kFwd, n, K, C, per);
    if (p.smem > (size_t)cap) return cudaSuccess;
    cfg.blockDim = dim3((unsigned)p.threads);
    cfg.dynamicSmemBytes = p.smem;
  }
  cfg.gridDim = dim3((unsigned)(C * ((K + p.kc - 1) / p.kc)), (unsigned)nb);
  if (p.kc > max_kc) return cudaSuccess;
  *ok = true;
  if (dry_run) return cudaSuccess;
  e = cudaLaunchKernelEx(&cfg, solve_cluster_kernel<T, kFwd>, L, B, X, n, K,
                         p.kc, p.rows);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// L Y = B: on clusters while the card holds at least one cluster per
// matrix at once, else the batched panel design (panel_solve.cuh), or one
// block per matrix reading L in device memory where its panels do not fit
// in shared memory.
template <typename T>
int launch_solve_lower(const T* L, const T* B, T* X, long long nb, int n,
                       int K, void* stream) {
  bool ok = false;
  cudaError_t e = launch_cluster<T, true>(L, B, X, nb, n, K, stream, &ok);
  if (e != cudaSuccess || ok) return (int)e;
  const panel::DeviceInfo* d = nullptr;
  e = panel::device_info(&d);
  if (e != cudaSuccess) return (int)e;
  if (!panel::fits<T>(panel::kLower, n, d->cap))
    return launch_rows<T, true>(L, B, X, nb, n, K, stream);
  return (int)panel::launch<T, panel::kLower>(L, nullptr, B, X, nb, n, K, *d,
                                              (cudaStream_t)stream);
}

// L' X = B: on clusters of up to 16 columns while the card holds one a
// matrix, else on cluster_solve.cuh's clusters (past this plan's shared
// memory or its 16 columns), else the batched designs as solve_lower,
// the panel design reading L' in place (its panels' rows of L copied
// transposed into shared memory).
constexpr int kWideCols = 16;

template <typename T>
int launch_solve_t(const T* L, const T* B, T* X, long long nb, int n, int K,
                   void* stream) {
  bool ok = false;
  cudaError_t e = launch_cluster<T, false>(L, B, X, nb, n, K, stream, &ok,
                                           nullptr, true, false, kWideCols);
  if (e != cudaSuccess || ok) return (int)e;
  cluster::Plan cp;
  e = cluster::plan<T, panel::kLowerT>(nb, n, K, &cp, &ok);
  if (e != cudaSuccess) return (int)e;
  if (ok)
    return (int)cluster::launch<T, panel::kLowerT>(
        cp, L, nullptr, B, X, nb, n, K, (cudaStream_t)stream);
  const panel::DeviceInfo* d = nullptr;
  e = panel::device_info(&d);
  if (e != cudaSuccess) return (int)e;
  if (!panel::fits<T>(panel::kLowerT, n, d->cap))
    return launch_rows<T, false>(L, B, X, nb, n, K, stream);
  return (int)panel::launch<T, panel::kLowerT>(L, nullptr, B, X, nb, n, K,
                                               *d, (cudaStream_t)stream);
}

template <typename T>
int cluster_fit(int fwd, int n, int K, long long nb, int cached) {
  bool ok = false;
  int fit = -1;
  cudaError_t e = fwd ? launch_cluster<T, true>(nullptr, nullptr, nullptr, nb,
                                                n, K, nullptr, &ok, &fit,
                                                cached != 0)
                      : launch_cluster<T, false>(nullptr, nullptr, nullptr,
                                                 nb, n, K, nullptr, &ok, &fit,
                                                 cached != 0);
  return e != cudaSuccess ? -(int)e : fit;
}

// The design the launchers take for nb matrices of size n and K columns:
// cholesky (which 0) the blocks a matrix (1: a warp or a block a matrix,
// 2 or more: cholesky_spread_kernel), and (which 3) which of its designs:
// 0 cholesky_warp_kernel, 1 cholesky_smem_kernel, 2 cholesky_kernel, 3
// cholesky_spread_kernel; solve_lower (1) and solve_lower_t (2) 0 on
// clusters, 1 on the panel design, 2 on tri_solve_kernel, and
// solve_lower_t 3 on cluster_solve.cuh's clusters of 8 blocks, 4 on its
// clusters of 16; minus the CUDA error on failure. Nothing is launched.
template <typename T>
int design(int which, long long nb, int n, int K) {
  cudaError_t e;
  if (which == 0 || which == 3) {
    const DeviceInfo* d = nullptr;
    e = device_info(&d);
    int bpm = 1, variant = 0;
    if (e == cudaSuccess) e = cholesky_variant<T>(nb, n, d, &variant, &bpm);
    return e != cudaSuccess ? -(int)e
           : which == 0     ? (variant == 3 ? bpm : 1)
                            : variant;
  }
  bool ok = false;
  e = which == 1 ? launch_cluster<T, true>(nullptr, nullptr, nullptr, nb, n,
                                           K, nullptr, &ok, nullptr, true,
                                           true)
                 : launch_cluster<T, false>(nullptr, nullptr, nullptr, nb,
                                            n, K, nullptr, &ok, nullptr, true,
                                            true, kWideCols);
  if (e != cudaSuccess) return -(int)e;
  if (ok) return 0;
  if (which == 2) {
    cluster::Plan cp;
    e = cluster::plan<T, panel::kLowerT>(nb, n, K, &cp, &ok);
    if (e != cudaSuccess) return -(int)e;
    if (ok) return cp.C > cluster::kPortable ? 4 : 3;
  }
  const panel::DeviceInfo* d = nullptr;
  e = panel::device_info(&d);
  if (e != cudaSuccess) return -(int)e;
  return panel::fits<T>(which == 1 ? panel::kLower : panel::kLowerT, n,
                        d->cap) ? 1 : 2;
}

}  // namespace

extern "C" {

int cholesky_f32(const float* A, float* L, long long nb, int n,
                 void* stream) {
  return launch_cholesky<float>(A, L, nb, n, stream);
}

int cholesky_f64(const double* A, double* L, long long nb, int n,
                 void* stream) {
  return launch_cholesky<double>(A, L, nb, n, stream);
}

int solve_lower_f32(const float* L, const float* B, float* X, long long nb,
                    int n, int K, void* stream) {
  return launch_solve_lower<float>(L, B, X, nb, n, K, stream);
}

int solve_lower_f64(const double* L, const double* B, double* X,
                    long long nb, int n, int K, void* stream) {
  return launch_solve_lower<double>(L, B, X, nb, n, K, stream);
}

int solve_lower_t_f32(const float* L, const float* B, float* X, long long nb,
                      int n, int K, void* stream) {
  return launch_solve_t<float>(L, B, X, nb, n, K, stream);
}

int solve_lower_t_f64(const double* L, const double* B, double* X,
                      long long nb, int n, int K, void* stream) {
  return launch_solve_t<double>(L, B, X, nb, n, K, stream);
}

// The clusters the card holds at once for a solve's first cluster plan
// (fwd: solve_lower's kernel, else solve_lower_t's), from the launchers'
// cache (cached != 0) or asked anew; -1 where no cluster plan applies,
// minus the CUDA error on failure.
int chol_cluster_fit_f32(int fwd, int n, int K, long long nb, int cached) {
  return cluster_fit<float>(fwd, n, K, nb, cached);
}

int chol_cluster_fit_f64(int fwd, int n, int K, long long nb, int cached) {
  return cluster_fit<double>(fwd, n, K, nb, cached);
}

int chol_design_f32(int which, long long nb, int n, int K) {
  return design<float>(which, nb, n, K);
}

int chol_design_f64(int which, long long nb, int n, int K) {
  return design<double>(which, nb, n, K);
}

int chol_max_shared_bytes() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  return v;
}

}  // extern "C"
