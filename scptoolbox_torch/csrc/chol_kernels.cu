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
// __syncthreads(). The matrices do not fit in shared memory (876^2 doubles
// are 6.1 MB, 314^2 floats 394 KB, against 227 KB a block), so one thread
// block owns one matrix (factor) or one (matrix, block of RHS columns) pair
// (solves) and works on it in device memory, where the 50 MB L2 cache holds
// it. Both are blocked in panels of columns kept in shared memory, which cuts
// the block barriers from one or two per column to two per column of the
// panel factor (factor) or two per panel (solves, whose diagonal blocks are
// chained by warp shuffles), and makes the factor read and write each
// trailing entry once per panel instead of once per column.
//
// Built with -fmad=false so that every product and difference rounds as the
// plain PyTorch version's separate operations do; kernel and plain version
// then agree bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kFactorThreads = 512;
constexpr int kMaxPanel = 32;
constexpr int kSolveThreads = 512;
constexpr int kSolveCols = 32;
constexpr int kPanel = 32;
constexpr int kTargetBlocks = 132;  // SMs of an H100 SXM

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

template <typename T>
int launch_cholesky(const T* A, T* L, long long nb, int n, void* stream) {
  int dev = 0, cap = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&cap, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e != cudaSuccess) return (int)e;
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

template <typename T, bool kForward>
int launch_solve(const T* L, const T* B, T* X, long long nb, int n, int K,
                 void* stream) {
  const int kb = solve_cols(nb, K);
  dim3 grid((unsigned)nb, (unsigned)((K + kb - 1) / kb));
  tri_solve_kernel<T, kForward><<<grid, kSolveThreads, 0,
                                  (cudaStream_t)stream>>>(L, B, X, n, K, kb);
  return (int)cudaGetLastError();
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
  return launch_solve<float, true>(L, B, X, nb, n, K, stream);
}

int solve_lower_f64(const double* L, const double* B, double* X,
                    long long nb, int n, int K, void* stream) {
  return launch_solve<double, true>(L, B, X, nb, n, K, stream);
}

int solve_lower_t_f32(const float* L, const float* B, float* X, long long nb,
                      int n, int K, void* stream) {
  return launch_solve<float, false>(L, B, X, nb, n, K, stream);
}

int solve_lower_t_f64(const double* L, const double* B, double* X,
                      long long nb, int n, int K, void* stream) {
  return launch_solve<double, false>(L, B, X, nb, n, K, stream);
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
