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
// carry over: here one thread block owns one matrix (factor) or one
// (block of RHS columns, matrix) pair (solve).
//
// What bounds them on this card. At the main path's shapes (s = 158 or
// 145, 32..512 matrices, K = 2, 37 or s columns) neither bytes nor flops:
// the factor is s dependent steps of (argmax, swap, rank-1 update), each
// ending in a __syncthreads(), with the whole matrix in shared memory; the
// solve is 2s dependent substitution steps. The solve runs in 32-row
// panels (panel_solve.cuh): three barriers a panel instead of one a row,
// the factor's panels copied coalesced into shared memory one panel ahead
// with cp.async, the diagonal blocks chained by warp shuffles (few
// columns) or in a thread's registers (many), the rows past a panel
// updated in register tiles. The swaps are composed into one permutation
// by every thread at once and applied while loading the RHS. Few columns
// are split over blocks while the card has idle SMs; many go in tiles of
// up to 64 columns, the matrix index slowest, so that a matrix's tiles
// read its factor from L2 together.
//
// Built with -fmad=false so that multiplications and subtractions round
// exactly as the plain PyTorch version's separate operations do; the pivot
// record then agrees with the plain version's bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "panel_solve.cuh"

namespace {

constexpr int kFactorThreads = 512;
using panel::pivot_recip;

template <typename T> __device__ __forceinline__ T pos_inf();
template <> __device__ __forceinline__ float pos_inf<float>() { return __int_as_float(0x7f800000); }
template <> __device__ __forceinline__ double pos_inf<double>() { return __longlong_as_double(0x7ff0000000000000LL); }

template <typename T>
__global__ void __launch_bounds__(kFactorThreads)
lu_factor_kernel(const T* __restrict__ in, T* __restrict__ out,
                 int32_t* __restrict__ perm, int s) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* W = reinterpret_cast<T*>(smem_raw);
  __shared__ int s_piv;

  const int64_t mat = blockIdx.x;
  const T* src = in + mat * (int64_t)s * s;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nt >> 5;

  for (int i = tid; i < s * s; i += nt) W[i] = src[i];
  __syncthreads();

  for (int j = 0; j < s; ++j) {
    // 1. pivot row: first index of the largest |W[i, j]|, i >= j. A NaN
    //    counts as +inf, so the row index always stays in range.
    if (warp == 0) {
      T best = T(-1);
      int bi = s;
      for (int i = j + lane; i < s; i += 32) {
        T a = W[i * s + j];
        T v = (a != a) ? pos_inf<T>() : fabs(a);
        if (v > best) { best = v; bi = i; }
      }
      for (int off = 16; off > 0; off >>= 1) {
        T ob = __shfl_down_sync(0xffffffffu, best, off);
        int oi = __shfl_down_sync(0xffffffffu, bi, off);
        if (ob > best || (ob == best && oi < bi)) { best = ob; bi = oi; }
      }
      if (lane == 0) {
        s_piv = bi;
        perm[mat * s + j] = bi;
      }
    }
    __syncthreads();

    // 2. swap whole rows j and r (LAPACK convention: the stored
    //    multipliers move with their rows)
    const int r = s_piv;
    if (r != j) {
      for (int c = tid; c < s; c += nt) {
        T t = W[j * s + c];
        W[j * s + c] = W[r * s + c];
        W[r * s + c] = t;
      }
      __syncthreads();
    }

    // 3. + 4. multipliers (rows > j) and the rank-1 update of the
    //    trailing block; one warp per row, lanes over columns
    const T d = pivot_recip(W[j * s + j]);
    for (int i = j + 1 + warp; i < s; i += nwarps) {
      const T l = W[i * s + j] * d;
      for (int c = j + 1 + lane; c < s; c += 32) {
        W[i * s + c] = W[i * s + c] - l * W[j * s + c];
      }
      __syncwarp();  // every lane has read W[i, j] before it is replaced
      if (lane == 0) W[i * s + j] = l;
    }
    __syncthreads();
  }

  T* dst = out + mat * (int64_t)s * s;
  for (int i = tid; i < s * s; i += nt) dst[i] = W[i];
}

template <typename T>
int launch_factor(const T* in, T* out, int32_t* perm, long long nb, int s,
                  void* stream) {
  const size_t smem = (size_t)s * s * sizeof(T);
  cudaError_t e = cudaFuncSetAttribute(
      lu_factor_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  lu_factor_kernel<T><<<(unsigned)nb, kFactorThreads, smem,
                        (cudaStream_t)stream>>>(in, out, perm, s);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_solve(const T* F, const int32_t* perm, const T* B, T* X,
                 long long nb, int s, int K, void* stream) {
  const panel::DeviceInfo* d = nullptr;
  cudaError_t e = panel::device_info(&d);
  if (e != cudaSuccess) return (int)e;
  return (int)panel::launch<T, panel::kLU>(F, perm, B, X, nb, s, K, *d,
                                           (cudaStream_t)stream);
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

int lu_solve_f32(const float* F, const int32_t* perm, const float* B,
                 float* X, long long nb, int s, int K, void* stream) {
  return launch_solve<float>(F, perm, B, X, nb, s, K, stream);
}

int lu_solve_f64(const double* F, const int32_t* perm, const double* B,
                 double* X, long long nb, int s, int K, void* stream) {
  return launch_solve<double>(F, perm, B, X, nb, s, K, stream);
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
