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
// that needs the previous step complete: s dependent steps of s^2 entries.
// At the staged KKT's block shapes (s = 145..158, 32..512 blocks) that is
// 2 s^3 flops and 2 s^2 elements of device traffic per block, far under the
// card's rates; the chain of s block-wide barriers bounds it. The design is
// the simple one: one thread block per matrix, the whole matrix in shared
// memory (158^2 doubles are 199,712 bytes, under the 227 KB a block may
// opt into), row j and column j copied aside, one barrier before and one
// after each step's update.
//
// Built with -fmad=false so that every product and difference rounds as
// the plain PyTorch version's separate operations do; kernel and plain
// version then agree bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;

template <typename T>
__device__ __forceinline__ T pivot_recip(T p) {
  // sign(p) / max(|p|, 1e-30); a NaN pivot gives NaN (fails the compare)
  const T a = fabs(p);
  const T tiny = T(1e-30);
  const T mag = a < tiny ? tiny : a;
  return (p < T(0) ? T(-1) : T(1)) / mag;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gj_kernel(const T* __restrict__ Min, T* __restrict__ Mout, int s) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* W = reinterpret_cast<T*>(smem_raw);   // (s, s) row-major
  T* rowj = W + (int64_t)s * s;            // row j, times d
  T* colj = rowj + s;                      // column j

  const int64_t ss = (int64_t)s * s;
  const T* in = Min + blockIdx.x * ss;
  T* out = Mout + blockIdx.x * ss;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int n2 = s * s;

  for (int idx = tid; idx < n2; idx += nt) W[idx] = in[idx];
  __syncthreads();

  for (int j = 0; j < s; ++j) {
    const T d = pivot_recip(W[j * s + j]);
    for (int k = tid; k < s; k += nt) {
      rowj[k] = W[j * s + k] * d;
      colj[k] = W[k * s + j];
    }
    __syncthreads();
    for (int idx = tid; idx < n2; idx += nt) {
      const int i = idx / s;
      const int k = idx - i * s;
      T v;
      if (i == j)
        v = (k == j) ? d : rowj[k];
      else if (k == j)
        v = -colj[i] * d;
      else
        v = W[idx] - colj[i] * rowj[k];
      W[idx] = v;
    }
    __syncthreads();
  }

  for (int idx = tid; idx < n2; idx += nt) out[idx] = W[idx];
}

template <typename T>
size_t gj_smem(int s) {
  return ((size_t)s * s + 2 * (size_t)s) * sizeof(T);
}

template <typename T>
int launch_gj(const T* M, T* out, long long nb, int s, void* stream) {
  const size_t smem = gj_smem<T>(s);
  cudaError_t e = cudaFuncSetAttribute(
      gj_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  gj_kernel<T><<<(unsigned)nb, kThreads, smem, (cudaStream_t)stream>>>(
      M, out, s);
  return (int)cudaGetLastError();
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

int gj_max_shared_bytes() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  return v;
}

}  // extern "C"
