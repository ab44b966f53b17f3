// Batched triangular substitution in 32-row panels, for NVIDIA Hopper
// (sm_90a): the design shared by lu_solve (lu_kernels.cu) and the batched
// solve_lower and solve_lower_t (chol_kernels.cu). Included by both
// sources; scptoolbox_torch/ops/cuda_lib.py hashes it with them.
//
// One thread block owns one matrix and a block of kb right-hand-side
// columns. Its rows of X live in shared memory. The rows go in panels of
// 32, forward (top down) or backward (bottom up); a panel's columns of the
// coefficient matrix M (rows past the panel and the diagonal block, each a
// contiguous 32-entry segment of a row of M) are copied into shared memory
// with cp.async, one panel ahead, into two buffers. Per panel, three block
// barriers in all:
// * the diagonal block is solved: for a few columns a warp per column, a
//   lane per row, the steps chained by warp shuffles; for many columns a
//   thread per column, the panel's 32 rows in its registers;
// * every row past the panel takes the panel's solved rows, each entry in
//   a register of a RT x CT register tile, in the substitution's column
//   order.
// So 32 rows cost three barriers where a substitution by rows costs 32,
// and the coefficients are read from device memory once, coalesced, not a
// column at a time with a stride of a row between threads.
//
// The modes:
// * kLU: lu_solve. The rows of B are gathered through the pivot record
//   (its swaps composed into one permutation by every thread at once: each
//   follows one row through the s swaps), then a unit-L forward pass and a
//   U backward pass with the sign-kept 1e-30 pivot floor: x_j = b_j * d_j
//   with d_j = sign(u_jj) / max(|u_jj|, 1e-30), which is also the output
//   row (the plain version scales b by d at the end, the same product).
// * kLower: solve_lower, forward, x_j = b_j / L_jj.
// * kLowerT: solve_lower_t, backward with L' read in place: the panel's
//   columns of L' are rows of L, copied transposed into shared memory.
//
// Bit for bit. Each entry takes the panels' updates in the plain
// substitution's order, one product and one difference at a time (the
// build keeps -fmad=false); divisions and pivot reciprocals are the plain
// version's own operations on the same operands.

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace panel {

constexpr int kW = 32;            // panel rows
constexpr int kLd = kW + 1;       // row stride of a staged panel
constexpr int kMaxThreads = 512;   // a warp per column: up to this
constexpr int kTileThreads = 256;  // register tiles: two blocks an SM
constexpr int kFewCols = 8;       // up to this: a warp per column
constexpr int kTileCols = 64;     // at most this many columns a block

enum Mode { kLU = 0, kLower = 1, kLowerT = 2 };

template <typename T> __device__ __forceinline__ T tiny_pivot();
template <> __device__ __forceinline__ float tiny_pivot<float>() { return 1e-30f; }
template <> __device__ __forceinline__ double tiny_pivot<double>() { return 1e-30; }

// sign(p) / max(|p|, 1e-30), NaN-propagating like the plain version's
// torch.where(a < tiny, tiny, a).
template <typename T>
__device__ __forceinline__ T pivot_recip(T p) {
  T a = fabs(p);
  T mag = (a < tiny_pivot<T>()) ? tiny_pivot<T>() : a;
  return (p < T(0) ? T(-1) : T(1)) / mag;
}

// The panel's diagonal block, a warp per column: lane a holds row p0 + a
// of column cc. D(a, t) is M[p0 + a][p0 + t]. A full panel goes four rows
// a round: the four rows' values reach every lane by four independent
// shuffles, every lane solves the four among themselves (the same
// operations, in the same order, as the rows' own lanes would), and the
// rows past them take the four updates in order: 8 shuffle rounds a panel
// instead of 32. A short panel (the last) goes a row a step.
template <typename T, int kMode, bool kFwd, bool kFull>
__device__ __forceinline__ void diag_lanes(T* Xs, const T* D, int kb, int p0,
                                           int w, int kw, int warp,
                                           int nwarps, int lane) {
  constexpr unsigned kAll = 0xffffffffu;
  constexpr int G = 4;
  // kLU backward: lane a's pivot reciprocal, off the chain
  const T d = (kMode == kLU && !kFwd && lane < w)
                  ? pivot_recip(D[lane * kLd + lane]) : T(0);
  for (int cc = warp; cc < kw; cc += nwarps) {
    T* xc = Xs + (int64_t)p0 * kb + cc;
    T x = (lane < w) ? xc[(int64_t)lane * kb] : T(0);
    if (kFull && kFwd) {
#pragma unroll
      for (int t0 = 0; t0 < kW; t0 += G) {
        T v[G], y[G];
#pragma unroll
        for (int j = 0; j < G; ++j) v[j] = __shfl_sync(kAll, x, t0 + j);
#pragma unroll
        for (int j = 0; j < G; ++j) {
          T u = v[j];
#pragma unroll
          for (int k = 0; k < j; ++k)
            u = u - D[(t0 + j) * kLd + t0 + k] * y[k];
          y[j] = kMode == kLU ? u : u / D[(t0 + j) * kLd + t0 + j];
        }
#pragma unroll
        for (int j = 0; j < G; ++j)
          if (lane == t0 + j) x = y[j];
        if (lane >= t0 + G) {
#pragma unroll
          for (int k = 0; k < G; ++k) x = x - D[lane * kLd + t0 + k] * y[k];
        }
      }
    } else if (kFull) {
#pragma unroll
      for (int t0 = kW - G; t0 >= 0; t0 -= G) {
        T v[G], y[G], dv[G];
#pragma unroll
        for (int j = 0; j < G; ++j) {
          v[j] = __shfl_sync(kAll, x, t0 + j);
          if (kMode == kLU) dv[j] = __shfl_sync(kAll, d, t0 + j);
        }
#pragma unroll
        for (int j = G - 1; j >= 0; --j) {
          T u = v[j];
#pragma unroll
          for (int k = G - 1; k > j; --k)
            u = u - D[(t0 + j) * kLd + t0 + k] * y[k];
          y[j] = kMode == kLU ? u * dv[j] : u / D[(t0 + j) * kLd + t0 + j];
        }
#pragma unroll
        for (int j = 0; j < G; ++j)
          if (lane == t0 + j) x = y[j];
        if (lane < t0) {
#pragma unroll
          for (int k = G - 1; k >= 0; --k)
            x = x - D[lane * kLd + t0 + k] * y[k];
        }
      }
    } else if (kFwd) {
      for (int t = 0; t < w; ++t) {
        T y;
        if (kMode == kLU) {
          y = __shfl_sync(kAll, x, t);
        } else {
          y = (lane == t) ? x / D[t * kLd + t] : T(0);
          y = __shfl_sync(kAll, y, t);
          if (lane == t) x = y;
        }
        if (lane > t) x = x - D[lane * kLd + t] * y;
      }
    } else {
      for (int t = w - 1; t >= 0; --t) {
        T y = (lane == t) ? (kMode == kLU ? x * d : x / D[t * kLd + t])
                          : T(0);
        y = __shfl_sync(kAll, y, t);
        if (lane == t) x = y;
        if (lane < t) x = x - D[lane * kLd + t] * y;
      }
    }
    if (lane < w) xc[(int64_t)lane * kb] = x;
  }
}

// The panel's diagonal block, a thread per column, its rows in registers;
// kFull: the panel has 32 rows (no guard in the unrolled steps).
template <typename T, int kMode, bool kFwd, bool kFull>
__device__ __forceinline__ void diag_regs(T* Xs, const T* D, int kb,
                                          int p0, int w, int kw, int tid,
                                          int nt) {
  for (int c = tid; c < kw; c += nt) {
    T x[kW];
    T* xc = Xs + (int64_t)p0 * kb + c;
#pragma unroll
    for (int r = 0; r < kW; ++r)
      x[r] = (kFull || r < w) ? xc[(int64_t)r * kb] : T(0);
    if (kFwd) {
#pragma unroll
      for (int t = 0; t < kW; ++t) {
        if (kFull || t < w) {
          const T y = kMode == kLU ? x[t] : x[t] / D[t * kLd + t];
          x[t] = y;
#pragma unroll
          for (int a = t + 1; a < kW; ++a) x[a] = x[a] - D[a * kLd + t] * y;
        }
      }
    } else {
#pragma unroll
      for (int t = kW - 1; t >= 0; --t) {
        if (kFull || t < w) {
          const T y = kMode == kLU ? x[t] * pivot_recip(D[t * kLd + t])
                                   : x[t] / D[t * kLd + t];
          x[t] = y;
#pragma unroll
          for (int a = 0; a < t; ++a) x[a] = x[a] - D[a * kLd + t] * y;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kW; ++r)
      if (kFull || r < w) xc[(int64_t)r * kb] = x[r];
  }
}

// The rows past the panel, ib .. ib + nr - 1, take its solved rows: thread
// entry (g, h) keeps rows ib + g + ng p (p < RT) and columns h + hc q
// (q < CT) in registers. Lp(i, t) = Lp[(i - rowoff) * kLd + t] is
// M[i][p0 + t].
template <typename T, bool kFwd, bool kFull, int RT, int CT>
__device__ __forceinline__ void update_rows(T* Xs, const T* Lp, int kb,
                                            int p0, int w, int kw, int ib,
                                            int nr, int rowoff, int tid,
                                            int nt) {
  const int ng = (nr + RT - 1) / RT;
  const int hc = (kw + CT - 1) / CT;
  const T* xp = Xs + (int64_t)p0 * kb;
  for (int e = tid; e < ng * hc; e += nt) {
    const int g = e / hc;
    const int h = e - g * hc;
    int ri[RT], ci[CT];
    T acc[RT][CT];
#pragma unroll
    for (int p = 0; p < RT; ++p) {
      const int r = g + ng * p;
      ri[p] = ib + (r < nr ? r : nr - 1);     // a clamped row is not stored
    }
#pragma unroll
    for (int q = 0; q < CT; ++q) {
      const int c = h + hc * q;
      ci[q] = c < kw ? c : kw - 1;
    }
#pragma unroll
    for (int p = 0; p < RT; ++p) {
#pragma unroll
      for (int q = 0; q < CT; ++q)
        acc[p][q] = Xs[(int64_t)ri[p] * kb + ci[q]];
    }
#pragma unroll
    for (int k = 0; k < kW; ++k) {
      const int t = kFwd ? k : kW - 1 - k;
      if (kFull || t < w) {
        T l[RT], y[CT];
#pragma unroll
        for (int p = 0; p < RT; ++p) l[p] = Lp[(ri[p] - rowoff) * kLd + t];
#pragma unroll
        for (int q = 0; q < CT; ++q) y[q] = xp[(int64_t)t * kb + ci[q]];
#pragma unroll
        for (int p = 0; p < RT; ++p) {
#pragma unroll
          for (int q = 0; q < CT; ++q) acc[p][q] = acc[p][q] - l[p] * y[q];
        }
      }
    }
#pragma unroll
    for (int p = 0; p < RT; ++p) {
#pragma unroll
      for (int q = 0; q < CT; ++q) {
        if (g + ng * p < nr && h + hc * q < kw)
          Xs[(int64_t)ri[p] * kb + ci[q]] = acc[p][q];
      }
    }
  }
}

// X = op(M)^{-1} B for one matrix and columns k0 .. k0 + kb - 1 (grid: column
// blocks x matrices). F is the factor (s, s) row-major; perm the pivot
// record (kLU only). kWarpDiag: a warp per column in the diagonal blocks
// (few columns), else a thread per column.
template <typename T, int kMode, bool kWarpDiag, int RT, int CT>
__global__ void __launch_bounds__(kWarpDiag ? kMaxThreads : kTileThreads,
                                  kWarpDiag ? 1 : 2)
panel_solve_kernel(const T* __restrict__ F, const int32_t* __restrict__ perm,
                   const T* __restrict__ Bm, T* __restrict__ Xm, int s, int K,
                   int kb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int sr = s < kW ? kW : s;
  T* Xs = reinterpret_cast<T*>(smem_raw);                 // (s, kb)
  T* Ls = Xs + (size_t)s * kb;                            // 2 x (sr, kLd)
  int* Pr = reinterpret_cast<int*>(Ls + 2 * (size_t)sr * kLd);   // kLU
  int* Pp = Pr + s;

  const int64_t mat = blockIdx.y;
  const int k0 = blockIdx.x * kb;
  const int kw = min(kb, K - k0);
  const T* Fm = F + mat * (int64_t)s * s;
  const T* B = Bm + mat * (int64_t)s * K + k0;
  T* X = Xm + mat * (int64_t)s * K + k0;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nt >> 5;
  const int np = (s + kW - 1) / kW;
  const int nsteps = kMode == kLU ? 2 * np : np;

  // step g: its panel and direction
  auto panel_of = [&](int g, bool* fwd) {
    *fwd = kMode == kLower || (kMode == kLU && g < np);
    const int gb = kMode == kLU ? g - np : g;
    return *fwd ? g : np - 1 - gb;
  };
  // one cp.async group: step g's panel, Ls[buf][i - rowoff][t] =
  // M[i][p0 + t] for its rows i (forward: p0 .. s-1, backward: 0 .. p0+w-1);
  // a warp copies a 32-entry segment of a row of F an instruction
  auto stage = [&](int g, int buf) {
    bool fwd;
    const int p0 = kW * panel_of(g, &fwd);
    const int w = min(kW, s - p0);
    const int i0 = fwd ? p0 : 0;
    const int R = fwd ? s - p0 : p0 + w;
    T* dst = Ls + (size_t)buf * sr * kLd;
    if (kMode == kLowerT) {      // M[i][j] = L[j][i]: rows of L, transposed
      for (int t = warp; t < w; t += nwarps) {
        const T* src = Fm + (int64_t)(p0 + t) * s + i0;
        for (int r = lane; r < R; r += 32)
          __pipeline_memcpy_async(dst + r * kLd + t, src + r, sizeof(T));
      }
    } else if (lane < w) {
      const T* src = Fm + (int64_t)i0 * s + p0 + lane;
      for (int r = warp; r < R; r += nwarps)
        __pipeline_memcpy_async(dst + r * kLd + lane, src + (int64_t)r * s,
                                sizeof(T));
    }
    __pipeline_commit();
  };

  stage(0, 0);
  if (kMode == kLU) {
    for (int i = tid; i < s; i += nt) Pr[i] = perm[mat * s + i];
    __syncthreads();
    // the recorded swaps (laswp order) composed: row k's final place
    for (int k = tid; k < s; k += nt) {
      int pos = k;
#pragma unroll 8
      for (int j = 0; j < s; ++j) {
        const int r = Pr[j];
        pos = pos == j ? r : (pos == r ? j : pos);
      }
      Pp[pos] = k;
    }
    __syncthreads();
  }
  for (int idx = tid; idx < s * kw; idx += nt) {
    const int i = idx / kw;
    const int c = idx - i * kw;
    const int src = kMode == kLU ? Pp[i] : i;
    Xs[(int64_t)i * kb + c] = B[(int64_t)src * K + c];
  }

  for (int g = 0; g < nsteps; ++g) {
    if (g + 1 < nsteps)
      stage(g + 1, (g + 1) & 1);
    else
      __pipeline_commit();
    __pipeline_wait_prior(1);     // this thread's copies of step g
    __syncthreads();              // everyone's, and X's rows
    bool fwd;
    const int p0 = kW * panel_of(g, &fwd);
    const int w = min(kW, s - p0);
    const int rowoff = fwd ? p0 : 0;
    const T* Lp = Ls + (size_t)(g & 1) * sr * kLd;
    const T* D = Lp + (p0 - rowoff) * kLd;      // rows p0 .. p0+w-1
    const bool full = w == kW;
    if (kWarpDiag) {
      if (fwd && full)
        diag_lanes<T, kMode, true, true>(Xs, D, kb, p0, w, kw, warp, nwarps,
                                         lane);
      else if (fwd)
        diag_lanes<T, kMode, true, false>(Xs, D, kb, p0, w, kw, warp, nwarps,
                                          lane);
      else if (full)
        diag_lanes<T, kMode, false, true>(Xs, D, kb, p0, w, kw, warp,
                                          nwarps, lane);
      else
        diag_lanes<T, kMode, false, false>(Xs, D, kb, p0, w, kw, warp,
                                           nwarps, lane);
    } else if (fwd) {
      if (full)
        diag_regs<T, kMode, true, true>(Xs, D, kb, p0, w, kw, tid, nt);
      else
        diag_regs<T, kMode, true, false>(Xs, D, kb, p0, w, kw, tid, nt);
    } else {
      if (full)
        diag_regs<T, kMode, false, true>(Xs, D, kb, p0, w, kw, tid, nt);
      else
        diag_regs<T, kMode, false, false>(Xs, D, kb, p0, w, kw, tid, nt);
    }
    __syncthreads();
    const int ib = fwd ? p0 + w : 0;
    const int nr = fwd ? s - p0 - w : p0;
    if (nr > 0) {
      if (fwd) {
        if (full)
          update_rows<T, true, true, RT, CT>(Xs, Lp, kb, p0, w, kw, ib, nr,
                                             rowoff, tid, nt);
        else
          update_rows<T, true, false, RT, CT>(Xs, Lp, kb, p0, w, kw, ib, nr,
                                              rowoff, tid, nt);
      } else {
        if (full)
          update_rows<T, false, true, RT, CT>(Xs, Lp, kb, p0, w, kw, ib, nr,
                                              rowoff, tid, nt);
        else
          update_rows<T, false, false, RT, CT>(Xs, Lp, kb, p0, w, kw, ib,
                                               nr, rowoff, tid, nt);
      }
    }
    __syncthreads();              // step g's buffer is free again
  }

  for (int idx = tid; idx < s * kw; idx += nt) {
    const int i = idx / kw;
    const int c = idx - i * kw;
    X[(int64_t)i * K + c] = Xs[(int64_t)i * kb + c];
  }
}

// What the launchers read on every call, queried once per device (a query
// per launch costs the host more than a small kernel takes on the card).
constexpr int kMaxDevices = 64;

struct DeviceInfo {
  int dev, cap, sms, coop;
  bool ready;
};

inline cudaError_t device_info(const DeviceInfo** out) {
  static DeviceInfo info[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  DeviceInfo& d = info[dev];
  if (!d.ready) {
    e = cudaDeviceGetAttribute(&d.cap,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&d.coop, cudaDevAttrCooperativeLaunch, dev);
    if (e != cudaSuccess) return e;
    d.dev = dev;
    d.ready = true;
  }
  *out = &d;
  return cudaSuccess;
}

// The block plan of a launch: columns a block, threads, shared memory.
// Up to kFewCols columns a block take a warp each in the diagonal blocks
// and one thread per entry of the rows past the first panel; more take a
// thread each in the diagonal blocks and 4 x 4 register tiles, at most 256
// threads, so that two blocks share an SM and one's diagonal block runs
// beside the other's tiles.
struct Plan {
  int kb, threads;
  bool few;
  size_t smem;
};

inline Plan make_plan(int mode, size_t esize, int s, int kb) {
  Plan p;
  p.kb = kb;
  p.few = kb <= kFewCols;
  const int rows = s > kW ? s - kW : 1;
  int work = p.few ? rows * kb : ((rows + 3) / 4) * ((kb + 3) / 4);
  work = (work > kb ? work : kb) + 31;
  work -= work % 32;
  const int most = p.few ? kMaxThreads : kTileThreads;
  p.threads = work < 64 ? 64 : (work > most ? most : work);
  const size_t n = (size_t)s * kb + 2 * (size_t)(s < kW ? kW : s) * kLd;
  p.smem = n * esize + (mode == kLU ? 2 * (size_t)s * sizeof(int) : 0);
  return p;
}

// Columns a block: up to kFewCols, all of them, halved while that leaves
// SMs idle; more, in tiles of up to kTileCols, narrower (down to 16) while
// the tiles leave SMs idle.
inline int block_cols(long long nb, int K, int sms) {
  if (K <= kFewCols) {
    int kb = K;
    while (kb > 1 && nb * ((K + kb - 1) / kb) < sms) kb = (kb + 1) / 2;
    return kb;
  }
  int tiles = (K + kTileCols - 1) / kTileCols;
  int kb = (K + tiles - 1) / tiles;
  while (nb * tiles < sms && kb > 16) {
    ++tiles;
    kb = (K + tiles - 1) / tiles;
  }
  return kb;
}

// One kernel instance's launch; it may use all of a block's shared memory,
// set once per device.
template <typename T, int kMode, bool kWarpDiag, int RT, int CT>
cudaError_t run(const Plan& p, const DeviceInfo& d, const T* F,
                const int32_t* perm, const T* B, T* X, long long nb, int s,
                int K, cudaStream_t stream) {
  static bool ready[kMaxDevices];
  auto kern = panel_solve_kernel<T, kMode, kWarpDiag, RT, CT>;
  if (!ready[d.dev]) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, d.cap);
    if (e != cudaSuccess) return e;
    ready[d.dev] = true;
  }
  const dim3 grid((unsigned)((K + p.kb - 1) / p.kb), (unsigned)nb);
  kern<<<grid, p.threads, p.smem, stream>>>(F, perm, B, X, s, K, p.kb);
  return cudaGetLastError();
}

// Launch with the plan, narrower while its shared memory does not fit;
// cudaErrorInvalidValue when not even one column fits.
template <typename T, int kMode>
cudaError_t launch(const T* F, const int32_t* perm, const T* B, T* X,
                   long long nb, int s, int K, const DeviceInfo& d,
                   cudaStream_t stream) {
  Plan p = make_plan(kMode, sizeof(T), s, block_cols(nb, K, d.sms));
  while (p.smem > (size_t)d.cap && p.kb > 1)
    p = make_plan(kMode, sizeof(T), s, (p.kb + 1) / 2);
  if (p.smem > (size_t)d.cap) return cudaErrorInvalidValue;
  return p.few ? run<T, kMode, true, 1, 1>(p, d, F, perm, B, X, nb, s, K,
                                           stream)
               : run<T, kMode, false, 4, 4>(p, d, F, perm, B, X, nb, s, K,
                                            stream);
}

// Whether one column's plan fits in cap bytes of shared memory.
template <typename T>
inline bool fits(int mode, int s, int cap) {
  return make_plan(mode, sizeof(T), s, 1).smem <= (size_t)cap;
}

}  // namespace panel
