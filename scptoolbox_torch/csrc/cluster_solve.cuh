// Triangular substitution of a few matrices on thread-block clusters, for
// NVIDIA Hopper (sm_90a): the design of lu_solve (lu_kernels.cu) where the
// panel design's two staged panels of the factor do not fit in one block's
// shared memory (float64 above s = 427, float32 above 842: the softplus
// quadrotor's 694-wide arrow), and of solve_lower_t (chol_kernels.cu)
// where the cluster plan of chol_kernels.cu does not fit in shared memory
// or would give a cluster more than 16 columns (the free-flyer's
// 1593-wide float64 factor at K = 403). Included by both sources;
// scptoolbox_torch/ops/cuda_lib.py hashes it with them.
//
// What bounds it. One matrix, few right-hand-side columns: the chain of
// 32-row panels, each a diagonal block solved in dependent steps (2 s of
// them for lu_solve); the bytes (the factor read once) take microseconds.
// Many columns: the n^2 K / 2 products of the rows past the panels,
// spread over the SMs, and the diagonal blocks' chains of divisions.
//
// The design. A cluster of C blocks (8, the portable size; 16 where the
// blocks of 8 do not hold their rows) owns one matrix and kc right-hand-
// side columns; as many clusters a matrix as the card holds at once share
// its columns. The 32-row panels are dealt round-robin over the cluster's
// blocks, and each block keeps its panels' rows of X in shared memory. Per
// panel, in the substitution's order: its owner solves the diagonal block
// and writes the solved rows into every block's shared memory
// (distributed shared memory); one cluster barrier; every block applies
// them to its own rows past the panel. The owner of the next panel brings
// that panel's rows up to date first and solves it before it updates its
// other rows, so that the chain from panel to panel passes 32 rows of one
// block. Each block's coefficients of a step (32-entry segments of the
// factor's rows, a warp an instruction: lu_solve's from the block's own
// rows, solve_lower_t's from the panel's rows of L at the block's
// columns) and, on the owner, the diagonal block are copied into shared
// memory with cp.async two steps ahead (one where three staged steps do
// not fit in shared memory), issued between the barrier's arrive and its
// wait; the factor does not change, so the copies need no barrier of their
// own. The factor is thus read from device memory coalesced, once a pass,
// by the cluster's SMs together. A few columns take a warp each in the
// diagonal blocks (lanes as rows) and a thread an entry past them; 16 or
// more take a thread a column in the diagonal blocks (on four warps, so
// that a column's 32 divisions are done once and not on every lane) and
// 4 x 4 register tiles past them.
//
// The modes (panel::Mode):
// * kLowerT: L' X = B, backward, L read in place (its panels counted from
//   the bottom, so that the short one is the last), x_j = b_j / L_jj.
// * kLU: lu_solve. Every block gathers its rows of B through the pivot
//   record (each thread follows one row back through the recorded swaps,
//   only the swaps at or above it), then a unit-L forward pass and a U
//   backward pass over the same 32-row panels from the top: x_j = b_j d_j
//   with d_j = sign(u_jj) / max(|u_jj|, 1e-30), which is also the output
//   row (the plain version scales by d at the end, the same product).
//
// Bit for bit. Each entry takes its updates in the plain substitution's
// order, one product and one difference at a time (the build keeps
// -fmad=false); divisions and pivot reciprocals are the plain version's
// own operations on the same operands.

#pragma once

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "panel_solve.cuh"

namespace cluster {

namespace cg = cooperative_groups;
using panel::kLowerT;
using panel::kLU;

constexpr int kW = 32;          // panel rows
constexpr int kThreads = 512;
constexpr int kPortable = 8;    // blocks of a cluster, portable
constexpr int kWide = 16;       // Hopper's non-portable cluster
constexpr int kMaxCols = 64;    // columns a cluster, at most

// One column of a panel's diagonal block on one warp, lane r holding row
// lo + r in x, with dd[s * 33 + r] the coefficient of x_s in row r
// (kLowerT: L[lo + s][lo + r]; else M[lo + r][lo + s]). At each step s
// (backward from the bottom, forward from the top) lane s solves its row:
// divided by the diagonal (kLowerT), unit (kLU forward) or times
// the pivot's floored reciprocal (kLU backward, each lane's taken first,
// off the chain). The value reaches every lane by shuffle, and the lanes
// still to solve subtract their coefficient times it. A full panel goes
// four rows a round: their values reach every lane by four independent
// shuffles, every lane solves the four among themselves (the operations
// of the rows' own lanes, in their order), and the rows past them take the
// four updates in order.
template <typename T, int kMode, bool kFwd>
__device__ __forceinline__ T solve_lanes(T x, const T* dd, int w, int lane) {
  constexpr int G = 4;
  constexpr int S = kW + 1;
  constexpr bool kRecip = kMode == kLU && !kFwd;
  const T d = (kRecip && lane < w) ? panel::pivot_recip(dd[lane * S + lane])
                                   : T(0);
  if (w == kW) {
#pragma unroll
    for (int g = 0; g < kW; g += G) {
      const int t0 = kFwd ? g : kW - G - g;
      T v[G], y[G], dv[G];
#pragma unroll
      for (int j = 0; j < G; ++j) {
        v[j] = __shfl_sync(0xffffffffu, x, t0 + j);
        if (kRecip) dv[j] = __shfl_sync(0xffffffffu, d, t0 + j);
      }
#pragma unroll
      for (int jj = 0; jj < G; ++jj) {
        const int j = kFwd ? jj : G - 1 - jj;
        T u = v[j];
#pragma unroll
        for (int kk = 0; kk < jj; ++kk) {
          const int k = kFwd ? kk : G - 1 - kk;
          u = u - dd[(t0 + k) * S + t0 + j] * y[k];
        }
        y[j] = kMode != kLU ? u / dd[(t0 + j) * S + t0 + j]
               : kFwd       ? u
                            : u * dv[j];
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
    T y = (lane == s) ? (kMode != kLU ? x / lsr : kFwd ? x : x * d) : T(0);
    y = __shfl_sync(0xffffffffu, y, s);
    if (lane == s) x = y;
    if (kFwd ? lane > s : lane < s) x = x - lsr * y;
  }
  return x;
}

// kw columns of a full panel's diagonal block (Xs[c * xs + t0 + r], row
// r of column c), a thread a column with the panel's 32 rows in its
// registers, on four warps (one a scheduler) of up to 16 columns each:
// the same steps as solve_lanes, each row's updates in the substitution's
// order, with a column's division done once and not on every lane.
template <typename T, int kMode, bool kFwd>
__device__ __forceinline__ void solve_regs(T* Xs, int xs, int t0,
                                           const T* dd, int kw, int warp,
                                           int lane) {
  constexpr int S = kW + 1;
  const int per = (kw + 3) / 4;
  if (warp >= 4 || lane >= per || warp * per + lane >= kw) return;
  T* xc = Xs + (int64_t)(warp * per + lane) * xs + t0;
  T x[kW];
#pragma unroll
  for (int r = 0; r < kW; ++r) x[r] = xc[r];
#pragma unroll
  for (int k = 0; k < kW; ++k) {
    const int s = kFwd ? k : kW - 1 - k;
    const T y = kMode != kLU ? x[s] / dd[s * S + s]
                : kFwd       ? x[s]
                             : x[s] * panel::pivot_recip(dd[s * S + s]);
    x[s] = y;
#pragma unroll
    for (int r = 0; r < kW; ++r) {
      if (kFwd ? r > s : r < s) x[r] = x[r] - dd[s * S + r] * y;
    }
  }
#pragma unroll
  for (int r = 0; r < kW; ++r) xc[r] = x[r];
}

// Local rows ta .. ta + na - 1 of a block's X (Xs[c * xs + t]), columns 0
// .. kw - 1, take a step's w solved rows y_s = yq[s * kc + c] with the
// coefficients c_st = ls[s * ss + t * ts], in the substitution's order
// (fwd: s = 0 .. w - 1; else from w - 1 down). Thread e keeps rows ta + g +
// ng p (p < RT) and columns h + hc q (q < CT) in a 4 x 4 register tile,
// each entry one product and one difference a step; valid(t) is false for
// rows past a short last panel, which are not stored.
template <typename T, typename Valid>
__device__ __forceinline__ void update_tiles(T* Xs, int xs, const T* ls,
                                            int ss, int ts, const T* yq,
                                            int kc, int w, bool fwd, int ta,
                                            int na, int kw, int tid, int nt,
                                            Valid valid) {
  constexpr int RT = 4, CT = 4;
  const int ng = (na + RT - 1) / RT;
  const int hc = (kw + CT - 1) / CT;
  for (int e = tid; e < ng * hc; e += nt) {
    const int h = e / ng;
    const int g = e - h * ng;
    int ti[RT], ci[CT];
#pragma unroll
    for (int p = 0; p < RT; ++p) {
      const int r = g + ng * p;
      ti[p] = ta + (r < na ? r : na - 1);    // a clamped row is not stored
    }
#pragma unroll
    for (int q = 0; q < CT; ++q) {
      const int c = h + hc * q;
      ci[q] = c < kw ? c : kw - 1;
    }
    T acc[RT][CT];
#pragma unroll
    for (int p = 0; p < RT; ++p) {
#pragma unroll
      for (int q = 0; q < CT; ++q)
        acc[p][q] = Xs[(int64_t)ci[q] * xs + ti[p]];
    }
    for (int k = 0; k < w; ++k) {
      const int s = fwd ? k : w - 1 - k;
      T l[RT], y[CT];
#pragma unroll
      for (int p = 0; p < RT; ++p) l[p] = ls[s * ss + ti[p] * ts];
#pragma unroll
      for (int q = 0; q < CT; ++q) y[q] = yq[s * kc + ci[q]];
#pragma unroll
      for (int p = 0; p < RT; ++p) {
#pragma unroll
        for (int q = 0; q < CT; ++q) acc[p][q] = acc[p][q] - l[p] * y[q];
      }
    }
#pragma unroll
    for (int p = 0; p < RT; ++p) {
#pragma unroll
      for (int q = 0; q < CT; ++q) {
        if (g + ng * p < na && h + hc * q < kw && valid(ti[p]))
          Xs[(int64_t)ci[q] * xs + ti[p]] = acc[p][q];
      }
    }
  }
}

// op(M) X = B for one matrix and kc right-hand-side columns on one cluster
// of C blocks (grid: C * column groups by nb). Step g of the substitution
// solves panel p (kLowerT: p = g; kLU: p = g forward for g < np, then p
// = 2 np - 1 - g backward). Panels: kLU from the top, lo = 32 p, hi =
// min(lo + 32, n); kLowerT from the bottom, hi = n - 32 p, lo = max(hi -
// 32, 0). Panel p belongs to block p % C, which keeps it as its
// local panel p / C: local row t = 32 (p / C) + r is row lo + r. perm: the
// pivot record (kLU). Shared memory (T): Xs[kc][rows + 1] (the block's
// rows of X), and nbuf buffers (3, or 2 where three do not fit) of each
// step's data, by g % nbuf: Ls (a step's coefficients at the block's rows:
// kLowerT [32][rows], c_st = L[lo + s][row t]; else [rows][33], c_st =
// M[row t][lo + s]), Ds ([32][33], a step's diagonal block, on its owner)
// and xs ([32][kc], a step's solved rows, written by its owner into every
// block of the cluster).
template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads)
solve_cluster_kernel(const T* __restrict__ Lm,
                     const int32_t* __restrict__ perm,
                     const T* __restrict__ Bm, T* __restrict__ Xm, int n,
                     int K, int kc, int rows, int nbuf) {
  constexpr bool kRowSeg = kMode == kLU;       // c_st along row t of M
  constexpr int kD = kW * (kW + 1);            // a staged diagonal block
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int xstride = rows + 1;  // odd: a warp's columns fall in other banks
  // a coefficient c_st of a staged step: Ls[buf][s * ss + t * ts]
  const int ss = kRowSeg ? 1 : rows;
  const int ts = kRowSeg ? kW + 1 : 1;
  const int lsz = rows * (kRowSeg ? kW + 1 : kW);
  T* Xs = reinterpret_cast<T*>(smem_raw);
  T* Ls = Xs + (int64_t)kc * xstride;
  T* Ds = Ls + nbuf * lsz;
  T* xs = Ds + nbuf * kD;

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
  const int nsteps = kMode == kLU ? 2 * np : np;
  const int nu = rank < np ? (np - 1 - rank) / C + 1 : 0;   // local panels
  const int nrows = kW * nu;

  // step g's buffers
  auto slot = [&](int g) { return nbuf == 3 ? g % 3 : g & 1; };
  // step g: its panel and direction
  auto panel_of = [&](int g, bool* fwd) {
    *fwd = kMode == kLU && g < np;
    return kMode == kLU && g >= np ? 2 * np - 1 - g : g;
  };
  // panel p's rows lo .. hi - 1
  auto bounds = [&](int p, int* lo, int* hi) {
    if (kMode == kLU) {
      *lo = kW * p;
      *hi = min(*lo + kW, n);
    } else {
      *hi = n - kW * p;
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
  auto valid = [&](int t) { return row_of(t) >= 0; };
  // this block's local rows ta .. tb - 1 past step g's panel (in the
  // step's direction): the rows that take its update
  auto range = [&](int g, int* ta, int* tb) {
    bool fwd;
    const int p = panel_of(g, &fwd);
    if (kMode != kLU || fwd) {
      *ta = p >= rank ? kW * ((p - rank) / C + 1) : 0;
      *tb = nrows;
    } else {
      *ta = 0;
      *tb = p > rank ? kW * ((p - rank - 1) / C + 1) : 0;
    }
  };
  // cp.async copies of step gc's coefficients at this block's rows past its
  // panel into Ls[slot(gc)] and, on its owner, of step gd's diagonal block
  // into Ds[slot(gd)] (either skipped past the last step or below 0). A
  // warp copies 32 consecutive entries of a row of the factor an
  // instruction.
  auto stage = [&](int gc, int gd) {
    bool fwd;
    int lo, hi, ta, tb;
    if (gc >= 0 && gc < nsteps) {
      bounds(panel_of(gc, &fwd), &lo, &hi);
      range(gc, &ta, &tb);
      const int w = hi - lo;
      const int na = tb - ta;
      T* dst = Ls + slot(gc) * lsz;
      if (kRowSeg) {              // a segment of one of the block's rows
        for (int t = ta + warp; t < tb; t += nwarps) {
          const int i = row_of(t);
          if (i >= 0 && lane < w)
            __pipeline_memcpy_async(dst + lane + t * ts,
                                    L + (int64_t)i * n + lo + lane,
                                    sizeof(T));
        }
      } else {                    // a row of L at one of its local panels
        const int nup = na / kW;
        for (int e = warp; e < w * nup; e += nwarps) {
          const int s = e / nup;
          const int t = ta + kW * (e - s * nup) + lane;
          const int i = row_of(t);
          if (i >= 0)
            __pipeline_memcpy_async(dst + s * ss + t,
                                    L + (int64_t)(lo + s) * n + i,
                                    sizeof(T));
        }
      }
    }
    const int p = gd >= 0 && gd < nsteps ? panel_of(gd, &fwd) : -1;
    if (p >= 0 && p % C == rank) {
      bounds(p, &lo, &hi);
      const int w = hi - lo;
      T* dd = Ds + slot(gd) * kD;
      for (int idx = tid; idx < w * w; idx += nt) {
        const int a = idx / w;
        const int b = idx - a * w;   // along a row of the factor
        __pipeline_memcpy_async(
            kRowSeg ? dd + b * (kW + 1) + a : dd + a * (kW + 1) + b,
            L + (int64_t)(lo + a) * n + lo + b, sizeof(T));
      }
    }
  };

  // this block's local rows ta .. tb-1 (all past step g's panel) take its
  // solved rows, in the substitution's order: a thread an entry, or with
  // many columns 4 x 4 register tiles
  auto update = [&](int g, int ta, int tb, bool tiles) {
    bool fwd;
    int lo, hi;
    bounds(panel_of(g, &fwd), &lo, &hi);
    const int w = hi - lo;
    const T* ls = Ls + slot(g) * lsz;
    const T* yq = xs + slot(g) * kW * kc;
    const int na = tb - ta;
    if (tiles) {
      update_tiles<T>(Xs, xstride, ls, ss, ts, yq, kc, w, fwd, ta, na, kw,
                      tid, nt, valid);
      return;
    }
    for (int idx = tid; idx < na * kw; idx += nt) {
      const int cc = idx / na;
      const int t = ta + idx - cc * na;
      if (row_of(t) < 0) continue;
      T v = Xs[(int64_t)cc * xstride + t];
      for (int k = 0; k < w; ++k) {
        const int s = fwd ? k : w - 1 - k;
        v = v - ls[s * ss + t * ts] * yq[s * kc + cc];
      }
      Xs[(int64_t)cc * xstride + t] = v;
    }
  };
  const bool tiles = kw >= 16;

  // column c of step g's diagonal block on this warp, lanes as rows
  auto lanes = [&](int c, int t0, int w, bool fwd, const T* dd) {
    T* xc = Xs + (int64_t)c * xstride + t0;
    T x = lane < w ? xc[lane] : T(0);
    if constexpr (kMode == kLowerT)
      x = solve_lanes<T, kMode, false>(x, dd, w, lane);
    else
      x = fwd ? solve_lanes<T, kMode, true>(x, dd, w, lane)
              : solve_lanes<T, kMode, false>(x, dd, w, lane);
    if (lane < w) xc[lane] = x;
  };

  // step g's owner: bring the panel's rows up to date with step g - 1's
  // solved rows (if prev), solve its diagonal block (a warp a column; many
  // columns of a full panel a thread a column, on four warps), then write
  // the solved rows to X (not kLU's forward pass) and into xs[g % 2] of
  // every block of the cluster.
  auto solve_panel = [&](int g, bool prev) {
    bool fwd;
    const int p = panel_of(g, &fwd);
    int lo, hi;
    bounds(p, &lo, &hi);
    const int w = hi - lo;
    const T* dd = Ds + slot(g) * kD;
    const int t0 = kW * (p / C);
    if (prev) {
      update(g - 1, t0, t0 + kW, false);
      __syncthreads();
    }
    if (tiles && w == kW) {
      if constexpr (kMode == kLU) {
        if (fwd) solve_regs<T, kMode, true>(Xs, xstride, t0, dd, kw, warp,
                                            lane);
      }
      if (!fwd) solve_regs<T, kMode, false>(Xs, xstride, t0, dd, kw, warp,
                                            lane);
    } else {
      for (int c0 = warp; c0 < kw; c0 += nwarps)
        lanes(c0, t0, w, fwd, dd);
    }
    __syncthreads();
    T* xo = xs + slot(g) * kW * kc;
    const bool out = kMode != kLU || !fwd;
    for (int idx = tid; idx < w * kw; idx += nt) {
      const int r = idx / kw;
      const int c = idx - r * kw;
      const T v = Xs[(int64_t)c * xstride + t0 + r];
      if (out) X[(int64_t)(lo + r) * K + c] = v;
      for (int b = 0; b < C; ++b)
        cluster.map_shared_rank(xo, b)[r * kc + c] = v;
    }
  };

  if (kMode == kLU) {
    // the pivot record, in the first coefficient buffer (free until the
    // first copies); row i of X is row src of B: the recorded swaps composed,
    // last first (LAPACK laswp order backwards). A swap (j, r_j >= j) with
    // j above i never reaches i, so a row's walk starts at its own step.
    int* Pr = reinterpret_cast<int*>(Ls);
    for (int i = tid; i < n; i += nt) Pr[i] = perm[mat * n + i];
    __syncthreads();
    for (int t = tid; t < nrows; t += nt) {
      const int i = row_of(t);
      if (i < 0) continue;
      int src = i;
#pragma unroll 4
      for (int j = i; j >= 0; --j) {
        const int r = Pr[j];
        src = src == j ? r : (src == r ? j : src);
      }
      for (int cc = 0; cc < kw; ++cc)
        Xs[(int64_t)cc * xstride + t] = B[(int64_t)src * K + cc];
    }
  } else {
    for (int idx = tid; idx < kw * nrows; idx += nt) {
      const int cc = idx / nrows;
      const int t = idx - cc * nrows;
      const int i = row_of(t);
      if (i >= 0) Xs[(int64_t)cc * xstride + t] = B[(int64_t)i * K + cc];
    }
  }
  cluster.sync();                 // every block runs: its xs may be written
  // The copies run nbuf - 1 steps ahead, one cp.async group a step: group
  // g holds step g's coefficients and step g + 1's diagonal block (group 0
  // also step 0's).
  const int lead = nbuf - 1;
  for (int j = 0; j < lead; ++j) {
    stage(j, j == 0 ? 0 : -1);
    stage(-1, j + 1);
    __pipeline_commit();
  }

  // Per step g, one cluster barrier, split: the copies for the steps ahead
  // are issued between its arrive and its wait. After it, the owner of
  // step g + 1 first brings that panel's rows up to date, solves and
  // publishes it, and only then updates its other rows: the chain from
  // panel to panel passes one block's 32 rows, not all of them. (Before
  // step 0, rank 0 solves panel 0.)
  for (int g = -1; g < nsteps; ++g) {
    int ta = 0, tb = 0;
    if (g >= 0) {
      __syncthreads();            // this block is done with step g - 1
      asm volatile("barrier.cluster.arrive.release;" ::: "memory");
      stage(g + lead, g + lead + 1);
      __pipeline_commit();
      asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
      range(g, &ta, &tb);
    }
    // this thread's copies of group max(g, 0), then everyone's
    const int pending = g < 0 ? lead - 1 : lead;
    if (pending == 2)
      __pipeline_wait_prior(2);
    else if (pending == 1)
      __pipeline_wait_prior(1);
    else
      __pipeline_wait_prior(0);
    __syncthreads();
    bool f1;
    const int p1 = g + 1 < nsteps ? panel_of(g + 1, &f1) : -1;
    if (p1 >= 0 && p1 % C == rank) {
      // kLU's first backward step solves the panel its last forward step
      // solved: no update of the step before applies to it
      const bool prev = g >= 0 && !(kMode == kLU && g + 1 == np);
      solve_panel(g + 1, prev);   // its rows come first
      if (prev) {                 // they lie at one end of the range
        if (kW * (p1 / C) == ta)
          ta += kW;
        else
          tb -= kW;
      }
    }
    if (g >= 0) update(g, ta, tb, tiles);
  }
}

// The block plan of a cluster launch: C blocks a cluster, kc columns a
// cluster, rows per block, threads, staged steps (nbuf: three where they
// fit in shared memory, so that the copies run two steps ahead, else two)
// and shared memory.
struct Plan {
  int C, kc, rows, threads, nbuf;
  size_t smem;
};

inline Plan make_plan(int mode, size_t esize, int n, int C, int kc,
                      int cap) {
  Plan p;
  p.C = C;
  p.kc = kc;
  p.rows = kW * ((n + kW * C - 1) / (kW * C));
  const size_t ls = (size_t)(mode != kLowerT ? kW + 1 : kW) * p.rows;
  const size_t fixed = (size_t)kc * (p.rows + 1);
  const size_t step = ls + kW * (kW + 1) + (size_t)kW * kc;
  p.nbuf = (fixed + 3 * step) * esize <= (size_t)cap ? 3 : 2;
  p.smem = (fixed + p.nbuf * step) * esize;
  // a warp a column, at least four (the copies issue faster) and at most
  // 16, which many columns (16 or more) take
  const int t = 32 * kc;
  p.threads = t < 128 ? 128 : (t > kThreads ? kThreads : t);
  return p;
}

// The columns a cluster for `per` clusters a matrix.
inline int cluster_cols(int K, long long per) {
  const long long kc = (K + per - 1) / per;
  return (int)(kc < kMaxCols ? kc : kMaxCols);
}

// The kernel may use all of a block's shared memory and (past 8 blocks) a
// non-portable cluster; set once per device and instance.
template <typename T, int kMode>
cudaError_t allow(int dev, int cap) {
  static bool done[panel::kMaxDevices];
  if (done[dev]) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      solve_cluster_kernel<T, kMode>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, cap);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(solve_cluster_kernel<T, kMode>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  done[dev] = e == cudaSuccess;
  return e;
}

// The clusters the card holds at once for a launch shape, remembered per
// instance (T, mode: each has its own cache) and per (device, cluster
// size, threads, shared memory): a few shapes recur.
template <typename T, int kMode>
cudaError_t clusters_fit(const cudaLaunchConfig_t* cfg, int C, int* fit) {
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
  for (int i = 0; i < used; ++i) {
    const Entry& c = cache[i];
    if (c.dev == dev && c.C == C && c.threads == threads &&
        c.smem == cfg->dynamicSmemBytes) {
      *fit = c.fit;
      return cudaSuccess;
    }
  }
  e = cudaOccupancyMaxActiveClusters(fit, solve_cluster_kernel<T, kMode>,
                                     cfg);
  if (e == cudaSuccess && used < kEntries)
    cache[used++] = Entry{dev, C, threads, *fit, cfg->dynamicSmemBytes};
  return e;
}

inline void configure(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                      const Plan& p, unsigned gx, long long nb,
                      cudaStream_t stream) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)p.C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = {};
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  cfg->stream = stream;
  cfg->blockDim = dim3((unsigned)p.threads);
  cfg->dynamicSmemBytes = p.smem;
  cfg->gridDim = dim3(gx, (unsigned)nb);
}

// The plan of one cluster size C for nb matrices: as many clusters per
// matrix as the card holds at once, each on a block of kc columns. *ok =
// false when the card does not hold a cluster per matrix or a block's rows
// do not fit in shared memory; with shrink, the columns a cluster are
// halved until they fit (the clusters then run in waves).
template <typename T, int kMode>
cudaError_t plan_size(long long nb, int n, int K, int C, bool shrink,
                      const panel::DeviceInfo& d, Plan* out, bool* ok) {
  *ok = false;
  long long per = d.sms / C / nb;                  // clusters per matrix
  if (C < 2 || per < 1) return cudaSuccess;
  const size_t esize = sizeof(T);
  const size_t cap = d.cap;
  Plan p = make_plan(kMode, esize, n, C, cluster_cols(K, per), d.cap);
  if (p.smem > cap && !shrink) return cudaSuccess;
  cudaError_t e = allow<T, kMode>(d.dev, d.cap);
  if (e != cudaSuccess) return e;
  while (p.smem > cap && p.kc > 1)
    p = make_plan(kMode, esize, n, C, (p.kc + 1) / 2, d.cap);
  if (p.smem > cap) return cudaSuccess;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  configure(&cfg, &attr, p, (unsigned)(C * per), nb, nullptr);
  // the clusters the card holds at once at this size (the GPCs, not the
  // SM count, decide): fewer clusters, each with more columns
  int fit = 0;
  e = clusters_fit<T, kMode>(&cfg, C, &fit);
  if (e != cudaSuccess) return e;
  if (fit / nb < per) {
    per = fit / nb;
    if (per < 1) return cudaSuccess;
    const int kc = cluster_cols(K, per);
    if (kc > p.kc) {
      p = make_plan(kMode, esize, n, C, kc, d.cap);
      while (shrink && p.smem > cap && p.kc > 1)
        p = make_plan(kMode, esize, n, C, (p.kc + 1) / 2, d.cap);
      if (p.smem > cap) return cudaSuccess;
    }
  }
  *out = p;
  *ok = true;
  return cudaSuccess;
}

// The cluster plan: 8 blocks a cluster, or where those do not fit in
// shared memory (the free-flyer's 1593-wide float64 factor at K = 403
// fits only with two staged steps; lu_solve past s ~ 3000 float64), 16,
// with fewer columns a cluster where even those do not fit.
template <typename T, int kMode>
cudaError_t plan(long long nb, int n, int K, Plan* out, bool* ok) {
  *ok = false;
  const panel::DeviceInfo* d = nullptr;
  cudaError_t e = panel::device_info(&d);
  if (e != cudaSuccess) return e;
  const int np = (n + kW - 1) / kW;
  const int C = np < kPortable ? np : kPortable;
  e = plan_size<T, kMode>(nb, n, K, C, false, *d, out, ok);
  if (e != cudaSuccess || *ok || np <= kPortable) return e;
  return plan_size<T, kMode>(nb, n, K, np < kWide ? np : kWide, true, *d,
                             out, ok);
}

template <typename T, int kMode>
cudaError_t launch(const Plan& p, const T* M, const int32_t* perm,
                   const T* B, T* X, long long nb, int n, int K,
                   cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  configure(&cfg, &attr, p, (unsigned)(p.C * ((K + p.kc - 1) / p.kc)), nb,
            stream);
  cudaError_t e = cudaLaunchKernelEx(&cfg, solve_cluster_kernel<T, kMode>,
                                     M, perm, B, X, n, K, p.kc, p.rows,
                                     p.nbuf);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace cluster
