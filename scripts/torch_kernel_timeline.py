#!/usr/bin/env python3
"""Phase timeline inside the port's LU, substitution and Cholesky kernels
(scptoolbox_torch/csrc/) on one GPU, from %globaltimer stamps.

    python3 scripts/torch_kernel_timeline.py [--tree DIR] [--n N,..]
        [--ks K,..] [--only RUN,..] [--ptxas NAME]

No profiler on the card sees inside a kernel, so this copies the kernel
sources of a tree (this checkout, or DIR: an unpacked tree of another
commit, for example the parent's under the git-ignored _archive/), inserts
%globaltimer stamps at the phase boundaries of block 0 (thread 0 of the
first block of the grid), builds the copies with nvcc into the git-ignored
_archive/timeline/ and loads them with ctypes. The stamps know the designs
of both trees: where a design's anchor is missing from a source, its
stamps are left out.

Runs (--only picks some), each once after a warm-up launch: cholesky at
1 x N^2 (float64, N = 876 by default; --n takes several); cholesky_batched
at 1536 x 105^2, 1536 x 53^2 and 128 x 314^2 (float32), 1 x 96^2, 1 x 53^2
and 4 x 53^2 (float64); solve_lower_t and solve_lower at 1 x N, K = 2 and
566 (--ks picks others; float64); solve_lower at 128 x 314, K = 2 and 64
(float32); lu_solve at 512 x 158, K = 2 and 158 (float32) and, past the
panel design's shared memory, 1 x 694, K = 2 and 37 (float64); lu_factor
at 512 x 158^2, 32 x 145^2 and 2048 x 29^2 (float32), 64 x 158^2 (float64)
and, on the grid design past shared memory, 1 x 694^2 (float64);
gj_inverse at 512 x 158^2 and 32 x 145^2 (float32), 64 x 158^2 and 4 x
145^2 (float64). Prints, per run, the span of block 0 and the time summed
over each kind of phase, with its count, and the kernel's own time by CUDA
events over 20 launches. The stamps cost a few hundred nanoseconds each.
"""

import argparse
import collections
import ctypes
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402  (the Gauss-Jordan inputs)
STAMP = '''
__device__ unsigned long long g_tlog[8192];
__device__ int g_tag[8192];
__device__ int g_slot;
#define TS(tag) if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0 \\
  && g_slot < 8192) { unsigned long long t_; \\
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)); \\
    g_tlog[g_slot] = t_; g_tag[g_slot++] = tag; }
'''
READ = '''
extern "C" int read_tlog(unsigned long long* h, int* g, int n) {
  cudaMemcpyFromSymbol(g, g_tag, n * 4);
  return (int)cudaMemcpyFromSymbol(h, g_tlog, n * 8);
}
extern "C" int clear_tlog() {
  static int z[8192];
  cudaMemcpyToSymbol(g_slot, z, sizeof(int));
  return (int)cudaMemcpyToSymbol(g_tag, z, sizeof(z));
}
'''
# (file, pattern, its replacement): the stamps around each phase boundary
EDITS = [
    # the spread Cholesky factor
    ("chol_kernels.cu", "cg::grid_group grid = cg::this_grid();",
     "cg::grid_group grid = cg::this_grid(); int slot_ = 0;"),
    ("chol_kernels.cu", "  grid.sync();\n\n  for (int j0",
     "  grid.sync(); TS(1);\n\n  for (int j0"),
    ("chol_kernels.cu", "    __syncthreads();\n\n    // (A) the panel's rows below",
     "    __syncthreads(); TS(2);\n\n    // (A) the panel's rows below"),
    ("chol_kernels.cu", "    grid.sync();\n\n    // (B)",
     "    TS(3); grid.sync(); TS(4);\n\n    // (B)"),
    ("chol_kernels.cu", "    grid.sync();\n  }\n}",
     "    TS(5); grid.sync(); TS(6);\n  }\n}"),
    # the cluster solves (solve_lower, solve_lower_t and lu_solve)
    ("cluster_solve.cuh", "cg::cluster_group cluster = cg::this_cluster();",
     "cg::cluster_group cluster = cg::this_cluster(); int slot_ = 0;"),
    ("cluster_solve.cuh",
     "__syncthreads();            // this block is done with step g - 1",
     "__syncthreads(); TS(11);"),
    ("cluster_solve.cuh",
     'asm volatile("barrier.cluster.arrive.release;" ::: "memory");',
     'TS(12); asm volatile("barrier.cluster.arrive.release;" ::: "memory");'),
    ("cluster_solve.cuh",
     'asm volatile("barrier.cluster.wait.acquire;" ::: "memory");',
     'TS(13); asm volatile("barrier.cluster.wait.acquire;" ::: "memory");'
     " TS(14);"),
    ("cluster_solve.cuh", "      solve_panel(g + 1, prev);",
     "      TS(16); solve_panel(g + 1, prev); TS(17);"),
    ("cluster_solve.cuh",
     "    __syncthreads();\n    T* xo = xs + slot(g) * kW * kc;\n",
     "    TS(18); __syncthreads(); TS(19);\n"
     "    T* xo = xs + slot(g) * kW * kc;\n"),
    ("cluster_solve.cuh",
     "        cluster.map_shared_rank(xo, b)[r * kc + c] = v;\n    }\n",
     "        cluster.map_shared_rank(xo, b)[r * kc + c] = v;\n    }\n"
     "    TS(15);\n"),
    ("cluster_solve.cuh", "  cluster.sync();                 // every block",
     "  TS(9); cluster.sync(); TS(10);                 // every block"),
    # the cluster solves of the earlier source (both directions)
    ("chol_kernels.cu", "cg::cluster_group cluster = cg::this_cluster();",
     "cg::cluster_group cluster = cg::this_cluster(); int slot_ = 0;"),
    ("chol_kernels.cu",
     "__syncthreads();              // this block is done with panel q - 1",
     "__syncthreads(); TS(11);"),
    ("chol_kernels.cu",
     'asm volatile("barrier.cluster.arrive.release;" ::: "memory");',
     'TS(12); asm volatile("barrier.cluster.arrive.release;" ::: "memory");'),
    ("chol_kernels.cu",
     'asm volatile("barrier.cluster.wait.acquire;" ::: "memory");',
     'TS(13); asm volatile("barrier.cluster.wait.acquire;" ::: "memory");'
     " TS(14);"),
    ("chol_kernels.cu", "solve_panel(q + 1, true);",
     "TS(16); solve_panel(q + 1, true); TS(17);"),
    # the one-block solve reading L in device memory
    ("chol_kernels.cu", "  const bool active = row0 < rstride && c < kw;\n",
     "  const bool active = row0 < rstride && c < kw;\n  int slot_ = 0;\n"),
    ("chol_kernels.cu",
     "    // the diagonal block: lane r holds row lo + r of column cc\n",
     "    TS(40);\n    // the diagonal block: lane r holds row lo + r of "
     "column cc\n"),
    ("chol_kernels.cu",
     "    // the rows past the panel take its w solved rows, in column order\n",
     "    TS(41);\n    // the rows past the panel take its w solved rows, in "
     "column order\n"),
    ("chol_kernels.cu",
     "    __syncthreads();\n  }\n}\n\n// Phase (A) of the spread factor",
     "    __syncthreads(); TS(42);\n  }\n}\n\n// Phase (A) of the spread "
     "factor"),
    # the panel solve (lu_solve, the batched solve_lower)
    ("panel_solve.cuh",
     "  const int nsteps = kMode == kLU ? 2 * np : np;\n",
     "  const int nsteps = kMode == kLU ? 2 * np : np;\n"
     "  int slot_ = 0; TS(20);\n"),
    ("panel_solve.cuh", "  for (int g = 0; g < nsteps; ++g) {\n",
     "  TS(21);\n  for (int g = 0; g < nsteps; ++g) {\n"),
    ("panel_solve.cuh",
     "    __syncthreads();              // everyone's, and X's rows\n",
     "    __syncthreads(); TS(22);\n"),
    ("panel_solve.cuh",
     "    __syncthreads();\n    const int ib = fwd ? p0 + w : 0;\n",
     "    TS(23); __syncthreads(); TS(24);\n"
     "    const int ib = fwd ? p0 + w : 0;\n"),
    ("panel_solve.cuh",
     "    __syncthreads();              // step g's buffer is free again\n",
     "    TS(25); __syncthreads(); TS(26);\n"),
    ("panel_solve.cuh",
     "    X[(int64_t)i * K + c] = Xs[(int64_t)i * kb + c];\n  }\n}",
     "    X[(int64_t)i * K + c] = Xs[(int64_t)i * kb + c];\n  }\n  TS(27);\n}"),
    # the one-block lu_factor of the earlier design (three barriers a step)
    ("lu_kernels.cu",
     "  for (int i = tid; i < s * s; i += nt) W[i] = src[i];\n"
     "  __syncthreads();\n\n  for (int j = 0; j < s; ++j) {",
     "  int slot_ = 0; TS(60);\n"
     "  for (int i = tid; i < s * s; i += nt) W[i] = src[i];\n"
     "  __syncthreads(); TS(61);\n\n  for (int j = 0; j < s; ++j) {"),
    ("lu_kernels.cu", "    // 2. swap whole rows",
     "    TS(62);\n    // 2. swap whole rows"),
    ("lu_kernels.cu", "    // 3. + 4. multipliers",
     "    TS(63);\n    // 3. + 4. multipliers"),
    ("lu_kernels.cu",
     "    __syncthreads();\n  }\n\n  T* dst = out + mat * (int64_t)s * s;\n"
     "  for (int i = tid; i < s * s; i += nt) dst[i] = W[i];\n}",
     "    TS(64); __syncthreads(); TS(65);\n  }\n\n"
     "  T* dst = out + mat * (int64_t)s * s;\n"
     "  for (int i = tid; i < s * s; i += nt) dst[i] = W[i];\n  TS(66);\n}"),
    # lu_factor's panel design (s > 32)
    ("lu_kernels.cu", "  const PanelSmem<T> sm(smem_raw, s);\n",
     "  const PanelSmem<T> sm(smem_raw, s);\n  TS(70);\n"),
    ("lu_kernels.cu",
     "  __syncthreads();\n\n  for (int p0 = 0; p0 < s; p0 += kPW) {",
     "  __syncthreads(); TS(71);\n\n  for (int p0 = 0; p0 < s; p0 += kPW) {"),
    ("lu_kernels.cu",
     "    __syncthreads();                          // the panel is factored\n",
     "    TS(72); __syncthreads(); TS(73);\n"),
    ("lu_kernels.cu",
     "    __syncthreads();                          // the trailing block is "
     "done\n", "    TS(76); __syncthreads(); TS(77);\n"),
    ("lu_kernels.cu",
     "      for (int c = lane; c < s; c += 32) dst[(int64_t)i * s + c] = "
     "row[c];\n    }\n  }\n}",
     "      for (int c = lane; c < s; c += 32) dst[(int64_t)i * s + c] = "
     "row[c];\n    }\n  }\n  TS(78);\n}"),
    ("lu_kernels.cu",
     "    __syncthreads();                 // step jj's candidates are "
     "offered\n",
     "    TS(90); __syncthreads(); TS(91);\n"),
    ("lu_kernels.cu", "    if (rows) {\n      T u[kPW];",
     "    TS(92);\n    if (rows) {\n      T u[kPW];"),
    ("lu_kernels.cu",
     "#pragma unroll\n      for (int c = jj + 2; c < kPW; ++c)\n"
     "        v[c] = upd",
     "      TS(93);\n#pragma unroll\n      for (int c = jj + 2; c < kPW; ++c)\n"
     "        v[c] = upd"),
    ("lu_kernels.cu", "      // offer step jj + 1's candidate\n",
     "      TS(94);\n      // offer step jj + 1's candidate\n"),
    ("lu_kernels.cu", "    // column col's row j of U: the pivot row's",
     "    TS(95);\n    // column col's row j of U: the pivot row's"),
    # lu_factor's warp design (s <= 32)
    ("lu_kernels.cu",
     "  T* dst = out + mat * s * s;\n\n  for (int i = 0; i < s; ++i)",
     "  T* dst = out + mat * s * s;\n  int slot_ = 0; TS(80);\n\n"
     "  for (int i = 0; i < s; ++i)"),
    ("lu_kernels.cu", "  int pos = lane;", "  TS(81);\n  int pos = lane;"),
    ("lu_kernels.cu",
     "  __syncwarp();\n  if (has_row) {\n#pragma unroll\n"
     "    for (int c = 0; c < KS; ++c)\n      if (c < s) S[pos * ld + c]",
     "  TS(82);\n  __syncwarp();\n  if (has_row) {\n#pragma unroll\n"
     "    for (int c = 0; c < KS; ++c)\n      if (c < s) S[pos * ld + c]"),
    ("lu_kernels.cu", "  if (lane < s) perm[mat * s + lane] = rec;\n}",
     "  if (lane < s) perm[mat * s + lane] = rec;\n  TS(83);\n}"),
    # the one-block lu_solve of the earlier design (row by row)
    ("lu_kernels.cu", "  const bool active = row0 < rstride && col < kw;\n",
     "  const bool active = row0 < rstride && col < kw;\n"
     "  int slot_ = 0; TS(30);\n"),
    ("lu_kernels.cu", "  __syncthreads();\n\n  const T* Bsrc",
     "  __syncthreads(); TS(31);\n\n  const T* Bsrc"),
    ("lu_kernels.cu", "  // unit-L forward substitution\n",
     "  TS(32);\n  // unit-L forward substitution\n"),
    ("lu_kernels.cu", "  // U back substitution",
     "  TS(33);\n  // U back substitution"),
    ("lu_kernels.cu", "  T* Xdst = X + mat", "  TS(34);\n  T* Xdst = X + mat"),
    ("lu_kernels.cu",
     "          b[i * kb + col] * pivot_recip(Fm[(int64_t)i * s + i]);\n"
     "    }\n  }\n}",
     "          b[i * kb + col] * pivot_recip(Fm[(int64_t)i * s + i]);\n"
     "    }\n  }\n  TS(35);\n}"),
    # the one-block gj_inverse of the earlier design (two barriers a step)
    ("gj_kernels.cu",
     "  for (int idx = tid; idx < n2; idx += nt) W[idx] = in[idx];\n"
     "  __syncthreads();\n",
     "  TS(100);\n"
     "  for (int idx = tid; idx < n2; idx += nt) W[idx] = in[idx];\n"
     "  __syncthreads(); TS(101);\n"),
    ("gj_kernels.cu",
     "      colj[k] = W[k * s + j];\n    }\n    __syncthreads();\n",
     "      colj[k] = W[k * s + j];\n    }\n"
     "    TS(102); __syncthreads(); TS(103);\n"),
    ("gj_kernels.cu", "      W[idx] = v;\n    }\n    __syncthreads();\n",
     "      W[idx] = v;\n    }\n    TS(104); __syncthreads(); TS(105);\n"),
    ("gj_kernels.cu",
     "  for (int idx = tid; idx < n2; idx += nt) out[idx] = W[idx];\n}",
     "  for (int idx = tid; idx < n2; idx += nt) out[idx] = W[idx];\n"
     "  TS(106);\n}"),
    # gj_inverse on register tiles (one barrier a step, look-ahead)
    ("gj_kernels.cu", "  T v[R][CC];", "  TS(110);\n  T v[R][CC];"),
    ("gj_kernels.cu",
     "  if (C > 1) {                         // every block runs",
     "  TS(111);\n  if (C > 1) {                         // every block runs"),
    ("gj_kernels.cu",
     "      if (C > 1)\n        cluster_wait();\n      else\n"
     "        __syncthreads();\n",
     "      TS(112);\n      if (C > 1)\n        cluster_wait();\n      else\n"
     "        __syncthreads();\n      TS(113);\n"),
    ("gj_kernels.cu",
     "          cluster_arrive();\n        }\n      }\n\n"
     "      // step j on the whole",
     "          cluster_arrive();\n        }\n      }\n      TS(114);\n\n"
     "      // step j on the whole"),
    ("gj_kernels.cu", "      if (C == 1 && next && lane",
     "      TS(116);\n      if (C == 1 && next && lane"),
    ("gj_kernels.cu",
     "      if (i < s && k < s) out[(int64_t)i * s + k] = v[a][b];\n    }\n}",
     "      if (i < s && k < s) out[(int64_t)i * s + k] = v[a][b];\n    }\n"
     "  TS(115);\n}"),
    # cholesky's shared-memory design (a block a matrix, the triangle in
    # shared memory)
    ("chol_kernels.cu",
     "  __syncthreads();\n  // where entry (i, k), k <= i, lies\n",
     "  __syncthreads(); TS(120);\n  // where entry (i, k), k <= i, lies\n"),
    ("chol_kernels.cu",
     "  __pipeline_wait_prior(0);\n  __syncthreads();\n\n  for (int p = 0;"
     " p < np; ++p) {",
     "  __pipeline_wait_prior(0);\n  __syncthreads(); TS(121);\n\n"
     "  for (int p = 0; p < np; ++p) {"),
    ("chol_kernels.cu",
     "    __syncthreads();\n    if (j0 + kW >= n) break;",
     "    __syncthreads(); TS(122);\n    if (j0 + kW >= n) break;"),
    ("chol_kernels.cu",
     "      for (int c = 0; c < kW; ++c) PT[c * ld + r] = x[c];\n    }\n"
     "    __syncthreads();\n",
     "      for (int c = 0; c < kW; ++c) PT[c * ld + r] = x[c];\n    }\n"
     "    __syncthreads(); TS(123);\n"),
    ("chol_kernels.cu",
     "            if (i < n && k0 + q <= i) P[a0 + q * ldq + i] = acc[u][q];"
     "\n        }\n      }\n    }\n    __syncthreads();\n",
     "            if (i < n && k0 + q <= i) P[a0 + q * ldq + i] = acc[u][q];"
     "\n        }\n      }\n    }\n    __syncthreads(); TS(124);\n"),
    ("chol_kernels.cu",
     "    for (int k = lane; k < n; k += 32) dst[k] = k <= i ? P[at(i, k)] "
     ": T(0);\n  }\n}",
     "    for (int k = lane; k < n; k += 32) dst[k] = k <= i ? P[at(i, k)] "
     ": T(0);\n  }\n  TS(125);\n}"),
    # lu_factor's blocked grid design (panels past a block's shared memory)
    ("lu_kernels.cu",
     "  const long long rounds = (nb + groups - 1) / groups;\n"
     "  for (long long q = 0; q < rounds; ++q) {\n"
     "    const long long mat = g",
     "  const long long rounds = (nb + groups - 1) / groups;\n  TS(130);\n"
     "  for (long long q = 0; q < rounds; ++q) {\n"
     "    const long long mat = g"),
    ("lu_kernels.cu", "    sync();\n    int p0 = 0;\n",
     "    sync(); TS(131);\n    int p0 = 0;\n"),
    ("lu_kernels.cu", "      sync();                                  // the "
     "panel is factored\n",
     "      TS(132); sync(); TS(133);\n"),
    ("lu_kernels.cu", "      sync();                                  // the "
     "trailing block is done\n",
     "      TS(134); sync(); TS(135);\n"),
    ("lu_kernels.cu", "    sync();                  // the group's map is "
     "free for the next round\n",
     "    TS(136); sync();\n"),
    ("lu_kernels.cu", "    __syncthreads();                 // the "
     "candidates of step jj\n    const unsigned won = pick_grid(",
     "    TS(140); __syncthreads(); TS(141);\n"
     "    const unsigned won = pick_grid("),
    ("lu_kernels.cu", "    const bool mine = jj + 1 < kPW && reduce(bk, bp, "
     "best);\n",
     "    const bool mine = jj + 1 < kPW && reduce(bk, bp, best);\n"
     "    TS(142);\n"),
    ("lu_kernels.cu",
     "    const int r0 = i0 + ti * kGT, c0 = i0 + tk * kGT;\n",
     "    const int r0 = i0 + ti * kGT, c0 = i0 + tk * kGT; TS(150);\n"),
    ("lu_kernels.cu",
     "    __syncthreads();                 // Ld and Lt are staged\n",
     "    __syncthreads(); TS(151);\n"),
    ("lu_kernels.cu",
     "    __syncthreads();                 // the U strip is solved\n",
     "    __syncthreads(); TS(152);\n"),
    ("lu_kernels.cu",
     "    __syncthreads();                 // Lt and Us are free again\n",
     "    __syncthreads(); TS(153);\n"),
    # lu_solve's rows design (X in shared memory, the factor read in
    # device memory a row a thread)
    ("lu_kernels.cu", "  const T* f = F + mat * (int64_t)s * s;\n\n"
     "  for (int i = tid; i < s; i += nt) idx[i] = i;\n",
     "  const T* f = F + mat * (int64_t)s * s;\n  TS(160);\n"
     "  for (int i = tid; i < s; i += nt) idx[i] = i;\n"),
    ("lu_kernels.cu", "  }\n  __syncthreads();\n  for (int e = tid; e < s * kw;"
     " e += nt) {\n    const int i = e / kw, c = e - (e / kw) * kw;\n"
     "    Xs[(size_t)i * kb + c] = B[",
     "  }\n  __syncthreads(); TS(161);\n  for (int e = tid; e < s * kw;"
     " e += nt) {\n    const int i = e / kw, c = e - (e / kw) * kw;\n"
     "    Xs[(size_t)i * kb + c] = B["),
    ("lu_kernels.cu", "  // unit-L forward\n", "  TS(162);\n  // unit-L "
     "forward\n"),
    ("lu_kernels.cu", "    if (tid < kw) {\n      T x[kD];\n#pragma unroll\n"
     "      for (int a = 0; a < kD; ++a)\n        x[a] = a < w ? "
     "Xs[(size_t)(p0 + a) * kb + tid] : T(0);\n#pragma unroll\n"
     "      for (int t = 0; t < kD; ++t) {",
     "    TS(163);\n    if (tid < kw) {\n      T x[kD];\n#pragma unroll\n"
     "      for (int a = 0; a < kD; ++a)\n        x[a] = a < w ? "
     "Xs[(size_t)(p0 + a) * kb + tid] : T(0);\n#pragma unroll\n"
     "      for (int t = 0; t < kD; ++t) {"),
    ("lu_kernels.cu", "    const int r0 = p0 + w;\n",
     "    TS(164);\n    const int r0 = p0 + w;\n"),
    ("lu_kernels.cu", "    __syncthreads();\n  }\n\n  // U backward",
     "    TS(165); __syncthreads();\n  }\n  TS(166);\n\n  // U backward"),
    ("lu_kernels.cu", "    if (tid < kw) {\n      T x[kD];\n#pragma unroll\n"
     "      for (int a = 0; a < kD; ++a)\n        x[a] = a < w ? "
     "Xs[(size_t)(p0 + a) * kb + tid] : T(0);\n#pragma unroll\n"
     "      for (int t = kD - 1",
     "    TS(167);\n    if (tid < kw) {\n      T x[kD];\n#pragma unroll\n"
     "      for (int a = 0; a < kD; ++a)\n        x[a] = a < w ? "
     "Xs[(size_t)(p0 + a) * kb + tid] : T(0);\n#pragma unroll\n"
     "      for (int t = kD - 1"),
    ("lu_kernels.cu", "    for (int e = tid; e < p0 * kw; e += nt) {\n",
     "    TS(168);\n    for (int e = tid; e < p0 * kw; e += nt) {\n"),
    ("lu_kernels.cu", "      Xs[(size_t)i * kb + c] = acc;\n    }\n"
     "    __syncthreads();\n  }\n  for (int e = tid;",
     "      Xs[(size_t)i * kb + c] = acc;\n    }\n"
     "    TS(169); __syncthreads();\n  }\n  TS(170);\n  for (int e = tid;"),
    ("lu_kernels.cu", "        Xs[(size_t)i * kb + c] * pivot_recip(f[(int64_t)"
     "i * s + i]);\n  }\n}",
     "        Xs[(size_t)i * kb + c] * pivot_recip(f[(int64_t)"
     "i * s + i]);\n  }\n  TS(171);\n}"),
]
NAMES = {(1, 2): "diagonal block", (6, 2): "diagonal block",
         (2, 3): "panel rows",
         (3, 4): "grid sync 1", (4, 5): "tiles", (5, 6): "grid sync 2",
         (11, 12): "(block sync)", (12, 13): "copies issued",
         (13, 14): "cluster wait", (14, 16): "(block sync)",
         (16, 17): "owner: its panel's update and solve",
         (16, 18): "owner: its panel's update and diagonal block",
         (18, 19): "owner: barrier", (19, 15): "owner: publish (DSMEM)",
         (15, 17): "(owner done)", (10, 16): "first copies, wait",
         (9, 10): "cluster sync (start)", (15, 11): "(first panel done)",
         (10, 11): "(start)",
         (17, 11): "other rows update",
         (14, 11): "rows update",
         (40, 41): "diagonal block + barrier",
         (41, 42): "rows past the panel + barrier", (42, 40): "(loop)",
         (20, 21): "prologue (record, permutation, gather)",
         (21, 22): "panel copy wait + barrier",
         (26, 22): "panel copy wait + barrier",
         (22, 23): "diagonal block", (23, 24): "barrier 2",
         (24, 25): "rows past the panel", (25, 26): "barrier 3",
         (26, 27): "write X",
         (30, 31): "permutation (thread 0)", (31, 32): "gather + barrier",
         (32, 33): "forward (a barrier a row)",
         (33, 34): "backward (a barrier a row)", (34, 35): "write X",
         (60, 61): "load", (61, 62): "pivot search + barrier",
         (65, 62): "pivot search + barrier", (62, 63): "swap (+ barrier)",
         (63, 64): "multipliers + rank-1 update", (64, 65): "barrier 3",
         (65, 66): "write",
         (70, 71): "load", (71, 90): "panel start",
         (77, 90): "panel start", (90, 91): "step barrier",
         (91, 92): "pick the winner",
         (92, 93): "pivot row, next column, reductions",
         (93, 94): "rest of the row update", (94, 95): "offer candidate",
         (95, 90): "column of U", (95, 72): "write the panel back",
         (72, 73): "barrier after panel", (73, 76): "trailing update",
         (76, 77): "barrier after trailing", (73, 78): "write",
         (71, 72): "panel (one warp)", (77, 72): "panel (one warp)",
         (80, 81): "load", (81, 82): "factor (warp)", (82, 83): "write",
         (100, 101): "load", (101, 102): "pivot, row and column j copied",
         (105, 102): "pivot, row and column j copied",
         (102, 103): "barrier 1", (103, 104): "update s^2 entries",
         (104, 105): "barrier 2", (105, 106): "write",
         (110, 111): "load", (111, 112): "first sync, step 0's row",
         (112, 113): "barrier wait",
         (113, 114): "reads, look-ahead row (cluster: and column, "
         "arrive)",
         (114, 116): "tile update",
         (116, 112): "(one block: column j + 1)",
         (116, 115): "write",
         (120, 121): "load", (121, 122): "diagonal block + barrier",
         (124, 122): "diagonal block + barrier",
         (122, 123): "rows below + barrier",
         (123, 124): "trailing + barrier", (122, 125): "write",
         (130, 131): "copy in + grid sync", (131, 140): "panel start",
         (133, 134): "trailing tiles (none on block 0)",
         (133, 150): "map, unit-L block", (150, 151): "tile loads + barrier",
         (151, 152): "U strip + barrier", (152, 153): "tile update + barrier",
         (153, 150): "(next tile)", (153, 134): "(tiles done)",
         (134, 135): "grid sync (trailing)",
         (135, 140): "panel start", (132, 133): "grid sync (panel)",
         (140, 141): "step barrier",
         (141, 142): "pick, multipliers, next column, reductions",
         (142, 140): "rest of the rows, candidate row",
         (142, 132): "write the panel back",
         (131, 132): "last panel (one warp)",
         (135, 132): "last panel (one warp)", (133, 136): "write out",
         (160, 161): "permutation (thread 0) + barrier",
         (161, 162): "gather", (162, 163): "stage D + barrier",
         (165, 163): "barrier + stage D + barrier",
         (163, 164): "diagonal block + barrier",
         (164, 165): "rows past the panel (factor in device memory)",
         (165, 166): "(last barrier)",
         (166, 167): "stage D, recips + barrier",
         (169, 167): "barrier + stage D, recips + barrier",
         (167, 168): "diagonal block + barrier (backward)",
         (168, 169): "rows past the panel (backward)",
         (169, 170): "(last barrier)", (170, 171): "scale, write X"}


RUNS = ("cholesky", "cholesky_batched", "solve_lower_t", "solve_lower",
        "lu_solve", "lu_factor", "gj_inverse")


def build(tree, tag, sources, ptxas=None):
    """Stamped copies of tree's kernel sources, built; {source: CDLL}.
    ptxas: print nvcc's register and spill report of the kernels whose
    mangled names contain it."""
    src = os.path.join(tree, "scptoolbox_torch", "csrc")
    out = os.path.join(REPO, "_archive", "timeline", tag)
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    names = [f for f in os.listdir(src) if f.endswith((".cu", ".cuh"))]
    for name in names:
        text = open(os.path.join(src, name)).read()
        for fname, pat, rep in EDITS:
            if fname == name:
                assert text.count(pat) <= 1, pat
                text = text.replace(pat, rep)
        if name.endswith(".cu"):
            text = STAMP + text + READ
        with open(os.path.join(out, name), "w") as f:
            f.write(text)
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    libs, procs = {}, []
    for name in sources:
        so = os.path.join(out, f"lib{name[:-3]}.so")
        procs.append((name, so, subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-o",
             so, os.path.join(out, name)] + (["-Xptxas", "-v"] if ptxas
                                             else []),
            stderr=subprocess.PIPE, text=True)))
    for name, so, proc in procs:
        err = proc.communicate()[1]
        assert proc.returncode == 0, f"nvcc failed on {name}:\n{err}"
        lines = err.splitlines()
        for i, line in enumerate(lines):
            if ptxas and "Compiling entry function" in line \
                    and ptxas in line:
                print(name, line.split("'")[1], "|",
                      " ".join(x.strip() for x in lines[i + 1:i + 5]
                               if "Compiling" not in x), flush=True)
        lib = ctypes.CDLL(so)
        lib.read_tlog.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_int]
        libs[name] = lib
    return libs


def checked(fn, *args):
    rc = fn(*args)
    assert rc == 0, f"kernel launch failed: CUDA error {rc}"


def report(lib, run, what):
    run()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(20):
        run()
    e1.record()
    torch.cuda.synchronize()
    ms = e0.elapsed_time(e1) / 20
    lib.clear_tlog()
    run()
    torch.cuda.synchronize()
    h = np.zeros(8192, np.uint64)
    g = np.zeros(8192, np.int32)
    lib.read_tlog(h.ctypes.data, g.ctypes.data, 8192)
    k = int((g > 0).sum())
    t, g = h[:k].astype(np.int64), g[:k]
    acc, cnt = collections.Counter(), collections.Counter()
    for i in range(1, k):
        name = NAMES.get((int(g[i - 1]), int(g[i])), f"{g[i - 1]}->{g[i]}")
        acc[name] += (t[i] - t[i - 1]) / 1e3
        cnt[name] += 1
    span = (t[-1] - t[0]) / 1e3 if k else float("nan")
    print(what, f"kernel {ms * 1e3:.1f} us; block 0 span {span:.1f} us;",
          "; ".join(f"{k2} {v:.1f} us x{cnt[k2]}" for k2, v in acc.items()),
          flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=REPO)
    ap.add_argument("--n", default="876",
                    help="sizes of the 1 x N runs, comma-separated")
    ap.add_argument("--ks", default="2,566",
                    help="columns of the 1 x N solves")
    ap.add_argument("--ptxas", default=None,
                    help="print the register and spill report of the "
                    "kernels whose mangled names contain this")
    ap.add_argument("--only", default=",".join(RUNS),
                    help="comma-separated subset of " + ",".join(RUNS))
    args = ap.parse_args()
    ns = [int(v) for v in args.n.split(",")]
    only = args.only.split(",")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    tree = os.path.abspath(args.tree)
    print(smi, "| tree:", os.path.relpath(tree, REPO), flush=True)
    sources = [src for src, runs in (
        ("lu_kernels.cu", {"lu_factor", "lu_solve"}),
        ("chol_kernels.cu", {"cholesky", "cholesky_batched", "solve_lower_t",
                             "solve_lower"}),
        ("gj_kernels.cu", {"gj_inverse"})) if runs & set(only)]
    libs = build(tree, "this" if tree == REPO else "other", sources,
                 args.ptxas)
    ch, lu = libs.get("chol_kernels.cu"), libs.get("lu_kernels.cu")
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    st = P(torch.cuda.current_stream().cuda_stream)
    g = torch.Generator(device="cuda")
    g.manual_seed(0)

    def spd(nb, m, dt):
        M = torch.randn(nb, m, m, generator=g, device="cuda", dtype=dt)
        return M @ M.mT + m * torch.eye(m, device="cuda", dtype=dt)

    def run_solve(lib, fn, Lf, nb, m, K, dt):
        B = torch.randn(nb, m, K, generator=g, device="cuda", dtype=dt)
        X = torch.empty_like(B)
        return lambda: getattr(lib, fn)(P(Lf.data_ptr()), P(B.data_ptr()),
                                        P(X.data_ptr()), L(nb), I(m), I(K),
                                        st)

    f64 = torch.float64
    if "lu_factor" in only:
        for nb, m, dt in ((512, 158, torch.float32), (32, 145, torch.float32),
                          (64, 158, f64), (2048, 29, torch.float32)):
            A = torch.randn(nb, m, m, generator=g, device="cuda", dtype=dt)
            A.diagonal(dim1=-2, dim2=-1).mul_(1e-7)
            F = torch.empty_like(A)
            rec = torch.empty(nb, m, dtype=torch.int32, device="cuda")
            fn = getattr(lu, "lu_factor_f32" if dt == torch.float32
                         else "lu_factor_f64")
            run = (lambda fn=fn, A=A, F=F, rec=rec, nb=nb, m=m:
                   fn(P(A.data_ptr()), P(F.data_ptr()), P(rec.data_ptr()),
                      L(nb), I(m), st))
            report(lu, run, f"lu_factor {nb} x {m}^2 {str(dt)[6:]}:")
        # past a block's shared memory: the grid design's own entry (its
        # position maps sized for either tree's)
        for nb, m, dt in ((1, 694, f64),):
            A = torch.randn(nb, m, m, generator=g, device="cuda", dtype=dt)
            A.diagonal(dim1=-2, dim2=-1).mul_(1e-7)
            F, work = torch.empty_like(A), torch.empty_like(A)
            rec = torch.empty(nb, m, dtype=torch.int32, device="cuda")
            # this tree's words at m (its maps); a parent's entry takes no
            # argument and gives its 4 words an SM
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            words = max(lu.lu_factor_grid_words(I(m)), 4 * sms)
            maps = torch.empty(words, dtype=torch.int64, device="cuda")
            run = (lambda A=A, F=F, rec=rec, work=work, maps=maps, nb=nb, m=m:
                   checked(lu.lu_factor_grid_f64, P(A.data_ptr()),
                           P(F.data_ptr()), P(rec.data_ptr()),
                           P(work.data_ptr()), P(maps.data_ptr()), L(nb),
                           I(m), st))
            report(lu, run, f"lu_factor (grid) {nb} x {m}^2 float64:")
    if "gj_inverse" in only:
        gj = libs["gj_kernels.cu"]
        for nb, m, dt in ((512, 158, torch.float32), (32, 145, torch.float32),
                          (64, 158, f64), (4, 145, f64)):
            Q = chip_smoke._quasidefinite(torch, nb, m, dt, g)
            out = torch.empty_like(Q)
            fn = getattr(gj, "gj_inverse_f32" if dt == torch.float32
                         else "gj_inverse_f64")
            run = (lambda fn=fn, Q=Q, out=out, nb=nb, m=m:
                   checked(fn, P(Q.data_ptr()), P(out.data_ptr()), L(nb),
                           I(m), st))
            report(gj, run, f"gj_inverse {nb} x {m}^2 {str(dt)[6:]}:")
    if "cholesky_batched" in only:
        for nb, m, dt in ((1536, 105, torch.float32),
                          (1536, 53, torch.float32),
                          (128, 314, torch.float32), (1, 96, f64),
                          (1, 53, f64), (4, 53, f64)):
            Hb = spd(nb, m, dt)
            Lb = torch.empty_like(Hb)
            fn = getattr(ch, "cholesky_f32" if dt == torch.float32
                         else "cholesky_f64")
            run = (lambda fn=fn, Hb=Hb, Lb=Lb, nb=nb, m=m:
                   checked(fn, P(Hb.data_ptr()), P(Lb.data_ptr()), L(nb),
                           I(m), st))
            report(ch, run, f"cholesky {nb} x {m}^2 {str(dt)[6:]}:")
    if "cholesky" not in only and "solve_lower_t" not in only \
            and "solve_lower" not in only and "lu_solve" not in only:
        return 0
    for n in ns:
        H = spd(1, n, f64)
        Lf = torch.empty_like(H)
        chol = (lambda H=H, Lf=Lf, n=n:
                ch.cholesky_f64(P(H.data_ptr()), P(Lf.data_ptr()), L(1),
                                I(n), st))
        chol()
        if "cholesky" in only:
            report(ch, chol, f"cholesky 1 x {n}^2 float64:")
        for fn in ("solve_lower_t", "solve_lower"):
            if fn not in only:
                continue
            for K in (int(k) for k in args.ks.split(",")):
                report(ch, run_solve(ch, f"{fn}_f64", Lf, 1, n, K, f64),
                       f"{fn} 1 x {n}, K={K} float64:")
    Hb = spd(128, 314, torch.float32)
    Lb = torch.linalg.cholesky(Hb).contiguous()   # any lower factor does
    for K in ((2, 64) if "solve_lower" in only else ()):
        report(ch, run_solve(ch, "solve_lower_f32", Lb, 128, 314, K,
                             torch.float32),
               f"solve_lower 128 x 314, K={K} float32:")
    M = torch.randn(512, 158, 158, generator=g, device="cuda")
    M.diagonal(dim1=-2, dim2=-1).mul_(1e-7)
    F, piv = torch.linalg.lu_factor(M)
    F = F.contiguous()
    perm = (piv - 1).to(torch.int32).contiguous()
    for K in ((2, 158) if "lu_solve" in only else ()):
        B = torch.randn(512, 158, K, generator=g, device="cuda")
        X = torch.empty_like(B)
        run = lambda: lu.lu_solve_f32(P(F.data_ptr()), P(perm.data_ptr()),
                                      P(B.data_ptr()), P(X.data_ptr()),
                                      L(512), I(158), I(K), st)
        report(lu, run, f"lu_solve 512 x 158, K={K} float32:")
    # the softplus quadrotor's arrow: past the panel design's shared memory
    M = torch.randn(1, 694, 694, generator=g, device="cuda", dtype=f64)
    M.diagonal(dim1=-2, dim2=-1).mul_(1e-7)
    F, piv = torch.linalg.lu_factor(M)
    F = F.contiguous()
    perm = (piv - 1).to(torch.int32).contiguous()
    for K in ((2, 37) if "lu_solve" in only else ()):
        B = torch.randn(1, 694, K, generator=g, device="cuda", dtype=f64)
        X = torch.empty_like(B)
        run = (lambda B=B, X=X, K=K:
               checked(lu.lu_solve_f64, P(F.data_ptr()), P(perm.data_ptr()),
                       P(B.data_ptr()), P(X.data_ptr()), L(1), I(694), I(K),
                       st))
        report(lu, run, f"lu_solve 1 x 694, K={K} float64:")
    return 0


if __name__ == "__main__":
    sys.exit(main())
