#!/usr/bin/env python3
"""Phase timeline of the spread Cholesky factor and the cluster backward
solve (scptoolbox_torch/csrc/chol_kernels.cu) at one float64 matrix, on one
GPU.

    python3 scripts/torch_kernel_timeline.py [n]      # n defaults to 876

No profiler on the card sees inside a kernel, so this copies the source,
inserts %globaltimer stamps at the phase boundaries of block 0 (the factor:
diagonal block and panel rows, first grid barrier, trailing tiles, second
grid barrier; the solve: the cluster barrier's arrive, the copies issued
inside it, its wait, the next panel's owner updating and solving it, the
other rows' update), builds the copy with nvcc into the git-ignored
_archive/timeline/ and loads it with ctypes. Prints, per kernel, the span
of block 0 and the time summed over each kind of phase, with its count.
The stamps cost a few hundred nanoseconds each.
"""

import collections
import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAMP = '''
__device__ unsigned long long g_tlog[8192];
__device__ int g_tag[8192];
#define TS(tag) if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) \\
  { unsigned long long t_; \\
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)); \\
    g_tlog[slot_] = t_; g_tag[slot_++] = tag; }
'''
READ = '''
extern "C" int read_tlog(unsigned long long* h, int* g, int n) {
  cudaMemcpyFromSymbol(g, g_tag, n * 4);
  return (int)cudaMemcpyFromSymbol(h, g_tlog, n * 8);
}
extern "C" int clear_tlog() {
  static int z[8192];
  return (int)cudaMemcpyToSymbol(g_tag, z, sizeof(z));
}
'''
# (pattern, its replacement): the stamps around each phase boundary
EDITS = [
    ("cg::grid_group grid = cg::this_grid();",
     "cg::grid_group grid = cg::this_grid(); int slot_ = 0;"),
    ("cg::cluster_group cluster = cg::this_cluster();",
     "cg::cluster_group cluster = cg::this_cluster(); int slot_ = 0;"),
    ("  grid.sync();\n\n  for (int j0", "  grid.sync(); TS(1);\n\n  for (int j0"),
    ("    __syncthreads();\n\n    // (A) the panel's rows below",
     "    __syncthreads(); TS(2);\n\n    // (A) the panel's rows below"),
    ("    grid.sync();\n\n    // (B)",
     "    TS(3); grid.sync(); TS(4);\n\n    // (B)"),
    ("    grid.sync();\n  }\n}", "    TS(5); grid.sync(); TS(6);\n  }\n}"),
    ("__syncthreads();              // this block is done with panel q - 1",
     "__syncthreads(); TS(11);"),
    ('asm volatile("barrier.cluster.arrive.release;" ::: "memory");',
     'TS(12); asm volatile("barrier.cluster.arrive.release;" ::: "memory");'),
    ('asm volatile("barrier.cluster.wait.acquire;" ::: "memory");',
     'TS(13); asm volatile("barrier.cluster.wait.acquire;" ::: "memory");'
     " TS(14);"),
    ("solve_panel(q + 1, true);",
     "TS(16); solve_panel(q + 1, true); TS(17);"),
]
NAMES = {(1, 2): "diagonal block", (6, 2): "diagonal block",
         (2, 3): "panel rows",
         (3, 4): "grid sync 1", (4, 5): "tiles", (5, 6): "grid sync 2",
         (11, 12): "(block sync)", (12, 13): "copies issued",
         (13, 14): "cluster wait", (14, 16): "(block sync)",
         (16, 17): "owner: its panel's update and solve",
         (17, 11): "other rows update",
         (14, 11): "rows update"}


def build():
    text = open(os.path.join(REPO, "scptoolbox_torch/csrc/chol_kernels.cu")
                ).read()
    for pat, rep in EDITS:
        assert text.count(pat) == 1, pat
        text = text.replace(pat, rep)
    text = text.replace("namespace cg = cooperative_groups;",
                        "namespace cg = cooperative_groups;" + STAMP) + READ
    out = os.path.join(REPO, "_archive", "timeline")
    os.makedirs(out, exist_ok=True)
    cu, so = os.path.join(out, "timed.cu"), os.path.join(out, "libtimed.so")
    with open(cu, "w") as f:
        f.write(text)
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-fmad=false", "-shared",
                    "-Xcompiler", "-fPIC", "-o", so, cu], check=True)
    lib = ctypes.CDLL(so)
    lib.read_tlog.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    return lib


def report(lib, run, what):
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
    print(what, f"block 0 span {(t[-1] - t[0]) / 1e3:.1f} us;",
          "; ".join(f"{k2} {v:.1f} us x{cnt[k2]}" for k2, v in acc.items()),
          flush=True)


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 876
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    lib = build()
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    st = P(torch.cuda.current_stream().cuda_stream)
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    M = torch.randn(1, n, n, generator=g, device="cuda", dtype=torch.float64)
    H = M @ M.mT + n * torch.eye(n, device="cuda", dtype=torch.float64)
    Lf = torch.empty_like(H)
    chol = lambda: lib.cholesky_f64(P(H.data_ptr()), P(Lf.data_ptr()),
                                    L(1), I(n), st)
    chol()
    report(lib, chol, f"cholesky 1 x {n}^2:")
    for K in (2, 566):
        B = torch.randn(1, n, K, generator=g, device="cuda",
                        dtype=torch.float64)
        X = torch.empty_like(B)
        run = lambda: lib.solve_lower_t_f64(P(Lf.data_ptr()), P(B.data_ptr()),
                                            P(X.data_ptr()), L(1), I(n),
                                            I(K), st)
        run()
        report(lib, run, f"solve_lower_t 1 x {n}, K={K}:")
    return 0


if __name__ == "__main__":
    sys.exit(main())
