#!/usr/bin/env python3
"""cholesky's shared-memory design against its cooperative spread, on one
GPU, where both apply.

    python3 scripts/torch_chol_switch.py [--out chiprun_out/chol_switch.json]

For a few matrices (fewer than half as many as SMs) of size 33 .. ~320
(float32) or ~225 (float64) the launcher may take either the spread over
several blocks a matrix (cholesky_spread_kernel) or one block a matrix
with the lower triangle in shared memory (cholesky_smem_kernel). This
times both on the same inputs (M M' + n I from a seeded generator) at the
paths' groups of that kind (the rendezvous, quadrotor and free-flyer
ladders in float64, bench.py's 314 in float32 at 64 and 1 matrices) and a
sweep around them: ms a launch on the device alone (20 launches in a CUDA
graph, replayed, by CUDA events), in turns (spread, shared, shared,
spread), each checked bit for bit against the plain version. Prints one
JSON line a shape and writes the table to --out.

The launcher picks one design a shape, so the script builds two copies of
scptoolbox_torch/csrc/ with nvcc into the git-ignored _archive/chol_switch/,
each with the launcher's choice pinned to one of the two designs by a
source edit, and loads them with ctypes; the shipped library is unchanged.
"""

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from scptoolbox_torch.ops import chol_kernels as ck  # noqa: E402

# (dtype, nb, n): the paths' spread groups that fit in shared memory, and
# a sweep
SHAPES = ([("float64", 1, n) for n in (102, 126, 146, 160, 186, 201, 209,
                                       224)]
          + [("float64", nb, n) for nb, n in ((8, 186), (12, 187),
                                              (20, 194), (4, 146))]
          + [("float32", nb, n) for nb, n in ((1, 102), (1, 200), (1, 314),
                                              (8, 314), (32, 314),
                                              (64, 314), (64, 200))])
SPREAD, SHARED = 3, 1
# the launcher's choice, and the pin that replaces it in a copy
CHOICE = """  e = cholesky_variant<T>(nb, n, d, &variant, &bpm);
  if (e != cudaSuccess) return (int)e;
"""
PIN = """  if (bpm < 2 || !(n > kW && smem_chol_fits<T>(n, cap)))
    return (int)cudaErrorInvalidValue;
  variant = {};
"""


def build_pinned():
    """{variant: CDLL} of chol_kernels.cu built with the launcher's choice
    pinned to the spread and to the shared-memory design."""
    src = os.path.join(REPO, "scptoolbox_torch", "csrc")
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    procs = {}
    for v in (SPREAD, SHARED):
        out = os.path.join(REPO, "_archive", "chol_switch", str(v))
        shutil.rmtree(out, ignore_errors=True)
        shutil.copytree(src, out)
        path = os.path.join(out, "chol_kernels.cu")
        text = open(path).read()
        assert text.count(CHOICE) == 1, "the launcher's choice moved"
        with open(path, "w") as f:
            f.write(text.replace(CHOICE, CHOICE + PIN.format(v)))
        so = os.path.join(out, "libchol_pinned.so")
        procs[v] = (so, subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-o",
             so, path]))
    libs = {}
    for v, (so, proc) in procs.items():
        assert proc.wait() == 0, f"nvcc failed on the copy pinned to {v}"
        libs[v] = ctypes.CDLL(so)
    return libs


def device_ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    graph.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                  "chol_switch.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_chol_switch: no CUDA device", file=sys.stderr)
        return 2
    lib = ck.LIB.load()
    pinned = build_pinned()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    gen = torch.Generator(device="cuda")
    rows = []
    for dtname, nb, n in SHAPES:
        dt = getattr(torch, dtname)
        sfx = "f32" if dt == torch.float32 else "f64"
        design = getattr(lib, f"chol_design_{sfx}")
        if design(0, nb, n, n) < 2 and design(3, nb, n, n) != SHARED:
            continue                 # neither design in question applies
        gen.manual_seed(n + nb)
        M = torch.randn(nb, n, n, generator=gen, device="cuda", dtype=dt)
        H = M @ M.mT + n * torch.eye(n, device="cuda", dtype=dt)
        ref = ck.cholesky_plain(H)
        outs, launch = {}, {}
        for v in (SPREAD, SHARED):
            fn = getattr(pinned[v], f"cholesky_{sfx}")
            L = torch.empty_like(H)
            outs[v] = L
            # the stream current at the call (a graph captures its own)
            launch[v] = (lambda fn=fn, L=L: fn(
                ctypes.c_void_p(H.data_ptr()), ctypes.c_void_p(L.data_ptr()),
                ctypes.c_longlong(nb), ctypes.c_int(n), ctypes.c_void_p(
                    torch.cuda.current_stream().cuda_stream)))
            rc = launch[v]()
            assert rc == 0, (dtname, nb, n, v, rc)
        torch.cuda.synchronize()
        same = {v: bool(torch.equal(outs[v], ref)) for v in outs}
        times = {v: [] for v in launch}
        for v in (SPREAD, SHARED, SHARED, SPREAD):
            times[v].append(device_ms(launch[v]))
        mean = lambda x: sum(x) / len(x)
        row = dict(dtype=dtname, nb=nb, n=n,
                   taken=design(3, nb, n, n),
                   spread_blocks=design(0, nb, n, n),
                   spread_ms=times[SPREAD], shared_ms=times[SHARED],
                   shared_over_spread=mean(times[SHARED]) /
                   mean(times[SPREAD]),
                   bit_for_bit=same[SPREAD] and same[SHARED])
        rows.append(row)
        print(json.dumps(row), flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
