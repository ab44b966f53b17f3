#!/usr/bin/env python3
"""One scenario batch solved whole and as two halves, on the card.

    python3 scripts/torch_batch_split.py [--out chiprun_out/batch_split.json]

bench.py's double integrator (float32, B=128, _scenario_batch's 10%
spread, 10 iterations) by PTR.solve_batched on the dense Schur KKT (the
Cholesky ladder) at N=31 (bench.py's) and N=15, and on "staged_crpl" at
N=31: the whole batch against its two halves of 64, each solved as a batch
of its own (what each rank of a world of two computes in
parallel.solve_batched_sharded). Prints per configuration the feasible
and SOLVED counts of both, how many scenarios' J_aug differ and by how
much, the largest difference among scenarios SOLVED in both, the
iteration at which each scenario's J_aug trace first differs, and the
scenarios that differ most. Needs the card.
"""

import argparse
import json
import os
import subprocess
import sys
from importlib import import_module

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def split(S, B=128, n_iters=10):
    sys.path.insert(0, REPO)
    import chip_smoke as cs

    bx, bu, bp = cs._scenario_batch(torch, S, B, 0.1)
    h = B // 2
    full = S.solve_batched(bx, bu, bp, n_iters)
    halves = [S.solve_batched(bx[i:i + h], bu[i:i + h], bp[i:i + h],
                              n_iters) for i in (0, h)]
    np_ = lambda k: (full[k].cpu().numpy(), np.concatenate(
        [x[k].cpu().numpy() for x in halves]))
    (J1, J2), (st1, st2), (it1, it2), (f1, f2) = (
        np_(k) for k in ("J_aug", "status", "iters", "feas"))
    dev = np.abs(J2 / J1 - 1.0)
    trace = lambda res: np.stack([np.nan_to_num(t["J_aug"].cpu().numpy())
                                  for t in res["traces"]])
    n_tr = len(full["traces"])
    pad = lambda a: np.concatenate(
        [a, np.zeros((n_tr - a.shape[0], a.shape[1]))]) if (
        a.shape[0] < n_tr) else a
    t1 = trace(full)
    t2 = np.concatenate([pad(trace(x)) for x in halves], axis=1)
    first = [int(np.argmax(t1[:, j] != t2[:, j]))
             if np.any(t1[:, j] != t2[:, j]) else -1 for j in range(B)]
    both = (st1 == 0) & (st2 == 0)
    return dict(
        feasible=[int(f1.sum()), int(f2.sum())],
        solved=[int((st1 == 0).sum()), int((st2 == 0).sum())],
        n_differ=int((dev > 0).sum()), n_differ_1e4=int((dev > 1e-4).sum()),
        max_rel_dev=float(dev.max()),
        max_rel_dev_solved_both=float(dev[both].max()) if both.any()
        else None,
        first_differing_iteration={int(k): int(v) for k, v in zip(
            *np.unique(first, return_counts=True))},
        worst=[dict(i=int(i), rel_dev=float(dev[i]), J_whole=float(J1[i]),
                    J_half=float(J2[i]), status=[int(st1[i]), int(st2[i])],
                    iters=[int(it1[i]), int(it2[i])], first=first[i])
               for i in np.argsort(-dev)[:5]])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                  "batch_split.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_batch_split: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, REPO)
    from scptoolbox_torch.solvers import ptr

    di = import_module("scptoolbox_torch.models.double_integrator")
    pbm = di.double_integrator(di.DoubleIntegratorParameters(
        drag=True, g=0.01, s=30.0))
    out = {}
    for tag, N, Nsub, kkt in (("schur_N31", 31, 15, None),
                              ("schur_N15", 15, 8, None),
                              ("crpl_N31", 31, 15, "staged_crpl")):
        S = ptr.PTR(pbm, ptr.PTRParameters(
            N=N, Nsub=Nsub, wvc=1e3, wtr=5e-3, ipm_tol=3e-6,
            ipm_max_iter=30, kkt_method=kkt), dtype=torch.float32,
            device="cuda")
        out[tag] = split(S)
        print(tag, json.dumps({k: v for k, v in out[tag].items()
                               if k != "worst"}), flush=True)
        for w in out[tag]["worst"]:
            print("   ", json.dumps(w), flush=True)
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(out["card"])
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
