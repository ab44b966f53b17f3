#!/usr/bin/env python3
"""Time the port's kernels in two checkouts on one GPU, at the groups a
chip_smoke.py run checked.

    python3 scripts/torch_ab_kernels.py OTHER_CHECKOUT [RECORD]
        [--from AB_JSON --above R] [--extra JSON] [--rounds N]

RECORD is a chip_smoke.py record (default chiprun_out/chip_smoke.json); its
kernels phase lists every (kernel, dtype, n, K) group and the batch it was
timed at. OTHER_CHECKOUT is an unpacked tree of another commit (for
example `git archive <parent> | tar -x -C _archive/parent`, a git-ignored
directory). Each tree times every group in its own process, in the order
other, this, this, other, on the same inputs (chip_smoke.py's, from the
same seed), 20 launches after a warm-up, by CUDA events: through the
wrappers as chip_smoke.py times them (host and device), and on the device
alone (the 20 launches captured in a CUDA graph and replayed). Prints one
line a group with both trees' times and the ratios of their means, and
writes chiprun_out/ab_kernels.json.

--from takes the groups of an earlier output of this script instead of a
record's, those whose ratio through the wrappers was above --above (all
with 0); --extra adds groups as a JSON list of [kernel, dtype, nb, n, K];
--rounds repeats the four turns (other, this, this, other; then this,
other, other, this; and so on). A group's ratio counts as resolved where
each tree's times through the wrappers spread (max - min over mean) by at
most 5%; its "resolved" key says so.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def time_tree(root, groups):
    """{group: ms} of root's kernels (run in a child process)."""
    import torch

    sys.path.insert(0, root)
    # this checkout's chip_smoke.py (inputs and timers), whichever tree runs
    spec = importlib.util.spec_from_file_location(
        "ab_chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    from scptoolbox_torch.ops import chol_kernels as ck
    from scptoolbox_torch.ops import cuda_lib
    from scptoolbox_torch.ops import gj_kernels as gk
    from scptoolbox_torch.ops import lu_kernels as lk

    libs = {"lu_factor": lk.LIB, "lu_solve": lk.LIB, "gj_inverse": gk.LIB}
    cuda_lib.build_all({libs.get(g[0], ck.LIB) for g in groups})
    gen = torch.Generator(device="cuda")
    out = []
    for kernel, dtname, nb, n, K in groups:
        gen.manual_seed(0)
        run, _, _ = chip_smoke._kernel_case(
            torch, lk, ck, gk, kernel, getattr(torch, dtname), nb, n, K, gen)
        out.append((chip_smoke._time_ms(torch, run, 20),
                    chip_smoke._device_ms(torch, run, 20)))
    return out


def main():
    if sys.argv[1] == "--child":
        groups = json.loads(sys.argv[3])
        print(json.dumps(time_tree(os.path.abspath(sys.argv[2]), groups)))
        return 0
    ap = argparse.ArgumentParser()
    ap.add_argument("other")
    ap.add_argument("record", nargs="?", default=os.path.join(
        HERE, "chiprun_out", "chip_smoke.json"))
    ap.add_argument("--from", dest="ab_from")
    ap.add_argument("--above", type=float, default=0.0)
    ap.add_argument("--extra", default="[]")
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    other = os.path.abspath(args.other)
    if args.ab_from:
        rows = json.load(open(args.ab_from))["groups"]
        groups = {(r["kernel"], r["dtype"], r["nb"], r["n"], r["K"])
                  for r in rows if r["ratio"] > args.above}
    else:
        rows = json.load(open(args.record))["kernels"]
        groups = {(r["kernel"], r["dtype"], r["bound_nb"], r["n"], r["K"])
                  for r in rows}
    groups = sorted(groups | {tuple(g) for g in json.loads(args.extra)})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    times = {"other": [], "this": []}
    turns = []
    for r in range(args.rounds):
        a, b = (("other", other), ("this", HERE))[::1 if r % 2 == 0 else -1]
        turns += [a, b, b, a]
    for tag, root in turns:
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", root,
             json.dumps(groups)], capture_output=True, text=True, check=True)
        times[tag].append(json.loads(res.stdout.strip().splitlines()[-1]))
    table = []
    mean = lambda v: sum(v) / len(v)
    for i, (kernel, dtname, nb, n, K) in enumerate(groups):
        a = [t[i][0] for t in times["other"]]
        b = [t[i][0] for t in times["this"]]
        ad = [t[i][1] for t in times["other"]]
        bd = [t[i][1] for t in times["this"]]
        spread = lambda v: (max(v) - min(v)) / mean(v)
        row = dict(kernel=kernel, dtype=dtname, nb=nb, n=n, K=K,
                   other_ms=a, this_ms=b, ratio=mean(b) / mean(a),
                   other_device_ms=ad, this_device_ms=bd,
                   device_ratio=mean(bd) / mean(ad),
                   resolved=max(spread(a), spread(b)) <= 0.05)
        table.append(row)
        print(json.dumps(row), flush=True)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "ab_kernels.json"), "w") as f:
        json.dump({"card": smi, "other": other, "groups": table}, f,
                  indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
