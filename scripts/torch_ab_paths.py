#!/usr/bin/env python3
"""Compare two checkouts of the PyTorch port on one GPU: the host time of
each Cholesky-ladder wrapper call, and the walls of chip_smoke.py's
oscillator and LCvx phases (the single-program cells).

    python3 scripts/torch_ab_paths.py OTHER_CHECKOUT

OTHER_CHECKOUT is an unpacked tree of another commit (for example
`git archive <parent> | tar -x -C _archive/parent`, a git-ignored
directory). The phases run in the order other, this, this, other, each in
its own process, so that the two trees see the same card in turns. Prints
one line per measurement.
"""

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def host_times(root):
    """ms per call on the host (no synchronisation) and per call overall,
    for cholesky / solve_lower / solve_lower_t at one float64 matrix."""
    import torch

    sys.path.insert(0, root)
    from scptoolbox_torch.ops import chol_kernels as ck

    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    out = []
    for n, K in ((876, 2), (876, 566), (541, 2)):
        M = torch.randn(1, n, n, generator=g, device="cuda",
                        dtype=torch.float64)
        H = M @ M.mT + n * torch.eye(n, device="cuda", dtype=torch.float64)
        L = ck.cholesky(H)
        B = torch.randn(1, n, K, generator=g, device="cuda",
                        dtype=torch.float64)
        calls = (("cholesky", lambda: ck.cholesky(H)),
                 ("solve_lower", lambda: ck.solve_lower(L, B)),
                 ("solve_lower_t", lambda: ck.solve_lower_t(L, B)))
        for name, fn in calls:
            if name == "cholesky" and K != 2:
                continue
            fn()
            torch.cuda.synchronize()
            reps = 200
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            host = (time.perf_counter() - t0) / reps * 1e3
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / reps * 1e3
            out.append(dict(kernel=name, n=n, K=K, host_ms=host,
                            wall_ms=wall))
    return out


def phase_walls(root):
    """Walls and costs of chip_smoke.py --phases oscillator,lcvx in root."""
    t0 = time.time()
    # one phase after another, each wall alone (trees that share the
    # phases over worker processes take --workers)
    with open(os.path.join(root, "chip_smoke.py")) as f:
        alone = ["--workers", "1"] if "--workers" in f.read() else []
    r = subprocess.run([sys.executable, "chip_smoke.py", "--phases",
                        "oscillator,lcvx"] + alone, cwd=root,
                       capture_output=True, text=True)
    recs = {}
    for line in r.stdout.splitlines():
        if line.startswith("[oscillator] {"):
            recs["oscillator"] = json.loads(line.split(" ", 1)[1])
        elif line.startswith("[lcvx] ") and " {" in line:
            _, name, js = line.split(" ", 2)
            recs[name] = json.loads(js)
    assert r.returncode == 0, r.stderr[-2000:]
    return dict(process_s=time.time() - t0,
                walls={k: v["wall_s"] for k, v in recs.items()},
                costs={k: v["cost"] for k, v in recs.items()})


def main():
    other = os.path.abspath(sys.argv[1])
    if len(sys.argv) > 2:                   # the child: one tree's host times
        print(json.dumps(host_times(sys.argv[2])), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    for tag, root in (("other", other), ("this", HERE)):
        r = subprocess.run([sys.executable, os.path.abspath(__file__), other,
                            root], capture_output=True, text=True, cwd=root)
        assert r.returncode == 0, r.stderr[-2000:]
        print("host", tag, r.stdout.strip(), flush=True)
    for tag, root in (("other", other), ("this", HERE), ("this", HERE),
                      ("other", other)):
        print("phases", tag, json.dumps(phase_walls(root)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
