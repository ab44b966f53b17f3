"""Run one cell of the benchmark once and print its result.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Needs a CUDA card (as many as the cell asks
for); exits with a code other than 0, printing no result, without one, or
if the process has loaded JAX or the JAX package once the window has
closed. The last line of standard output is the result as one JSON object;
the last lines of standard error give each compared number beside its
limit. `--control 1` runs the program in the precision below the one the
configuration states (TF32 matmuls for float32, float32 for float64): the
control of the comparison, which has to come out not correct; never a
measurement.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def process_start() -> float:
    """Wall-clock time at which this process started (Linux), else now."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        ticks = int(fields[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


T_START = process_start()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # kernel and compiler caches at fixed places inside the checkout
    cache = ROOT / ".bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    cell = cells[args.workload]
    entry = next(c for c in spec["configs"] if c["name"] == cell["config"])
    threads = json.loads((ROOT / entry["file"]).read_text()).get(
        "host_threads", {}).get("count")
    if threads:         # the configuration's host threads, else the default
        for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
            os.environ[var] = str(threads)
    sys.path.insert(0, str(ROOT))
    import torch
    if threads:
        torch.set_num_threads(int(threads))

    from benchmark import harness

    chips = int(cell["chips"])
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"needs {chips} CUDA device(s); found {found}", file=sys.stderr)
        return 1
    log = lambda *a: print(*a, file=sys.stderr, flush=True)
    result, compared, details = harness.run(
        ROOT, args.workload, args.seed, args.seconds, args.trace, "cuda",
        T_START, control=bool(args.control), log=log)
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded modules the benchmark must not load: {bad}",
              file=sys.stderr)
        return 3
    result["checks"] = {k: dict(value=v, limit=lim) for k, v, lim in compared}
    log("[bench] details " + json.dumps(details))
    print(json.dumps(result), flush=True)
    for k, v, lim in compared:
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
