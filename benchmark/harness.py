"""One run of one cell of the benchmark: set-up, the measured window, the
traced reading and the comparison with the plain reference.

Everything that belongs to one configuration, traffic mix, metric, window
driver or cell sits in a file of its own, found by the name
`BENCHMARK.json` or the configuration gives:

    benchmark/configs/<config>.json   the solver, its model and precision
    benchmark/traffic/<traffic>.json  batch, dispersion law, iteration cap
    benchmark/drivers/<driver>.py     Driver: the window's calls into the
                                      program and its reference check
    benchmark/metrics/<metric>.py     read(record) -> value or None, for
                                      end-to-end and per-layer metrics
                                      (`<base>.<use>`: `<base>.py`)
    benchmark/limits/<workload>.json  the limit of each compared number
    benchmark/reference/models/<reference_model>.py

The window starts batches of scenarios one after the other, each stepped
one batched iteration at a time until the driver reports it stopped; it
closes at the end of the first step that ends after `seconds`. Where the
driver's warm work returns its batch (the traffic's `continue_warm`), the
window goes on with that batch first.
"""

from __future__ import annotations

import bisect
import collections
import importlib.util
import json
import sys
import time
from pathlib import Path

import torch

FORBIDDEN = ("jax", "jaxlib", "flax", "scptoolbox_tpu")
PROFILED_STEPS = (1, 2)     # the window's steps the device trace covers


def load_cell(root: Path, workload: str):
    """(config, traffic, limits, BENCHMARK.json) of `workload`."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cell = next(w for w in spec["workloads"] if w["name"] == workload)
    entry = next(c for c in spec["configs"] if c["name"] == cell["config"])
    cfg = json.loads((root / entry["file"]).read_text())
    bench = root / "benchmark"
    traffic = json.loads((bench / "traffic" / f"{cell['traffic']}.json"
                          ).read_text())
    limits = json.loads((bench / "limits" / f"{workload}.json").read_text())
    return cfg, traffic, limits, spec


def cell_metrics(spec, workload, trace):
    """The metric entries this cell reports: its end-to-end metrics
    (trace 0) or its per-layer metrics (trace 1)."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def _load_file(path: Path, prefix: str):
    spec = importlib.util.spec_from_file_location(
        prefix + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_driver(root: Path, name: str):
    """The window driver `benchmark/drivers/<name>.py`."""
    return _load_file(Path(root) / "benchmark" / "drivers" / f"{name}.py",
                      "_bench_driver_")


def reader_path(root: Path, name: str) -> Path:
    """The reader of metric `name`: `benchmark/metrics/<name>.py`, else,
    for a quantity split by the cells that report it (`<base>.<use>`),
    the reader of its base, `benchmark/metrics/<base>.py`."""
    metrics = Path(root) / "benchmark" / "metrics"
    own = metrics / f"{name}.py"
    return own if own.exists() else metrics / f"{name.split('.')[0]}.py"


def load_readers(root: Path, names):
    """read(record) of each metric, its file found by `reader_path`."""
    return {name: _load_file(reader_path(root, name), "_bench_metric_").read
            for name in names}


class Spans:
    """Synchronized host-clock spans around the solver's calls that the
    driver names (the traced run only): seconds by call for each
    step, and (start, end, name) in wall-clock ns, the profiler's clock,
    to label the card's idle gaps."""

    def __init__(self, solver, names, sync):
        self.solver, self.sync = solver, sync
        self.totals = collections.defaultdict(float)
        self.ranges = []
        self.inner = {}
        for name in names:
            self.inner[name] = getattr(solver, name)
            setattr(solver, name, self._wrap(name, self.inner[name]))

    def _wrap(self, name, fn):
        def timed(*a, **kw):
            self.sync()
            t0, w0 = time.perf_counter(), time.time_ns()
            out = fn(*a, **kw)
            self.sync()
            self.totals[name] += time.perf_counter() - t0
            self.ranges.append((w0, time.time_ns(), name.lstrip("_")))
            return out
        return timed

    def take(self):
        out, self.totals = dict(self.totals), collections.defaultdict(float)
        return out

    def remove(self):
        for name, fn in self.inner.items():
            setattr(self.solver, name, fn)


def _device_events(prof):
    """[(start_ns, end_ns, name)] of the device's operations in a finished
    profiler (CUDA activity only), on the wall clock."""
    return [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
            for e in prof.profiler.kineto_results.events()
            if str(e.device_type()).endswith("CUDA")]


def _union(intervals):
    merged = []
    for s, t in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    return merged


def read_profile(dev, ranges, t_lo, t_hi):
    """Busy seconds, kernel seconds by name and idle seconds by the host
    span they fall in ("loop" outside the spans), within [t_lo, t_hi] ns."""
    dev = [(max(s, t_lo), min(t, t_hi), n) for s, t, n in dev
           if t > t_lo and s < t_hi]
    by_name = collections.defaultdict(float)
    for s, t, n in dev:
        by_name[n] += (t - s) * 1e-9
    busy = _union((s, t) for s, t, _ in dev)
    busy_s = sum(t - s for s, t in busy) * 1e-9
    gaps, prev = [], t_lo
    for s, t in busy + [[t_hi, t_hi]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)
    ranges = sorted(ranges)
    starts = [r[0] for r in ranges]
    idle = collections.defaultdict(float)
    for s, t in gaps:
        mid = 0.5 * (s + t)
        k = bisect.bisect_right(starts, mid) - 1
        label = ranges[k][2] if k >= 0 and ranges[k][1] >= mid else "loop"
        idle[label] += (t - s) * 1e-9
    return dict(busy_s=busy_s, window_s=(t_hi - t_lo) * 1e-9,
                kernels=dict(by_name), idle=dict(idle))




def _stop_profile(prof, drv, w_lo):
    """End the device trace: the profiler, the launch shapes recorded under
    it, and its steps' [lo, hi] in wall-clock ns."""
    w_hi = time.time_ns()
    shapes = drv.shapes_off()
    t0 = time.perf_counter()
    prof.__exit__(None, None, None)
    return dict(prof=prof, shapes=shapes, lo=w_lo, hi=w_hi,
                stop_s=time.perf_counter() - t0)


def run(root, workload, seed, seconds, trace, device, t_start,
        control=False, log=print):
    """One run of `workload`. Returns (result dict without `checks`,
    [(number, value, limit)], details) with the result's `correct`
    decided. `control` runs the program in the precision below the one
    the configuration states (its "control" entry): the control of the
    comparison, which has to come out not correct."""
    root = Path(root)
    cfg, traffic, limits, spec = load_cell(root, workload)
    if control:
        cfg = dict(cfg, **cfg["control"])
    device = torch.device(device)
    cuda = device.type == "cuda"
    tf32 = bool(cfg.get("tf32", False))
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (
        lambda: None)
    log(f"[bench] {workload} seed {seed} seconds {seconds} trace {trace} "
        f"dtype {cfg['dtype']} tf32 matmul {tf32} cudnn {tf32} host "
        f"threads {torch.get_num_threads()}")

    # ---- set-up: build, then the driver's warm work at the cell's size
    drv = load_driver(root, cfg["driver"]).Driver(cfg, traffic, seed, device)
    warm = drv.warm()
    sync()
    setup_s = time.time() - t_start
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    # ---- the window
    drv.record(True)
    spans = Spans(drv.solver, drv.spans, sync) if trace else None
    launches0 = drv.launch_counts() if trace else None
    prof = profile = None
    steps, batches = [], []
    t0 = time.perf_counter()
    closed = False
    while not closed:
        tb = time.perf_counter()
        if warm is not None:    # the batch set-up started, continued
            batch, warm = warm, None
        else:
            batch = drv.start(batches[-1]["index"] + 1 if batches else 1)
        batch["first_step"] = len(steps)
        batches.append(batch)
        it = batch.get("first_it", 0)
        while True:
            k = len(steps)
            if trace and k == PROFILED_STEPS[0] and cuda:
                # device activity only: the host's own ops would make the
                # trace too large to read inside a run's time
                prof = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CUDA])
                prof.__enter__()
                drv.shapes_on()
                w_lo = time.time_ns()
            ran = drv.step(batch, it)
            sync()
            t1 = time.perf_counter()
            if not ran:
                break
            steps.append(dict(wall_s=t1 - tb, batch=len(batches) - 1, it=it,
                              profiled=prof is not None,
                              spans=spans.take() if spans else {}))
            tb = t1
            it += 1
            if prof is not None and k == PROFILED_STEPS[-1]:
                profile = _stop_profile(prof, drv, w_lo)
                prof = None
                # reading the trace is no part of the window
                tb += profile["stop_s"]
                t0 += profile["stop_s"]
            if t1 - t0 >= seconds:
                closed = True
                break
    window_s = time.perf_counter() - t0
    if prof is not None:            # the window closed inside the trace
        profile = _stop_profile(prof, drv, w_lo)
    drv.record(False)
    if spans:
        spans.remove()
    launches = ({k: v - launches0[k] for k, v in drv.launch_counts().items()}
                if trace else None)

    # ---- what the window did
    done = drv.tally(batches, steps)
    log(f"[bench] window {window_s} s, {len(steps)} steps, {len(batches)} "
        f"batches from iteration {steps[0]['it'] if steps else 0}, "
        f"{done['note']}; step walls "
        f"{[round(s['wall_s'], 3) for s in steps]} s")
    peak = (torch.cuda.max_memory_allocated(device) if cuda else 0)
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    rec = dict(steps=steps, window_s=window_s, setup_s=setup_s,
               stop_iters=done["stop_iters"],
               attempted=done["attempted"], launches=launches, profile=None)
    device_info = dict(platform="gpu" if cuda else "cpu", kind=kind,
                       count=1, memory_peak_bytes=int(peak))
    breakdown = None
    dev = _device_events(profile["prof"]) if profile is not None else []
    if profile is not None and not dev:
        log("[bench] device trace: no device operation recorded")
    if dev:
        t_parse = time.perf_counter()
        lo, hi = profile["lo"], profile["hi"]
        got = read_profile(dev, spans.ranges, lo, hi)
        got["shapes"] = profile["shapes"]
        log(f"[bench] device trace: {len(dev)} operations, from "
            f"{(min(d[0] for d in dev) - lo) * 1e-9} s to "
            f"{(max(d[1] for d in dev) - hi) * 1e-9} s of the traced "
            f"steps' ends, read in "
            f"{time.perf_counter() - t_parse + profile['stop_s']} s")
        rec["profile"] = got
        device_info.update(busy_s=got["busy_s"], window_s=got["window_s"])
        top = sorted(got["kernels"].items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(got["idle"].items(), key=lambda kv: -kv[1])[:10]
        breakdown = dict(device_ops=[[n[:120], s] for n, s in top],
                         idle_gaps=[[n, s] for n, s in gaps])
    del profile, dev

    metrics = {}
    entries = cell_metrics(spec, workload, trace)
    readers = load_readers(root, [m["name"] for m in entries])
    for m in entries:
        v = readers[m["name"]](rec)
        if v is not None:
            metrics[m["name"]] = dict(value=v, unit=m["unit"])

    # ---- the comparison with the reference, the program's state freed
    samples = drv.sample(batches, device)
    del batches
    drv.free()
    if cuda:
        torch.cuda.empty_cache()
    numbers, details = drv.check(root, samples, device)
    compared = [(k, numbers[k], float(limits[k])) for k in sorted(numbers)]
    correct = all(v <= lim for _, v, lim in compared)
    result = dict(correct=bool(correct), attempted=int(done["attempted"]),
                  failed=int(done["failed"]), metrics=metrics,
                  device=device_info)
    if breakdown is not None:
        result["breakdown"] = breakdown
    return result, compared, details


def forbidden_modules():
    """Top-level names of loaded modules that the benchmark must not load."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))
