"""The harness is driven by data: a configuration, a traffic mix, a
per-layer metric, an end-to-end metric and a cell's limits, each a new
file in a copy of the layout, are found by name and run on the CPU at a
tiny size, and no file that was there changes."""

import hashlib
import json
import time

import numpy as np
import torch

from bench_layout import ROOT, tiny_layout
from benchmark import harness

ptr_batched = harness.load_driver(ROOT, "ptr_batched")


def _digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_files_found_by_name(tmp_path):
    torch.set_num_threads(2)
    before = None
    root = tiny_layout(tmp_path, B=3, cap=1, extra_metric=(
        "steps_in_window", "def read(rec):\n    return len(rec['steps'])\n"))
    # an end-to-end metric of its own, found by name like the others
    (root / "benchmark" / "metrics" / "steps_per_s.py").write_text(
        "def read(rec):\n    return len(rec['steps']) / rec['window_s']\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["end_to_end"].append(dict(
        name="steps_per_s", unit="steps/s", better="higher", bound=0.25,
        source="host_clock", workloads=["di_tiny"]))
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    before = _digest(root)
    for trace in (0, 1):
        result, compared, details = harness.run(
            root, "di_tiny", 2 ** 31 + 12345, 0.5, trace, "cpu",
            time.time())
        assert result["correct"], (compared, details)
        names = set(result["metrics"])
        spec = json.loads((root / "BENCHMARK.json").read_text())
        want = {m["name"] for m in harness.cell_metrics(spec, "di_tiny",
                                                        trace)}
        # the device readings need a card; the rest is read on the CPU
        assert names <= want
        if trace:
            assert result["metrics"]["steps_in_window"]["value"] >= 1
            assert "ipm_loops_per_step.campaign" in names
        else:
            assert names == want
            assert result["metrics"]["steps_per_s"]["value"] > 0
        assert {k for k, _, _ in compared} == {"cost", "step"}
    assert _digest(root) == before


def test_window_continues_the_warm_batch(tmp_path):
    """With the traffic's `continue_warm`, the window's first steps are the
    set-up batch's later iterations, which alone count as its work, and the
    reference judges them like any other."""
    torch.set_num_threads(2)
    root = tiny_layout(tmp_path, B=3, cap=3, continue_warm=True)
    lines = []
    result, compared, details = harness.run(
        root, "di_tiny", 2 ** 31 + 777, 0.5, 0, "cpu", time.time(),
        log=lines.append)
    assert result["correct"], (compared, details)
    window = next(x for x in lines if x.startswith("[bench] window"))
    n_steps = int(window.split(" s, ")[1].split()[0])
    assert "batches from iteration 1," in window
    assert n_steps >= 1 and result["attempted"] <= 3 * n_steps


def test_every_cell_reports_what_its_metrics_move():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = [w["name"] for w in spec["workloads"]]
    e2e = {m["name"]: set(m.get("workloads", cells))
           for m in spec["end_to_end"]}
    for cell in cells:
        reported = {n for n, ws in e2e.items() if cell in ws}
        assert "setup_s" in reported and len(reported) >= 2, cell
        assert harness.cell_metrics(spec, cell, 1), cell
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert harness.reader_path(ROOT, m["name"]).exists(), m["name"]
    for m in spec["per_layer"]:
        for cell in m.get("workloads", cells):
            assert cell in e2e[m["moves"]], (m["name"], cell)


def test_seed_gives_the_same_inputs():
    a = ptr_batched.multipliers(2 ** 31 + 5, 3, 64, 0.05)
    b = ptr_batched.multipliers(2 ** 31 + 5, 3, 64, 0.05)
    c = ptr_batched.multipliers(2 ** 31 + 6, 3, 64, 0.05)
    assert (a == b).all() and not (a == c).all()
    assert abs(a - 1.0).max() <= 0.05
    # at the strata's midpoints every seed draws one set, in its own order
    d = ptr_batched.multipliers(2 ** 31 + 5, 3, 64, 0.05, midpoints=True)
    e = ptr_batched.multipliers(2 ** 31 + 6, 3, 64, 0.05, midpoints=True)
    assert not (d == e).all() and (np.sort(d) == np.sort(e)).all()
    assert abs(d - 1.0).max() < 0.05
    # one draw in each stratum: every seed the same spread of work
    assert sorted(((a - 0.95) / 0.1 * 64).astype(int)) == list(range(64))
