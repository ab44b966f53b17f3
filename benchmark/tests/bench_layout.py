"""A temporary copy of the benchmark's layout with one tiny cell added, for
the CPU tests: the double integrator's configuration in float64 (so that
sound runs read at round-off) on N nodes, B scenarios, `cap` iterations a
batch, every row of every step checked."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def tiny_layout(tmp: Path, B=4, cap=2, N=31, dtype="float64",
                limits_of="di_f64_schur_b2048", extra_metric=None,
                continue_warm=False):
    """Copy BENCHMARK.json and benchmark/ to tmp and add the cell
    `di_tiny`; returns tmp."""
    tmp = Path(tmp)
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = tmp / "benchmark"
    cfg = json.loads((bench / "configs" / "double_integrator_f64.json"
                      ).read_text())
    cfg["name"], cfg["dtype"] = "di_tiny", dtype
    cfg["solver"]["params"]["N"] = N
    (bench / "configs" / "di_tiny.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "tiny.json").write_text(json.dumps(dict(
        batch=B, spread=0.05, iter_cap=cap, continue_warm=continue_warm,
        check=dict(rows_per_step=B, samples=B * cap))))
    (bench / "limits" / "di_tiny.json").write_text(
        (bench / "limits" / f"{limits_of}.json").read_text())
    spec = json.loads((tmp / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(
        name="di_tiny", source="a test of the benchmark's layout",
        file="benchmark/configs/di_tiny.json", reduced=[], why="tiny"))
    spec["workloads"].append(dict(name="di_tiny", config="di_tiny",
                                  traffic="tiny", chips=1, why="tiny"))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "di_f64_schur_b2048" in m.get("workloads", []):
            m["workloads"].append("di_tiny")
    if extra_metric:
        name, source = extra_metric
        (bench / "metrics" / f"{name}.py").write_text(source)
        spec["per_layer"].append(dict(
            name=name, unit="steps", better="higher",
            source="program_counter", layer="SCP loop",
            moves="solves_per_s", workloads=["di_tiny"]))
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return tmp
