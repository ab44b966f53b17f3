"""The control of the comparison, on a card: the program in the precision
below the one the configuration states (TF32 matmuls under float32,
float32 under float64), at each cell's own size and load, for a short
window, comes out not correct on three seeds. Run on the card:

    python3 -m pytest benchmark/tests/test_bench_control.py -q -m cuda
"""

import json
import subprocess
import sys

import pytest

from bench_layout import ROOT

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2 ** 31 + 101, 2 ** 31 + 202,
                                  2 ** 31 + 303])
@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(card, workload, seed):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", workload,
         "--seed", str(seed), "--seconds", "10", "--trace", "0",
         "--control", "1"], cwd=ROOT, capture_output=True, text=True,
        timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is False, result["checks"]
