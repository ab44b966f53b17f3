"""Nothing the benchmark runs loads JAX or the JAX package, and its plain
reference loads nothing of the program. Top-level module names are
compared whole: the port's `scptoolbox_torch` begins with the JAX
package's `scptoolbox_tpu`."""

import ast
import json
import subprocess
import sys
from pathlib import Path

from benchmark.harness import FORBIDDEN

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"


def _static_imports(paths):
    """Top-level names of every import statement in the files."""
    names = set()
    for p in paths:
        for node in ast.walk(ast.parse(p.read_text())):
            if isinstance(node, ast.Import):
                names |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names.add(node.module.split(".")[0])
    return names


def _loaded_after(code):
    """Top-level names in sys.modules after running `code` in a fresh
    interpreter from the repository's root."""
    prog = (f"import sys; sys.path.insert(0, {str(ROOT)!r})\n{code}\n"
            "import json; print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", prog], cwd=ROOT, text=True,
                         capture_output=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_sources_import_no_jax():
    files = [p for p in BENCH.rglob("*.py") if "tests" not in p.parts]
    assert not _static_imports(files) & set(FORBIDDEN)


def test_what_run_loads_holds_no_jax():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    metrics = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    lines = ["import benchmark.run, benchmark.harness as h",
             "import scptoolbox_torch.ops.cuda_lib",
             f"root = h.Path({str(ROOT)!r})",
             f"h.load_readers(root, {metrics!r})"]
    for c in spec["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        lines.append(f"d = h.load_driver(root, {cfg['driver']!r})")
        for path in (cfg["program"]["problem"],
                     cfg["program"]["params_class"],
                     cfg["solver"]["class"], cfg["solver"]["params_class"]):
            lines.append(f"d.resolve({path!r})")
        lines.append("d.Driver.launch_counts()")
    loaded = _loaded_after("\n".join(lines))
    assert "scptoolbox_torch" in loaded
    assert not loaded & set(FORBIDDEN), loaded & set(FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    files = list((BENCH / "reference").rglob("*.py"))
    assert "scptoolbox_torch" not in _static_imports(files)
    models = sorted(p.stem for p in (BENCH / "reference" / "models").glob(
        "[!_]*.py"))
    code = ["import benchmark.reference.check, benchmark.reference.qp",
            "from benchmark.reference.model import load"]
    code += [f"load({str(BENCH / 'reference' / 'models')!r}, {m!r}, {{}}, 11)"
             for m in models]
    loaded = _loaded_after("\n".join(code))
    assert "scptoolbox_torch" not in loaded
    assert not loaded & set(FORBIDDEN)
