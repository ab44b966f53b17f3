"""How the Starship guess depends on the dense Schur KKT's path, on the CPU.

The guess's terminal-descent program (models/starship_flip.py
`_descent_program`) is a feasibility program with a 1e-8 thrust cost, so
its IPM stops anywhere on a wide optimal face, and the point depends on the
KKT path: LU of the whole system (the CPU path, on which the pin
tests/reference_costs.json "starship_ptr" was made) or the Cholesky ladder
(the accelerator path, the port's on the card). This script computes the
guess both ways in both packages (the port's ladder on its plain versions),
prints the relative differences, and then runs the JAX package's serial
float64 PTR (tests/test_starship.py's configuration) from each JAX guess.
Prints one JSON line per result.

    JAX_PLATFORMS=cpu python -m tests.starship_ladder_reference

Not a test: the two PTR solves take minutes on the CPU. chip_smoke.py's
float64 Starship phase builds its guess on the CPU for this reason.
"""

import json
import time
from importlib import import_module

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import torch  # noqa: E402

jipm = import_module("scptoolbox_tpu.ops.ipm")
jsf = import_module("scptoolbox_tpu.models.starship_flip")
jptr = import_module("scptoolbox_tpu.solvers.ptr")
tipm = import_module("scptoolbox_torch.ops.ipm")
tsf = import_module("scptoolbox_torch.models.starship_flip")

PIN = 0.652614102582893          # tests/reference_costs.json "starship_ptr"


def _forcing(mod, use_lu):
    """A context that makes mod._SchurKKT take LU (True) or the ladder."""
    orig = mod._SchurKKT.__init__

    class Force:
        def __enter__(self):
            def init(kkt, *a, **k):
                orig(kkt, *a, **k)
                kkt.use_lu = use_lu
            mod._SchurKKT.__init__ = init

        def __exit__(self, *exc):
            mod._SchurKKT.__init__ = orig

    return Force()


def main():
    torch.set_num_threads(1)
    mdl_j, mdl_t = jsf.StarshipParameters(), tsf.StarshipParameters()
    pbms, guesses = {}, {}
    for path, use_lu in (("lu", True), ("ladder", False)):
        jax.clear_caches()       # the guess program's IPM is traced once
        with _forcing(jipm, use_lu):
            pbms[path] = jsf.starship(mdl_j, N=31)
        with _forcing(tipm, use_lu):
            pbm_t = tsf.starship(mdl_t, N=31, device="cpu")
        guesses[("jax", path)] = [np.asarray(a) for a in pbms[path].guess(31)]
        guesses[("port", path)] = [np.asarray(a) for a in pbm_t.guess(31)]

    def rel(a, b):
        return [float(np.abs(x - y).max() / np.abs(y).max())
                for x, y in zip(guesses[a][:2], guesses[b][:2])]

    for a, b in ((("port", "lu"), ("jax", "lu")),
                 (("port", "ladder"), ("jax", "ladder")),
                 (("jax", "ladder"), ("jax", "lu"))):
        print(json.dumps(dict(guess=f"{a[0]} {a[1]} vs {b[0]} {b[1]}",
                              rel_diff_x_u=rel(a, b))), flush=True)

    pars = jptr.PTRParameters(N=31, Nsub=30, iter_max=15, wvc=1e3, wtr=0.1,
                              eps_abs=1e-5, eps_rel=1e-4, feas_tol=5e-3)
    for path, pbm in pbms.items():
        t0 = time.perf_counter()
        sol = jptr.solve(pbm, pars)
        print(json.dumps(dict(guess=path, status=str(sol.status),
                              iterations=sol.iterations, cost=sol.cost,
                              pin_rel_dev=sol.cost / PIN - 1.0,
                              wall_s=time.perf_counter() - t0)), flush=True)


if __name__ == "__main__":
    main()
