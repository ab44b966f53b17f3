"""The JAX package's LCvx rocket landing at chip_smoke.py's lcvx phase
configuration, on the CPU: solve_lcvx(N=80, tol=1e-3) in float64, and for
comparison N=60 at tol 0.5 (tests/test_rocket_landing.py's configuration).
Prints one JSON line per run: the golden-search flight time, the IPM status
and the fuel cost.

    JAX_PLATFORMS=cpu python -m tests.rocket_lcvx_reference

Not a test: the N=80 search takes minutes on the CPU. Its cost is the
reference chip_smoke.py holds the port to (LCVX_PINS["rocket"]); the pin
429.60033 of tests/reference_costs.json matches neither run.
"""

import json
import time
from importlib import import_module

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

rl = import_module("scptoolbox_tpu.models.rocket_landing")


def main():
    for N, tol in ((80, 1e-3), (60, 0.5)):
        t0 = time.perf_counter()
        sol = rl.solve_lcvx(rl.Rocket(), N=N, tol=tol)
        print(json.dumps(dict(N=N, tol=tol, tf=float(sol.t[-1]),
                              status=int(sol.status), cost=sol.cost,
                              wall_s=time.perf_counter() - t0)), flush=True)


if __name__ == "__main__":
    main()
