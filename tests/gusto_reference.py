"""The JAX package's GuSTO results that chip_smoke.py holds the port to
where no pin covers them, on the CPU in float64:

  * the softplus quadrotor solve, tests/test_quadrotor.py:69-70's
    configuration (N=30, Nsub=15, iter_max=20, pen="softplus", hom=500,
    lam_init=1e3): status, iterations, IPM loops and statuses, cost
    (GUSTO_SOFTPLUS_JAX);
  * one GuSTO step on the free-flyer (N=30, Nsub=10, the quad penalty) from
    the model's raw guess at eta_init and lam_init, the step the serial
    solve takes: IPM status and iterations, L, L_aug, J_aug, rho, viol and
    the defect norm (FREEFLYER_STEP_JAX).

Prints one JSON line for each.

    JAX_PLATFORMS=cpu python -m tests.gusto_reference [softplus|freeflyer]

Not a test: the softplus solve takes minutes on the CPU.
"""

import json
import sys
import time
from importlib import import_module

import jax
import jax.numpy as jnp

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

gusto = import_module("scptoolbox_tpu.solvers.gusto")
quad = import_module("scptoolbox_tpu.models.quadrotor")
ff = import_module("scptoolbox_tpu.models.freeflyer")


def softplus():
    t0 = time.perf_counter()
    sol = gusto.solve(quad.quadrotor(quad.QuadrotorParameters()),
                      gusto.GuSTOParameters(N=30, Nsub=15, iter_max=20,
                                            pen="softplus", hom=500.0,
                                            lam_init=1e3))
    print(json.dumps(dict(
        run="quadrotor_gusto_softplus", status=int(sol.status),
        feas=bool(sol.feas), iterations=sol.iterations,
        ipm_iters=[h.ipm_iters for h in sol.history],
        ipm_status=[h.ipm_status for h in sol.history], cost=sol.cost,
        wall_s=time.perf_counter() - t0)), flush=True)


def freeflyer_step():
    t0 = time.perf_counter()
    G = gusto.GuSTO(ff.freeflyer(ff.FreeFlyerParameters(), N=30),
                    gusto.GuSTOParameters(N=30, Nsub=10))
    pars = G.pars
    lam = jnp.asarray(pars.lam_init, G.dtype)
    _, dltv = G._ref_J_aug(*G._guess, lam, G.consts)
    out = G._step(*G._guess, dltv, jnp.asarray(pars.eta_init, G.dtype), lam,
                  G.consts)
    print(json.dumps(dict(
        run="freeflyer_gusto_step", n=G.tmpl.n, m=G.tmpl.m, nz=G.spec.nz,
        ipm_status=int(out["ipm_status"]), ipm_iters=int(out["ipm_iters"]),
        **{k: float(out[k]) for k in ("L", "L_aug", "J_aug", "rho", "viol",
                                      "defect_norm")},
        wall_s=time.perf_counter() - t0)), flush=True)


if __name__ == "__main__":
    which = sys.argv[1:] or ["softplus", "freeflyer"]
    for name in which:
        {"softplus": softplus, "freeflyer": freeflyer_step}[name]()
