"""The JAX package's side of two chip_smoke.py phases, on the CPU.

    JAX_PLATFORMS=cpu python -m tests.staged_reference ptr_lu
    JAX_PLATFORMS=cpu python -m tests.staged_reference ptr_lu_nudged
    JAX_PLATFORMS=cpu python -m tests.staged_reference crqd_ipm

ptr_lu (starship_f64_staged_lu): the JAX package's batched PTR on the
Starship flip in float64 (N=31, the parameters of bench.py:95-104, 15 SCP
iterations) from B=4 guesses spread by 2% in x, on kkt_method="staged_lu":
each scenario's status, iterations, cost and feasibility, and per
iteration the stopping rule's quantities (deviation, improv_rel, feas).
ptr_lu_nudged: the same from guesses scaled by 1 + 1e-12.

crqd_ipm (starship_crqd_kkt): the first Starship subproblems in float32 at
B=32 guesses spread by 2% (assembled in float64, as
tests/fgmres_depth_reference.py does, then cast), solved by the JAX IPM on
StagedCRQD (FGMRES(16)) with the phase's tolerances: each scenario's
status, iterations and duality gap.

Each prints one JSON line with the wall time on this CPU (compilation
included). Not a test: each run takes many minutes on the CPU.
"""

import json
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from scptoolbox_tpu.ops import aug_kkt, ipm  # noqa: E402
from scptoolbox_tpu.solvers import ptr  # noqa: E402
from tests import torch_refs as refs  # noqa: E402

SPREAD = 0.02


def _guesses(solver, B):
    gx, gu, gp = (np.asarray(a) for a in solver._guess)
    scale = (1.0 + SPREAD * (np.arange(B) / B - 0.5))[:, None, None]
    return (jnp.asarray(gx[None] * scale),
            jnp.asarray(np.broadcast_to(gu, (B,) + gu.shape)),
            jnp.asarray(np.broadcast_to(gp, (B,) + gp.shape)))


def ptr_lu(pbm, B=4, nudge=0.0):
    solver = ptr.PTR(pbm, ptr.PTRParameters(**dict(refs.SS_PARS,
                                                   kkt_method="staged_lu")),
                     dtype=jnp.float64)
    bx, bu, bp = _guesses(solver, B)
    out = solver.solve_batched(bx * (1.0 + nudge), bu, bp, 15)
    cost = jax.vmap(lambda x, u, p: solver.tmpl.original_cost(
        x, u, p, solver.consts))(out["x"], out["u"], out["p"])
    # the stopping rule's quantities, an iteration a row, a scenario a
    # column (NaN once a scenario has stopped)
    tr = out["traces"]
    trace = {k: np.asarray(tr[k], np.float64)[:int(np.max(out["iters"]))]
             .tolist() for k in ("deviation", "improv_rel", "feas")}
    return dict(B=B, nudge=nudge, status=np.asarray(out["status"]).tolist(),
                iters=np.asarray(out["iters"]).tolist(),
                cost=np.asarray(cost, np.float64).tolist(),
                feas=np.asarray(out["feas"]).tolist(), trace=trace)


def ptr_lu_nudged(pbm, B=4):
    """ptr_lu from guesses scaled by 1 + 1e-12: a perturbation at the size
    of the rounding that separates two machines' runs."""
    return ptr_lu(pbm, B, nudge=1e-12)


def crqd_ipm(pbm, B=32):
    solver = ptr.PTR(pbm, ptr.PTRParameters(**refs.SS_PARS),
                     dtype=jnp.float64)
    A, b, c, const = jax.jit(jax.vmap(lambda x, u, p: solver._assemble(
        x, u, p, solver._discretize(x, u, p), solver.consts)))(
            *_guesses(solver, B))
    st = solver._kkt_builder(solver.spec, A[0], 1e-7, jnp.asarray(
        solver.spec.cone_mask(), A.dtype)).st
    builder = aug_kkt.make_staged_crqd_builder(st)
    A, b, c = (v.astype(jnp.float32) for v in (A, b, c))
    sol = jax.device_get(jax.jit(lambda A, b, c: ipm.solve_batched(
        A, b, c, solver.spec, tol=3e-6, tol_almost=1e-5, max_iter=60,
        kkt_builder=builder))(A, b, c))
    return dict(B=B, status=np.asarray(sol.status).tolist(),
                iters=np.asarray(sol.iters).tolist(),
                gap=np.asarray(sol.gap, np.float64).tolist())


def main():
    run = {"ptr_lu": ptr_lu, "ptr_lu_nudged": ptr_lu_nudged,
           "crqd_ipm": crqd_ipm}[sys.argv[1]]
    pbm, _ = refs.starship_pair()
    t0 = time.perf_counter()
    out = run(pbm)
    print(json.dumps(dict(run=sys.argv[1], wall_s=time.perf_counter() - t0,
                          **out)), flush=True)


if __name__ == "__main__":
    main()
