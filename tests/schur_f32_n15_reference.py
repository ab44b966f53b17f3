"""bench.py's double integrator at N=15 on the float32 dense Schur ladder,
in both packages on the CPU.

On the card the port's float32 Cholesky ladder leaves none of the 128
scenarios feasible after 10 steps at N=15 (scripts/torch_batch_split.py),
where the LU path solves them. This script asks whether the JAX package's
own float32 ladder does the same: it runs bench.py's configuration
(bench.py:24-56: drag, g = 0.01, s = 30, wvc 1e3, wtr 5e-3, IPM tolerance
3e-6 and 30 iterations, B = 128 scenarios spread 10% about the guess) at
N = 15 (Nsub = 8, as the card's run) for 10 steps, with both packages'
_SchurKKT forced onto the ladder (on the CPU both would take LU), from the
same guesses (the JAX package's, handed to both as numpy arrays). The port
runs its kernels' plain versions, which equal the card's kernels bit for
bit. --lu runs the LU path as well. Prints one JSON line per run (feasible
and SOLVED counts, iteration counts, J_aug) and one comparing the two.

    JAX_PLATFORMS=cpu python -m tests.schur_f32_n15_reference [--lu]

Not a test: the two batched solves take minutes on the CPU.
"""

import argparse
import collections
import json
import time
from importlib import import_module

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from tests.starship_ladder_reference import _forcing  # noqa: E402

jipm = import_module("scptoolbox_tpu.ops.ipm")
jdi = import_module("scptoolbox_tpu.models.double_integrator")
jptr = import_module("scptoolbox_tpu.solvers.ptr")
tipm = import_module("scptoolbox_torch.ops.ipm")
tdi = import_module("scptoolbox_torch.models.double_integrator")
tptr = import_module("scptoolbox_torch.solvers.ptr")

B, N, NSUB, STEPS, SPREAD = 128, 15, 8, 10, 0.1
PARS = dict(N=N, Nsub=NSUB, wvc=1e3, wtr=5e-3, ipm_tol=3e-6,
            ipm_max_iter=30)


def _summary(tag, out):
    feas = np.asarray(out["feas"]).astype(bool)
    status = np.asarray(out["status"]).astype(int)
    iters = np.asarray(out["iters"]).astype(int)
    J = np.asarray(out["J_aug"], dtype=np.float64)
    row = dict(run=tag, feasible=int(feas.sum()),
               solved=int((status == 0).sum()),
               iterations=dict(sorted(collections.Counter(
                   iters.tolist()).items())),
               J_aug_finite=int(np.isfinite(J).sum()),
               J_aug_median=float(np.nanmedian(np.where(np.isfinite(J), J,
                                                        np.nan)))
               if np.isfinite(J).any() else None)
    print(json.dumps(row), flush=True)
    return feas, status, iters, J


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--lu", action="store_true",
                    help="also run both packages on the LU path")
    args = ap.parse_args()
    torch.set_num_threads(4)
    pj = jdi.double_integrator(jdi.DoubleIntegratorParameters(
        drag=True, g=0.01, s=30.0))
    pt = tdi.double_integrator(tdi.DoubleIntegratorParameters(
        drag=True, g=0.01, s=30.0))
    paths = (("ladder", False), ("lu", True)) if args.lu else (
        ("ladder", False),)
    for path, use_lu in paths:
        jax.clear_caches()       # the IPM's traces are shared by instances
        with _forcing(jipm, use_lu):
            sj = jptr.PTR(pj, jptr.PTRParameters(**PARS), dtype=jnp.float32)
            gx, gu, gp = (np.asarray(a) for a in sj._guess)
            scale = (1.0 + SPREAD * (np.arange(B, dtype=np.float32) / B
                                     - 0.5)).astype(np.float32)
            bx = gx[None] * scale[:, None, None]
            bu = np.broadcast_to(gu, (B, *gu.shape)).copy()
            bp = np.broadcast_to(gp, (B, *gp.shape)).copy()
            t0 = time.perf_counter()
            oj = sj.solve_batched(jnp.asarray(bx), jnp.asarray(bu),
                                  jnp.asarray(bp), STEPS)
            jax.block_until_ready(oj)
            wall_j = time.perf_counter() - t0
        with _forcing(tipm, use_lu):
            st = tptr.PTR(pt, tptr.PTRParameters(**PARS),
                          dtype=torch.float32, device="cpu")
            tg = [t.numpy() for t in st._guess]
            print(json.dumps(dict(
                path=path, guess_rel_diff=[
                    float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
                    if b.size else 0.0
                    for a, b in zip(tg, (gx, gu, gp))])), flush=True)
            t0 = time.perf_counter()
            ot = st.solve_batched(torch.as_tensor(bx), torch.as_tensor(bu),
                                  torch.as_tensor(bp), STEPS)
            wall_t = time.perf_counter() - t0
        fj, sj_, ij, Jj = _summary(f"jax {path}", oj)
        ft, st_, it, Jt = _summary(f"port {path}", ot)
        both = np.isfinite(Jj) & np.isfinite(Jt)
        rel = np.abs(Jt[both] / Jj[both] - 1.0)
        print(json.dumps(dict(
            path=path, wall_s=dict(jax=wall_j, port=wall_t),
            same_feasible=int((fj == ft).sum()),
            same_status=int((sj_ == st_).sum()),
            same_iterations=int((ij == it).sum()),
            J_aug_both_finite=int(both.sum()),
            J_aug_rel_diff_max=float(rel.max()) if rel.size else None,
            J_aug_rel_diff_median=float(np.median(rel)) if rel.size
            else None)), flush=True)


if __name__ == "__main__":
    main()
