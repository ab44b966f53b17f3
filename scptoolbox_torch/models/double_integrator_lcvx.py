"""Lossless-convexification double integrator.

Counterpart of `scptoolbox_tpu/models/double_integrator_lcvx.py`
(`build_program` :59, `solve_lcvx` :101, `mp_input` :117, `_mp_sim` :133,
`solve_mp` :166; reference test/examples/double_integrator/). The
nonconvex input annulus 1 <= |u| <= 2 is relaxed through the slack sigma,
|u| <= sigma, 1 <= sigma <= 2, minimizing sum(sigma^2) dt; the relaxation is
lossless, so the optimum has |u| = sigma. A ConicProgram with exact FOH
dynamics, no SCP loop. `solve_mp` is the analytic Pontryagin cross-check:
the adjoint is p(t) = c (t - ts), and (c, ts) come from a grid-search
shooting to the terminal condition.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from scptoolbox_torch.parser.problem import nonpos, zero
from scptoolbox_torch.parser.program import ConicProgram
from scptoolbox_torch.utils.linsys import c2d_foh, c2d_zoh


@dataclasses.dataclass(frozen=True)
class LCvxDoubleIntegratorParameters:
    """Model parameters (reference parameters.jl:48-85): choice 1 -> g=0.1,
    s=47; choice 2 -> g=0.6, s=30."""

    choice: int = 1
    T: float = 10.0
    N: int = 50

    @property
    def g(self) -> float:
        return 0.1 if self.choice == 1 else 0.6

    @property
    def s(self) -> float:
        return 47.0 if self.choice == 1 else 30.0


class LCvxSolution(NamedTuple):
    t: np.ndarray     # (N,)
    x: np.ndarray     # (N, 2)
    u: np.ndarray     # (N,)
    sigma: np.ndarray
    cost: float
    status: int


def build_program(mdl: LCvxDoubleIntegratorParameters, dtype=None,
                  device=None) -> ConicProgram:
    """The LCvx conic program (reference definition.jl:38-103), on the card
    unless `device` says otherwise."""
    N, T, g, s = mdl.N, mdl.T, mdl.g, mdl.s
    dt = T / (N - 1)
    f64 = lambda a: torch.as_tensor(a, dtype=torch.float64)
    A = f64([[0.0, 1.0], [0.0, 0.0]])
    Ad, Bm, Bp = c2d_foh(A, f64([[0.0], [1.0]]), dt)
    # the constant forcing [0, -g]: its exact ZOH integral
    wd = c2d_zoh(A, f64([[0.0], [-g]]), dt)[1][:, 0]

    prg = ConicProgram(dtype=dtype, device=device)
    on = lambda a: torch.as_tensor(a, dtype=prg.dtype, device=prg.device)
    Ad, Bm, Bp, wd = (on(a) for a in (Ad, Bm, Bp, wd))
    target = on([s, 0.0])
    x = prg.variable("x", N, 2)
    u = prg.variable("u", N)
    sig = prg.variable("sigma", N)

    prg.add_constraint("ic", lambda x: [zero(x[0])], (x,))
    prg.add_constraint("tc", lambda x: [zero(x[-1] - target)], (x,))
    prg.add_constraint(
        "dyn",
        lambda x, u: [zero(
            (x[1:] - x[:-1] @ Ad.T - u[:-1, None] * Bm[None, :, 0]
             - u[1:, None] * Bp[None, :, 0] - wd[None, :]).reshape(-1))],
        (x, u))
    # sigma in [1, 2] and |u| <= sigma (definition.jl:69-84)
    prg.add_constraint(
        "sigma_bounds",
        lambda sig: [nonpos(torch.cat([sig - 2.0, 1.0 - sig]))], (sig,))
    prg.add_constraint(
        "lcvx", lambda u, sig: [nonpos(torch.cat([u - sig, -u - sig]))],
        (u, sig))
    # min sum(sigma^2) dt, through a quadratic epigraph
    prg.add_cost(lambda sig: torch.sum(sig ** 2) * dt, (sig,))
    prg.scale(x, [max(s, 1.0), 10.0], [0.0, 0.0])
    prg.build()
    return prg


def solve_lcvx(mdl: LCvxDoubleIntegratorParameters =
               LCvxDoubleIntegratorParameters(), dtype=None,
               device=None) -> LCvxSolution:
    """Solve the LCvx relaxation (reference definition.jl:38-115)."""
    sol = build_program(mdl, dtype, device).solve()
    val = lambda k: sol.values[k].cpu().numpy()
    return LCvxSolution(t=np.linspace(0.0, mdl.T, mdl.N), x=val("x"),
                        u=val("u"), sigma=val("sigma"), cost=float(sol.obj),
                        status=int(sol.status))


# --------------------------------------------------------------------------
# Pontryagin maximum-principle solution (shooting and grid search, numpy)
# --------------------------------------------------------------------------


def mp_input(p: float) -> float:
    """Optimal input from the adjoint p (reference definition.jl:313-330)."""
    if p > 4:
        return 2.0
    if p >= 2:
        return p / 2
    if p >= 0:
        return 1.0
    if p >= -2:
        return -1.0
    if p >= -4:
        return p / 2
    return -2.0


def _mp_sim(T, g, s, c, ts, n_sub=100):
    """Shoot with the adjoint p(t) = c (t - ts) (reference
    definition.jl:346-385): (terminal error, times, states)."""
    t_crit = [ts + a / c for a in (4.0, 2.0, 0.0, -2.0, -4.0)]
    t_crit = [tc for tc in t_crit if 0.0 <= tc <= T]
    knots = [0.0] + sorted(t_crit) + [T]
    ts_all, xs_all = [], []
    x = np.zeros(2)
    for lo, hi in zip(knots[:-1], knots[1:]):
        grid = np.linspace(lo, hi, n_sub)
        # u(p) jumps only at p = 0: the band is taken at the segment's
        # midpoint, so that a knot never lands on the wrong side of the jump
        p_mid = c * ((lo + hi) / 2 - ts)
        for t0, t1 in zip(grid[:-1], grid[1:]):
            h = t1 - t0

            def fdot(t, xx):
                p = c * (t - ts)
                u = mp_input(p if p * p_mid > 0 or p_mid == 0
                             else np.copysign(1e-12, p_mid))
                return np.array([xx[1], u - g])

            k1 = fdot(t0, x)
            k2 = fdot(t0 + h / 2, x + h / 2 * k1)
            k3 = fdot(t0 + h / 2, x + h / 2 * k2)
            k4 = fdot(t1, x + h * k3)
            x = x + h / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
            ts_all.append(t1)
            xs_all.append(x.copy())
    err = float(np.linalg.norm(x - np.array([s, 0.0])))
    return err, np.asarray(ts_all), np.asarray(xs_all)


def solve_mp(mdl: LCvxDoubleIntegratorParameters =
             LCvxDoubleIntegratorParameters(), tol_err: float = 1e-2,
             max_iter: int = 10, n_grid: int = 25):
    """Analytic optimum by iterated grid search over the adjoint parameters
    (c, ts) (reference definition.jl:137-217)."""
    T, g, s = mdl.T, mdl.g, mdl.s
    if mdl.choice == 1:
        c_rng, ts_rng = (-3.0, -1.0), (4.5, 5.5)
    else:
        c_rng, ts_rng = (-1.5, -0.5), (6.5, 7.5)
    for _ in range(max_iter):
        cg = np.linspace(*c_rng, n_grid)
        tg = np.linspace(*ts_rng, n_grid)
        err = np.full((n_grid, n_grid), np.nan)
        for i, ci in enumerate(cg):
            for j, tj in enumerate(tg):
                err[i, j], _, _ = _mp_sim(T, g, s, ci, tj, n_sub=20)
        inner = err[1:-1, 1:-1]
        i, j = np.unravel_index(np.argmin(inner), inner.shape)
        i += 1
        j += 1
        if inner.min() <= tol_err:
            c, ts = cg[i], tg[j]
            err_f, t_mp, x_mp = _mp_sim(T, g, s, c, ts, n_sub=100)
            u_mp = np.array([mp_input(c * (t - ts)) for t in t_mp])
            return dict(c=c, ts=ts, err=err_f, t=t_mp, x=x_mp, u=u_mp)
        c_rng = (cg[max(i - 1, 0)], cg[min(i + 1, n_grid - 1)])
        ts_rng = (tg[max(j - 1, 0)], tg[min(j + 1, n_grid - 1)])
    raise RuntimeError("MP shooting failed to converge")
