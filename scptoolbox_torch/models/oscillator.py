"""Damped oscillator with an actuator deadband.

Counterpart of `scptoolbox_tpu/models/oscillator.py` (`OscillatorParameters`,
`oscillator` :54, `solve_oscillator` :135; reference
test/examples/oscillator/). A 1-DoF damped oscillator is brought to rest by
an acceleration actuator with a deadband: a commanded acceleration ar with
|ar| < a_db gives no actual acceleration aa. The on/off logic is the smooth
OR aa = OR(ar) ar, sharpened along a homotopy ladder of kappa1, each rung a
serial PTR solve warm-started from the previous one with the new kappa1 in
`solver.consts`. Costs are L1: position (through the per-node parameters
p = l1r, np = N), actual acceleration, and the deadband violation |aa - ar|.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from scptoolbox_torch.parser.problem import (BoundingBox, TrajectoryProblem,
                                             l1, nonpos)
from scptoolbox_torch.solvers import ptr
from scptoolbox_torch.solvers.solution import SCPSolution
from scptoolbox_torch.utils.smooth import Homotopy, smooth_or

# input slots (reference parameters.jl:69-75)
ID_AA, ID_AR, ID_L1AA, ID_L1ADIFF = 0, 1, 2, 3


@dataclasses.dataclass(frozen=True)
class OscillatorParameters:
    """Model constants (reference parameters.jl:78-112)."""

    zeta: float = 0.5      # damping ratio
    w0: float = 1.0        # [rad/s] natural frequency
    a_db: float = 0.05     # [m/s^2] deadband acceleration
    a_max: float = 0.3     # [m/s^2] maximum acceleration
    r0: float = 1.0        # [m] initial position
    v0: float = 0.0        # [m/s] initial velocity
    tf: float = 10.0       # [s] trajectory duration
    alpha: float = 0.06    # control usage weight
    gamma: float = 1e-1    # deadband-relaxation weight


def oscillator(N: int, mdl: OscillatorParameters = OscillatorParameters()
               ) -> TrajectoryProblem:
    """The TrajectoryProblem at grid size N; the sharpness kappa1 is the
    problem constant consts["kappa1"]."""
    tf, w0, zeta = mdl.tf, mdl.w0, mdl.zeta
    a_db, a_max = mdl.a_db, mdl.a_max

    def f(t, x, u, p):
        r, v = x[0], x[1]
        return tf * torch.stack([v, u[ID_AA] - w0 ** 2 * r
                                 - 2.0 * zeta * w0 * v])

    def at(p, k):
        # p[k] for a node index k that vmap batches: a one-hot weight
        return torch.sum(p * (torch.arange(p.shape[0], device=p.device) == k))

    def running_cost(t, k, x, u, p):
        return (at(p, k) / mdl.r0 + mdl.alpha * u[ID_L1AA] / a_max
                + mdl.gamma * u[ID_L1ADIFF] / a_max)

    def X(t, k, x, p):
        # l1r_k >= |r_k|
        return [l1(torch.stack([at(p, k), x[0]]))]

    def U(t, k, u, p):
        aa, ar = u[ID_AA], u[ID_AR]
        return [
            nonpos(torch.stack([aa - a_max, -a_max - aa, ar - a_max,
                                -a_max - ar])),
            l1(torch.stack([u[ID_L1AA], aa])),
            l1(torch.stack([u[ID_L1ADIFF], aa - ar])),
        ]

    def s(t, k, x, u, p, consts):
        # aa = OR(ar) ar at the sharpness kappa1
        aa, ar = u[ID_AA], u[ID_AR]
        OR = smooth_or([ar - a_db, -a_db - ar], kappa=consts["kappa1"],
                       match=a_max - a_db, normalize=a_max - a_db)
        return torch.stack([aa - OR * ar, OR * ar - aa])

    def gic(x, p):
        return x - torch.tensor([mdl.r0, mdl.v0], dtype=x.dtype,
                                device=x.device)

    def guess(N_, consts):
        # passive coasting from x0 (RK4, 40 substeps), idle inputs, l1r
        # from the coast (reference definition.jl:69-109)
        x = np.zeros((N_, 2))
        x[0] = [mdl.r0, mdl.v0]
        tau = np.linspace(0.0, 1.0, N_)
        fdot = lambda xx: tf * np.asarray(
            [xx[1], -w0 ** 2 * xx[0] - 2 * zeta * w0 * xx[1]])
        nsub = 40
        for k in range(N_ - 1):
            xk = x[k]
            h = (tau[k + 1] - tau[k]) / nsub
            for _ in range(nsub):
                k1 = fdot(xk)
                k2 = fdot(xk + h / 2 * k1)
                k3 = fdot(xk + h / 2 * k2)
                k4 = fdot(xk + h * k3)
                xk = xk + h / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
            x[k + 1] = xk
        return x, np.zeros((N_, 4)), np.abs(x[:, 0])

    return TrajectoryProblem(
        nx=2, nu=4, np=N, f=f, guess=guess,
        consts={"kappa1": torch.tensor(1.0, dtype=torch.float64)},
        running_cost=running_cost, X=X, U=U, s=s, gic=gic,
        xrg=BoundingBox(lo=np.asarray([-mdl.r0, -1.0]),
                        hi=np.asarray([mdl.r0, 1.0])),
        urg=BoundingBox(lo=np.asarray([-a_max, -a_max, 0.0, 0.0]),
                        hi=np.asarray([a_max, a_max, a_max, 2 * a_max])),
        prg=BoundingBox(lo=np.zeros(N), hi=np.full(N, mdl.r0)))


def solve_oscillator(N: int = 30, n_hom: int = 10,
                     mdl: OscillatorParameters = OscillatorParameters(),
                     pars: ptr.PTRParameters = None, verbose: bool = False,
                     dtype=None, device=None) -> SCPSolution:
    """PTR with homotopy continuation over the deadband sharpness
    (reference tests.jl:21-93): n_hom serial solves, each warm-started from
    the previous one, on the card unless `device` says otherwise."""
    pbm = oscillator(N, mdl)
    if pars is None:
        pars = ptr.PTRParameters(N=N, Nsub=10, iter_max=10, wvc=1e2,
                                 wtr=1e-3, eps_abs=-np.inf, eps_rel=1e-5,
                                 feas_tol=5e-3)
    solver = ptr.PTR(pbm, pars, dtype=dtype, device=device)
    hom = Homotopy(delta_min=1e-8)
    grid = np.linspace(0.0, 1.0, n_hom)
    sol = None
    for i in range(n_hom):
        kappa1 = float(hom(grid[i]))
        solver.consts = {"kappa1": torch.tensor(
            kappa1, dtype=solver.dtype, device=solver.device)}
        if verbose:
            print(f"[{i + 1}/{n_hom}] homotopy kappa1 = {kappa1:.2e}")
        sol = solver.solve(warm=sol, verbose=verbose)
    return sol
