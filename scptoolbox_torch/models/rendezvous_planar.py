"""Planar spacecraft rendezvous with RCS thruster deadband logic.

Counterpart of `scptoolbox_tpu/models/rendezvous_planar.py`
(`PlanarRendezvousParameters`, `rendezvous_planar`,
`solve_rendezvous_planar`; reference test/examples/rendezvous_planar/).
Clohessy-Wiltshire planar dynamics with three RCS thruster pods, solved by
PTR under IMPULSE discretization: the thrusts act as state jumps at the
nodes. Each pod has a commanded force fr with a deadband: |fr| < f_db gives
no actual force f. The on/off logic f = OR(fr) fr is the smooth OR at
sharpness kappa, driven up a homotopy ladder of serial solves, each
warm-started from the previous one with the new kappa in `solver.consts`.
L1 epigraph slots l1f (|f|) and l1feq (|f - fr|) make the thrust cost
linear.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from scptoolbox_torch.ops.discretize import DiscretizationType
from scptoolbox_torch.parser.problem import (BoundingBox, TrajectoryProblem,
                                             l1, nonpos)
from scptoolbox_torch.solvers import ptr
from scptoolbox_torch.solvers.solution import SCPSolution
from scptoolbox_torch.utils.smooth import Homotopy, smooth_or

# input slots (reference parameters.jl:102-108): 3 actual forces, 3
# reference forces, 3 |f| epigraphs, 3 |f - fr| epigraphs
ID_F = slice(0, 3)
ID_FR = slice(3, 6)
ID_L1F = slice(6, 9)
ID_L1FEQ = slice(9, 12)


@dataclasses.dataclass(frozen=True)
class PlanarRendezvousParameters:
    """Model constants (reference parameters.jl:86-152)."""

    m: float = 30e3        # [kg]
    J: float = 1e5         # [kg m^2]
    lu: float = 0.6        # [m] CoM longitudinal offset of thrusters
    lv: float = 2.1        # [m] CoM transverse offset of thrusters
    f_max: float = 750.0   # [N]
    f_db: float = 200.0    # [N] deadband force
    orbit_alt: float = 400e3
    r0: tuple = (100.0, 10.0)
    v0: tuple = (0.0, 0.0)
    theta0: float = float(np.deg2rad(180.0))
    omega0: float = 0.0
    vf: float = 0.1        # [m/s] final approach speed along -x
    tf_min: float = 100.0
    tf_max: float = 500.0
    gamma: float = 3e-1    # deadband-relaxation cost weight

    @property
    def n_orbit(self) -> float:
        """Orbital mean motion (parameters.jl:90-95)."""
        mu, Re = 3.986e14, 6378e3
        return float(np.sqrt(mu / (Re + self.orbit_alt) ** 3))


def _const(like, values):
    return torch.tensor(values, dtype=like.dtype, device=like.device)


def _body_axes(theta):
    """Docking-port body axes in the inertial frame
    (parameters.jl:112-113): uh 'forward', vh 'up'."""
    uh = torch.stack([-torch.cos(theta), torch.sin(theta)])
    vh = torch.stack([-torch.sin(theta), -torch.cos(theta)])
    return uh, vh


def rendezvous_planar(
    mdl: PlanarRendezvousParameters = PlanarRendezvousParameters()
) -> TrajectoryProblem:
    """The TrajectoryProblem (reference definition.jl:22-475); the deadband
    sharpness is the problem constant consts["kappa"]."""
    n = mdl.n_orbit
    f_max, f_db = mdl.f_max, mdl.f_db

    def f(t, x, u, p):
        # the Clohessy-Wiltshire field (definition.jl:151-180); under
        # IMPULSE integration it is evaluated with u = 0
        vx, vy = x[2], x[3]
        theta, omega = x[4], x[5]
        fm, fp, f0 = u[0], u[1], u[2]
        uh, vh = _body_axes(theta)
        acc = ((fm + fp) * uh + f0 * vh) / mdl.m
        dv = acc + torch.stack([2.0 * n * vy,
                                3.0 * n ** 2 * x[1] - 2.0 * n * vx])
        dom = ((fp - fm) * mdl.lv - f0 * mdl.lu) / mdl.J
        return p[0] * torch.cat([x[2:4], dv, omega[None], dom[None]])

    def impulse(t, x, u, p):
        # the state jump at node k: thrust only, not time-dilated
        # (definition.jl:155-179 `impulse = k < 0` branch)
        fm, fp, f0 = u[0], u[1], u[2]
        uh, vh = _body_axes(x[4])
        dv = ((fm + fp) * uh + f0 * vh) / mdl.m
        dom = ((fp - fm) * mdl.lv - f0 * mdl.lu) / mdl.J
        z = x.new_zeros(2)
        return torch.cat([z, dv, z[:1], dom[None]])

    def running_cost(t, k, x, u, p):
        # definition.jl:126-144: L1 thrust + deadband-violation magnitudes
        return (torch.sum(u[ID_L1F]) + mdl.gamma * torch.sum(u[ID_L1FEQ])
                ) / f_max

    def U(t, k, u, p):
        # definition.jl:244-335: per-pod epigraphs/bounds + duration box
        fv, frv = u[ID_F], u[ID_FR]
        l1fv, l1feqv = u[ID_L1F], u[ID_L1FEQ]
        cons = [nonpos(torch.cat(
            [l1fv - f_max, frv - f_max, -frv - f_max,
             torch.stack([p[0] - mdl.tf_max, mdl.tf_min - p[0]])]))]
        for i in range(3):
            cons.append(l1(torch.stack([l1fv[i], fv[i]])))
            cons.append(l1(torch.stack([l1feqv[i], fv[i] - frv[i]])))
        return cons

    def s(t, k, x, u, p, consts):
        # deadband logic f_i = OR(fr_i) fr_i at the sharpness kappa
        # (definition.jl:337-413)
        fv, frv = u[ID_F], u[ID_FR]
        rows = []
        for i in range(3):
            OR = smooth_or(
                [frv[i] - f_db, -f_db - frv[i]], kappa=consts["kappa"],
                match=[f_max - f_db, -f_db - f_max],
                normalize=f_max + f_db)
            rows.append(fv[i] - OR * frv[i])
            rows.append(OR * frv[i] - fv[i])
        return torch.stack(rows)

    x0 = [*mdl.r0, *mdl.v0, mdl.theta0, mdl.omega0]

    def gic(x, p):
        return x - _const(x, x0)

    def gtc(x, p):
        # dock at the origin moving at -vf x_hat, upright, at rest rate
        # (definition.jl:446-472)
        return x - _const(x, [0.0, 0.0, -mdl.vf, 0.0, 0.0, 0.0])

    def guess(N, consts):
        # definition.jl:94-121: straight-line drift to the origin
        tf = 0.5 * (mdl.tf_min + mdl.tf_max)
        x0g = np.asarray([*mdl.r0, -mdl.r0[0] / tf, -mdl.r0[1] / tf,
                          mdl.theta0, -mdl.theta0 / tf])
        xfg = np.asarray([0.0, 0.0, x0g[2], x0g[3], 0.0, x0g[5]])
        tau = np.linspace(0.0, 1.0, N)[:, None]
        x = x0g[None] * (1 - tau) + xfg[None] * tau
        return x, np.zeros((N, 12)), np.asarray([tf])

    # scaling advice (definition.jl:43-92)
    rx0, ry0 = mdl.r0
    vx0, vy0 = mdl.v0
    th0 = mdl.theta0
    deg1 = float(np.deg2rad(1.0))
    x_lo = np.asarray([0.0, min(ry0, -0.1),
                       min(vx0, -rx0 / mdl.tf_min, -0.1), min(vy0, -0.1),
                       min(th0, -deg1), min(-th0 / mdl.tf_min, 0.0, -deg1)])
    x_hi = np.asarray([max(rx0, 1.0), max(ry0, 0.1),
                       min(vx0, 0.1), max(vy0, -ry0 / mdl.tf_min, 0.1),
                       max(th0, deg1), max(-th0 / mdl.tf_min, 0.0, deg1)])
    u_lo = np.concatenate([-f_max * np.ones(6), np.zeros(6)])
    u_hi = np.concatenate([f_max * np.ones(6), f_max * np.ones(3),
                           2 * f_max * np.ones(3)])

    return TrajectoryProblem(
        nx=6, nu=12, np=1, f=f, impulse=impulse, guess=guess,
        consts={"kappa": torch.tensor(1.0, dtype=torch.float64)},
        running_cost=running_cost, U=U, s=s, gic=gic, gtc=gtc,
        xrg=BoundingBox(lo=x_lo, hi=x_hi), urg=BoundingBox(lo=u_lo, hi=u_hi),
        prg=BoundingBox(lo=np.asarray([mdl.tf_min]),
                        hi=np.asarray([mdl.tf_max])))


def solve_rendezvous_planar(
        N: int = 30, n_hom: int = 10,
        mdl: PlanarRendezvousParameters = PlanarRendezvousParameters(),
        pars: ptr.PTRParameters = None, verbose: bool = False,
        dtype=None, device=None) -> SCPSolution:
    """PTR with homotopy continuation over the deadband sharpness
    (reference tests.jl:37-85): IMPULSE discretization, n_hom serial solves,
    each warm-started from the previous one, on the card unless `device`
    says otherwise."""
    pbm = rendezvous_planar(mdl)
    if pars is None:
        # wtr 0.3, not the reference's 3e-2 (tests.jl:48), as in the JAX
        # package: with the weaker trust penalty PTR limit-cycles between
        # bang-bang patterns at the smoothest rung
        pars = ptr.PTRParameters(
            N=N, Nsub=10, iter_max=30,
            disc_method=DiscretizationType.IMPULSE,
            wvc=5e2, wtr=0.3, eps_abs=-np.inf, eps_rel=1e-5,
            feas_tol=5e-3, ipm_max_iter=40)
    solver = ptr.PTR(pbm, pars, dtype=dtype, device=device)
    hom = Homotopy(delta_min=1e-3, delta_max=5.0)
    grid = np.linspace(0.0, 1.0, n_hom)
    sol = None
    for i in range(n_hom):
        kappa = float(hom(grid[i]))
        solver.consts = {"kappa": torch.tensor(
            kappa, dtype=solver.dtype, device=solver.device)}
        if verbose:
            print(f"[{i + 1}/{n_hom}] homotopy kappa = {kappa:.2e}")
        sol = solver.solve(warm=sol, verbose=verbose)
    return sol
