"""Quadrotor obstacle avoidance.

Counterpart of `scptoolbox_tpu/models/quadrotor.py` (`QuadrotorParameters`
:26, `quadrotor` :49; reference test/examples/quadrotor/ parameters.jl:95-135,
definition.jl:27-360). State (r, v) in R^6, input (a, sigma) in R^4 (the
acceleration and its LCvx slack), parameter the time dilation. The vehicle
flies between rest states past two cylindrical keep-out ellipsoids, under
the thrust relaxation sigma >= ||a||, a tilt cone and acceleration bounds.
Solved by SCvx and GuSTO in the reference test suite (quadrotor/tests.jl).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from scptoolbox_torch.parser.problem import (BoundingBox, Constants,
                                             TrajectoryProblem, nonpos, soc)
from scptoolbox_torch.utils.geometry import Ellipsoid


@dataclasses.dataclass(frozen=True)
class QuadrotorParameters:
    """Model parameters (reference quadrotor/parameters.jl:95-135)."""

    g: float = 9.81
    u_max: float = 23.2
    u_min: float = 0.6
    tilt_max_deg: float = 60.0
    tf_min: float = 0.0
    tf_max: float = 2.5
    gamma: float = 0.0      # terminal-vs-running cost tradeoff
    r0: Tuple[float, ...] = (0.0, 0.0, 0.0)
    rf: Tuple[float, ...] = (2.5, 6.0, 0.0)

    def obstacles(self):
        """Two cylindrical keep-out ellipsoids (parameters.jl:115-118),
        float64 on the CPU."""
        T = lambda v: torch.tensor(v, dtype=torch.float64)
        return [Ellipsoid(torch.diag(T([2.0, 2.0, 0.0])), T([1.0, 2.0, 0.0])),
                Ellipsoid(torch.diag(T([1.5, 1.5, 0.0])), T([2.0, 5.0, 0.0]))]


def quadrotor(mdl: QuadrotorParameters = QuadrotorParameters()
              ) -> TrajectoryProblem:
    """The TrajectoryProblem (reference definition.jl:27-360)."""
    hover = mdl.g
    gam = mdl.gamma
    obs = mdl.obstacles()
    cos_tilt = float(np.cos(np.deg2rad(mdl.tilt_max_deg)))
    cst = Constants(
        g_vec=np.asarray([0.0, 0.0, -mdl.g]),
        H=np.stack([E.H.numpy() for E in obs]),
        c=np.stack([E.c.numpy() for E in obs]),
        x0=np.concatenate([mdl.r0, np.zeros(3)]),
        xf=np.concatenate([mdl.rf, np.zeros(3)]))

    def f(t, x, u, p):
        # definition.jl:140-155: time-dilated double integrator with gravity
        return p[0] * torch.cat([x[3:6], u[:3] + cst(x)["g_vec"]])

    def terminal_cost(x, p):
        # definition.jl:203-211
        return gam * (p[0] / mdl.tf_max) ** 2

    def running_cost(t, k, x, u, p):
        # definition.jl:215-228 (SCvx form; GuSTO's S-matrix form is the
        # same quadratic)
        return (1.0 - gam) * (u[3] / hover) ** 2

    def U(t, k, u, p):
        # definition.jl:187-244: sigma bounds, LCvx SOC, tilt, duration
        a, sig = u[:3], u[3]
        return [
            nonpos(torch.stack([mdl.u_min - sig, sig - mdl.u_max])),
            soc(torch.cat([sig[None], a])),
            nonpos(torch.stack([sig * cos_tilt - a[2], p[0] - mdl.tf_max,
                                mdl.tf_min - p[0]])),
        ]

    def s(t, k, x, u, p):
        # definition.jl:258-269: obstacle keep-out s_i = 1 - E_i(r) <= 0
        c = cst(x)
        r = x[:3]
        return torch.stack([1.0 - Ellipsoid(c["H"][i], c["c"][i])(r)
                            for i in range(len(obs))])

    def gic(x, p):
        return x - cst(x)["x0"]

    def gtc(x, p):
        return x - cst(x)["xf"]

    def guess(N):
        # definition.jl:160-185: straight line, hover inputs, mid duration
        x0 = np.concatenate([np.asarray(mdl.r0), np.zeros(3)])
        xf = np.concatenate([np.asarray(mdl.rf), np.zeros(3)])
        tau = np.linspace(0.0, 1.0, N)[:, None]
        x = x0[None, :] * (1 - tau) + xf[None, :] * tau
        u = np.tile(np.asarray([0.0, 0.0, mdl.g, mdl.g]), (N, 1))
        p = np.asarray([0.5 * (mdl.tf_min + mdl.tf_max)])
        return x, u, p

    # scaling: the reference advises only the parameter (definition.jl:49-58);
    # the unadvised states keep the default [0, 1] box, and the inputs get
    # the bounds the reference's min/max LPs would find from U (a in the
    # sigma <= u_max ball, sigma in [u_min, u_max])
    um = mdl.u_max
    return TrajectoryProblem(
        nx=6, nu=4, np=1, f=f, guess=guess,
        terminal_cost=terminal_cost, running_cost=running_cost,
        U=U, s=s, gic=gic, gtc=gtc,
        urg=BoundingBox(lo=np.asarray([-um, -um, -um, mdl.u_min]),
                        hi=np.asarray([um, um, um, um])),
        prg=BoundingBox(lo=np.asarray([mdl.tf_min]),
                        hi=np.asarray([mdl.tf_max])),
    )
