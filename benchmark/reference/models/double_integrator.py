"""Plain reference of the double integrator with drag (after
UW-ACL/SCPToolbox.jl test/examples/double_integrator), written anew for the
benchmark in float64: x = (position, velocity), u = (acceleration,), no
parameters, the horizon T folded into the dynamics, quadratic drag g v |v|
(or linear friction g v), the cost T * trapz(u^2), |u| <= u_max, from rest
at 0 to rest at s. The guess is the straight line at the mean speed."""

from __future__ import annotations

import numpy as np
import torch

DEFAULTS = dict(T=10.0, g=0.1, s=47.0, u_max=10.0, drag=False)


def make(params, N):
    P = dict(DEFAULTS, **params)
    T, g, s, u_max, drag = (P[k] for k in ("T", "g", "s", "u_max", "drag"))

    def f(t, x, u, p):
        v = x[1]
        fric = g * v * torch.abs(v) if drag else g * v
        return T * torch.stack([v, u[0] - fric])

    def convex(t, x, u, p):
        return torch.stack([u[0] - u_max, -u[0] - u_max])

    def gic(x, p):
        return x - torch.zeros(2, dtype=x.dtype, device=x.device)

    def gtc(x, p):
        return x - torch.tensor([s, 0.0], dtype=x.dtype, device=x.device)

    def running(t, x, u, p):
        return T * u[0] * u[0]

    x_lo, x_hi = np.array([0.0, -s / T]), np.array([s, 3.0 * s / T])

    def check_guess(xg, ug, pg):
        """The program's guess against the straight line at mean speed,
        over the scaling: the largest gap."""
        tau = np.linspace(0.0, 1.0, N)
        x = np.stack([s * tau, np.full(N, s / T)], axis=1)
        return float(max(np.max(np.abs(xg - x) / (x_hi - x_lo)),
                         np.max(np.abs(ug)) / (2 * u_max),
                         np.max(np.abs(pg), initial=0.0)))

    from benchmark.reference.model import RefModel
    return RefModel(nx=2, nu=1, np=0, f=f, x_lo=x_lo, x_hi=x_hi,
                    u_lo=np.array([-u_max]), u_hi=np.array([u_max]),
                    convex=convex, gic=gic, gtc=gtc, running=running,
                    check_guess=check_guess)
