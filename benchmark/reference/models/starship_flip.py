"""Plain reference of the Starship landing flip (after UW-ACL/SCPToolbox.jl
test/examples/starship_flip: parameters.jl, definition.jl), written anew for
the benchmark in float64.

Planar rigid body: x = (r (2), v (2), theta, omega, m, delta_d), u = (T,
delta, delta_dot), p = (t1, t2, xs (8)): the flip and descent phases' time
dilations and the state at the phase switch. Time runs over [0, 1], the flip
on [0, tau_s]. `check_guess` checks the initial guess the program builds in
its set-up: the flip phase is propagated again, the descent phase is held to
its double-integrator dynamics, boundary values and thrust cone.
"""

from __future__ import annotations

import math

import numpy as np
import torch

DEFAULTS = dict(g0=9.81, rs_fus=4.5, ls_fus=50.0, m=120e3, vterm=85.0,
                Isp=330.0, T_min1=880e3, T_max1=2210e3, delta_max_deg=10.0,
                rate_delay=0.05, r0=(100.0, 600.0), theta0_deg=90.0,
                thetas_deg=-10.0, vs_y=-10.0, vf_y=-0.1, tf_min=0.0,
                tf_max=40.0, gamma_gs_deg=27.0, theta_max2_deg=15.0,
                tau_s=0.5)


class _P:
    def __init__(self, over):
        d = dict(DEFAULTS, **over)
        for k, v in d.items():
            setattr(self, k, v)
        self.lcg = 0.4 * self.ls_fus
        self.lcp = 0.45 * self.ls_fus
        self.J = self.m / 12.0 * (6.0 * self.rs_fus ** 2 + self.ls_fus ** 2)
        self.CD = 1.2 * self.m * self.g0 / self.vterm ** 2
        self.alpha_e = -1.0 / (self.Isp * self.g0)
        self.T_min3, self.T_max3 = 3.0 * self.T_min1, 3.0 * self.T_max1
        self.delta_max = math.radians(self.delta_max_deg)
        self.ddot_max = 2.0 * self.delta_max


def make(params, N):
    P = _P(params)
    tau_s = P.tau_s
    th_max2 = math.radians(P.theta_max2_deg)
    cos_gs = math.cos(math.radians(P.gamma_gs_deg))
    dt_node = 1.0 / (N - 1)
    tol = 1e-3

    def f(t, x, u, p):
        th, om, T, d = x[4], x[5], u[0], u[1]
        vx, vy = x[2], x[3]
        c, s = torch.cos(th), torch.sin(th)
        # thrust along the body axis rotated by the gimbal angle
        Tx = T * (-torch.sin(d) * c - torch.cos(d) * s)
        Ty = T * (-torch.sin(d) * s + torch.cos(d) * c)
        vn = torch.sqrt(vx * vx + vy * vy + 1e-12)
        Dx, Dy = -P.CD * vn * vx, -P.CD * vn * vy
        MT = -P.lcg * T * torch.sin(d)
        MD = -(P.lcp - P.lcg) * (Dx * c + Dy * s)
        dil = torch.where(t <= tau_s, p[0] / tau_s, p[1] / (1.0 - tau_s))
        return dil * torch.stack([
            vx, vy, (Tx + Dx) / P.m, (Ty + Dy) / P.m - P.g0, om,
            (MT + MD) / P.J, P.alpha_e * T, (d - x[7]) / P.rate_delay])

    def convex(t, x, u, p):
        tf = p[0] + p[1]
        flip = t <= tau_s
        T_max = torch.where(flip, torch.full_like(u[0], P.T_max3),
                            torch.full_like(u[0], P.T_max1))
        T_min = torch.where(flip, torch.full_like(u[0], P.T_min3),
                            torch.full_like(u[0], P.T_min1))
        return torch.stack([x[3], tf - P.tf_max, P.tf_min - tf,
                            u[0] - T_max, T_min - u[0],
                            u[1] - P.delta_max, -u[1] - P.delta_max])

    def ncvx(t, x, u, p):
        one, nil = torch.ones_like(t), torch.zeros_like(t)
        is_switch = torch.where((t >= tau_s - dt_node + tol)
                                & (t <= tau_s + tol), one, nil)
        is_phase2 = torch.maximum(is_switch, torch.where(t > tau_s, one, nil))
        d, dd, ddot = u[1], x[7], u[2]
        rn = torch.sqrt(x[0] * x[0] + x[1] * x[1] + 1e-12)
        return torch.cat([
            torch.stack([(d - dd) - ddot * P.rate_delay,
                         ddot * P.rate_delay - (d - dd),
                         ddot - P.ddot_max, -P.ddot_max - ddot,
                         rn * cos_gs - x[1]]),
            is_switch * (p[2:10] - x), is_switch * (x - p[2:10]),
            is_phase2 * torch.stack([x[4] - th_max2, -th_max2 - x[4]])])

    def gic(x, p):
        return x[:7] - torch.tensor(
            [P.r0[0], P.r0[1], 0.0, -P.vterm, math.radians(P.theta0_deg),
             0.0, 0.0], dtype=x.dtype, device=x.device)

    def gtc(x, p):
        return x[:6] - torch.tensor([0.0, 0.0, 0.0, P.vf_y, 0.0, 0.0],
                                    dtype=x.dtype, device=x.device)

    def terminal(x, p):
        # hs, the switch altitude of the guess, is fixed at construction
        return 0.3 * (-p[3] / hs[0]) + (0.0 - x[6]) / 10e3

    d10 = math.radians(10.0)
    x_lo = np.array([-100.0, 0.0, -10.0, -P.vterm, 0.0, -d10, -1e3,
                     -P.delta_max])
    x_hi = np.array([100.0, P.r0[1], 10.0, 0.0, math.radians(P.theta0_deg),
                     d10, 0.0, P.delta_max])
    u_lo = np.array([P.T_min1, -P.delta_max, -P.ddot_max])
    u_hi = np.array([P.T_max3, P.delta_max, P.ddot_max])

    flip = _flip_phase(P, N)
    hs = [float(flip["xs"][1])]

    def check_guess(xg, ug, pg):
        return _check_guess(P, N, flip, xg, ug, pg, x_hi - x_lo, u_hi - u_lo)

    from benchmark.reference.model import RefModel
    return RefModel(
        nx=8, nu=3, np=10, f=f, x_lo=x_lo, x_hi=x_hi, u_lo=u_lo, u_hi=u_hi,
        p_lo=np.concatenate([[0.0, 0.0], x_lo]),
        p_hi=np.concatenate([[P.tf_max, P.tf_max], x_hi]),
        convex=convex, ncvx=ncvx, gic=gic, gtc=gtc, terminal=terminal,
        check_guess=check_guess)


def _flip_field(P, x, T, d):
    th = x[4]
    v = x[2:4]
    ei = np.array([math.cos(th), math.sin(th)])
    ej = np.array([-math.sin(th), math.cos(th)])
    Tv = T * (-math.sin(d) * ei + math.cos(d) * ej)
    Dv = -P.CD * math.hypot(v[0], v[1]) * v
    dv = (Tv + Dv) / P.m + np.array([0.0, -P.g0])
    return np.array([v[0], v[1], dv[0], dv[1], x[5],
                     -P.lcg * T * math.sin(d) / P.J, P.alpha_e * T,
                     (d - x[7]) / P.rate_delay])


def _flip_phase(P, N):
    """The guess's flip phase: a gimbal bang-bang at three engines' least
    thrust from the initial state, no aerodynamic torque, 4999 RK4 steps
    over 2 t_flip + 10 s, cut where the vertical speed first reaches vs_y."""
    flip_ac = P.lcg / P.J * P.T_min3 * math.sin(P.delta_max)
    th0, ths = math.radians(P.theta0_deg), math.radians(P.thetas_deg)
    flip_ts = math.sqrt((th0 - ths) / flip_ac)
    ts = np.linspace(0.0, 2.0 * flip_ts + 10.0, 5000)

    def ctrl(t):
        if t <= flip_ts:
            return P.delta_max
        return -P.delta_max if t <= 2 * flip_ts else 0.0

    X = np.zeros((len(ts), 8))
    X[0] = [P.r0[0], P.r0[1], 0.0, -P.vterm, th0, 0.0, 0.0, P.delta_max]
    for i in range(len(ts) - 1):
        h, t, x = ts[i + 1] - ts[i], ts[i], X[i]
        F = lambda tt, xx: _flip_field(P, xx, P.T_min3, ctrl(tt))
        k1 = F(t, x)
        k2 = F(t + h / 2, x + h / 2 * k1)
        k3 = F(t + h / 2, x + h / 2 * k2)
        k4 = F(t + h, x + h * k3)
        X[i + 1] = x + h / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
    k0 = int(np.flatnonzero(X[:, 3] >= P.vs_y)[0])
    ts, X = ts[:k0 + 1], X[:k0 + 1]
    t1 = ts[-1]
    tau = np.linspace(0.0, 1.0, N)
    id1 = np.flatnonzero(tau <= P.tau_s)
    sample = lambda t: np.array([np.interp(t, ts, X[:, i]) for i in range(8)])
    x1 = np.stack([sample(tau[j] / P.tau_s * t1) for j in id1])
    u1 = np.stack([[P.T_min3, ctrl(tau[j] / P.tau_s * t1), 0.0]
                   for j in id1])
    return dict(t1=t1, x1=x1, u1=u1, id1=id1, xs=x1[-1],
                id2=np.arange(id1[-1], N), tau=tau)


def _check_guess(P, N, flip, xg, ug, pg, Sx, Su):
    """Largest normalized gap of the program's guess: the flip phase against
    its propagation here; the descent phase against its double-integrator
    dynamics (FOH, exact), its boundary values, the thrust cone, and the
    attitude, rate, mass and gimbal it implies."""
    gaps = []
    id1, id2, tau = flip["id1"], flip["id2"], flip["tau"]
    # the switch node id1[-1] = id2[0] carries the descent phase's values
    gaps.append(np.max(np.abs(xg[id1[:-1]] - flip["x1"][:-1]) / Sx))
    gaps.append(np.max(np.abs(ug[id1[:-1]] - flip["u1"][:-1]) / Su))
    gaps.append(abs(pg[0] - flip["t1"]) / P.tf_max)
    gaps.append(np.max(np.abs(pg[2:10] - flip["xs"]) / Sx))
    t2 = float(pg[1])
    gaps.append(abs(t2 - round(t2)) + max(0.0, 10.0 - t2, t2 - 40.0))
    x2, th, T = xg[id2], xg[id2, 4], ug[id2, 0]
    T2 = np.stack([-T * np.sin(th), T * np.cos(th)], axis=1)
    dtau = tau[id2[1]] - tau[id2[0]]
    dil = t2 / (1.0 - P.tau_s)
    A = np.zeros((4, 4))
    A[0:2, 2:4] = np.eye(2)
    Bu = np.zeros((4, 3))
    Bu[2:4, 0:2] = np.eye(2) / P.m
    Bu[3, 2] = -P.g0
    M = np.zeros((10, 10))
    M[0:4, 0:4], M[0:4, 4:7], M[4:7, 7:10] = A * dil, Bu * dil, np.eye(3)
    E = torch.linalg.matrix_exp(torch.as_tensor(M * dtau)).numpy()
    Ad, G1, G2 = E[0:4, 0:4], E[0:4, 4:7], E[0:4, 7:10] / dtau
    U = np.concatenate([T2, np.ones((len(id2), 1))], axis=1)
    res = x2[1:, :4] - (x2[:-1, :4] @ Ad.T + U[:-1] @ (G1 - G2).T
                        + U[1:] @ G2.T)
    gaps.append(np.max(np.abs(res) / Sx[:4]))
    gaps.append(np.max(np.abs(x2[0, :4] - flip["xs"][:4]) / Sx[:4]))
    gaps.append(np.max(np.abs(x2[-1, :4] - [0.0, 0.0, 0.0, P.vf_y])
                       / Sx[:4]))
    cos_t2 = math.cos(math.radians(P.theta_max2_deg))
    viol = np.maximum.reduce([T - P.T_max1, P.T_min1 - T2[:, 1],
                              T * cos_t2 - T2[:, 1], -x2[:, 1]])
    gaps.append(max(0.0, float(np.max(viol))) / P.T_max1)
    dt_abs = np.diff(tau[id2]) * dil
    om = np.append(np.diff(th) / dt_abs, 0.0)
    gaps.append(np.max(np.abs(x2[:, 5] - om) / Sx[5]))
    m = x2[0, 6] + np.concatenate([[0.0], np.cumsum(
        0.5 * (T[1:] + T[:-1]) * dt_abs)]) * P.alpha_e
    gaps.append(np.max(np.abs(x2[:, 6] - m) / Sx[6]))
    gaps.append(np.max(np.abs(x2[:, 7]) / Sx[7]))
    gaps.append(np.max(np.abs(ug[id2, 1:]) / Su[1:]))
    return float(max(gaps))
