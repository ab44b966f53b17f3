"""6-DoF free-flyer inside the ISS.

Counterpart of `scptoolbox_tpu/models/freeflyer.py` (`FreeFlyerParameters`
:150, `freeflyer` :212; reference test/examples/freeflyer/ parameters.jl:
27-192, definition.jl:27-517). State (r, v, q, omega) in R^13 with a
scalar-last unit quaternion, input (T, M) in R^6 (thrust and torque),
parameter p = [tdil, delta] where delta in R^{N n_iss} holds the per-node,
per-room signed-distance slacks. The vehicle flies between rest states
through the union of six station rooms (a smooth SDF union, logsumexp over
the per-room LINF distances, definition.jl:393-401) while it avoids three
spherical obstacles. The quaternion is renormalized after every RK4 step
(an integration action, definition.jl:69-82).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from scptoolbox_torch.parser.problem import (BoundingBox, Constants,
                                             TrajectoryProblem, linf, nonpos,
                                             soc)
from scptoolbox_torch.utils import quaternion as quat
from scptoolbox_torch.utils.geometry import Ellipsoid, Hyperrectangle
from scptoolbox_torch.utils.smooth import logsumexp


@dataclasses.dataclass(frozen=True)
class FreeFlyerParameters:
    """Vehicle, environment and trajectory data
    (reference freeflyer/parameters.jl:107-192)."""

    v_max: float = 0.4
    omega_max: float = float(np.deg2rad(1.0))
    T_max: float = 20e-3
    M_max: float = 1e-4
    m: float = 7.2
    J_diag: Tuple[float, ...] = (0.1083, 0.1083, 0.1083)
    r0: Tuple[float, ...] = (6.5, -0.2, 5.0)
    v0: Tuple[float, ...] = (0.035, 0.035, 0.0)
    q0_angle_deg: float = -40.0
    q0_axis: Tuple[float, ...] = (0.0, 1.0, 1.0)
    omega0: Tuple[float, ...] = (0.0, 0.0, 0.0)
    rf: Tuple[float, ...] = (11.3, 6.0, 4.5)
    vf: Tuple[float, ...] = (0.0, 0.0, 0.0)
    qf_angle_deg: float = 0.0
    qf_axis: Tuple[float, ...] = (0.0, 0.0, 1.0)
    omegaf: Tuple[float, ...] = (0.0, 0.0, 0.0)
    tf_min: float = 60.0
    tf_max: float = 200.0
    gamma: float = 0.0
    hom: float = 50.0      # SDF logsumexp sharpness (parameters.jl:171)
    eps_sdf: float = 1e-4  # room-SDF tightening weight (parameters.jl:172)

    def obstacles(self):
        """Three spherical keep-out zones (parameters.jl:110-116), float64
        on the CPU."""
        shape = torch.eye(3, dtype=torch.float64) / 0.3
        T = lambda v: torch.tensor(v, dtype=torch.float64)
        return [Ellipsoid(shape, T([8.5, -0.15, 5.0])),
                Ellipsoid(shape, T([11.2, 1.84, 5.0])),
                Ellipsoid(shape, T([11.3, 3.8, 4.8]))]

    def rooms(self):
        """Six ISS flight-corridor rooms (parameters.jl:117-124)."""
        z = 4.75
        box = Hyperrectangle.from_extrusion
        return [
            box([6.0, 0.0, z], 1.0, 1.0, 1.5, pitch=90.0),
            box([7.5, 0.0, z], 2.0, 2.0, 4.0, pitch=90.0),
            box([11.5, 0.0, z], 1.25, 1.25, 0.5, pitch=90.0),
            box([10.75, -1.0, z], 1.5, 1.5, 1.5, yaw=-90.0, pitch=90.0),
            box([10.75, 1.0, z], 1.5, 1.5, 1.5, yaw=90.0, pitch=90.0),
            box([10.75, 2.5, z], 2.5, 2.5, 4.5, yaw=90.0, pitch=90.0),
        ]

    def q0(self):
        return quat.from_angleaxis(
            float(np.deg2rad(self.q0_angle_deg)),
            torch.tensor(self.q0_axis, dtype=torch.float64))

    def qf(self):
        return quat.from_angleaxis(
            float(np.deg2rad(self.qf_angle_deg)),
            torch.tensor(self.qf_axis, dtype=torch.float64))


def freeflyer(mdl: FreeFlyerParameters = FreeFlyerParameters(),
              N: int = 50) -> TrajectoryProblem:
    """The TrajectoryProblem (reference definition.jl:27-517). The per-node
    room slacks live in the parameter vector, p = [tdil, delta.ravel()]
    with delta of shape (N, n_iss) (parameters.jl:135 `id_δ`), so N is part
    of the problem."""
    rooms = mdl.rooms()
    obs = mdl.obstacles()
    n_iss, n_obs = len(rooms), len(obs)
    npp = 1 + N * n_iss
    q0, qf = mdl.q0().numpy(), mdl.qf().numpy()
    room_c = np.stack([R.center.numpy() for R in rooms])   # (n_iss, 3)
    room_s = np.stack([R.s.numpy() for R in rooms])        # (n_iss, 3)
    cst = Constants(
        J=np.diag(mdl.J_diag), Jinv=np.diag(1.0 / np.asarray(mdl.J_diag)),
        room_c=room_c, room_s=room_s,
        H=np.stack([E.H.numpy() for E in obs]),
        c=np.stack([E.c.numpy() for E in obs]),
        x0=np.concatenate([mdl.r0, mdl.v0, q0, mdl.omega0]),
        xf=np.concatenate([mdl.rf, mdl.vf, qf, mdl.omegaf]),
        nodes=np.arange(N))

    def delta_at(p, k):
        """The room slacks delta[k] (n_iss,) of node k (a 0-d tensor that
        vmap may batch), picked by a one-hot row."""
        pick = (cst(p)["nodes"] == k).to(p.dtype)
        return pick @ p[1:].reshape(N, n_iss)

    def f(t, x, u, p):
        # definition.jl:229-244: time-dilated translational and rotational
        # rigid-body dynamics, dq/dt = 0.5 q (x) [omega; 0]
        c = cst(x)
        v, q, om = x[3:6], x[6:10], x[10:13]
        T, M = u[:3], u[3:6]
        dq = 0.5 * quat.mul(q, quat.from_parts(om, 0.0))
        dom = c["Jinv"] @ (M - torch.linalg.cross(om, c["J"] @ om))
        return p[0] * torch.cat([v, T / mdl.m, dq, dom])

    def terminal_cost(x, p):
        # definition.jl:172-184: flight-time tradeoff + SDF tightening
        return (mdl.gamma * (p[0] / mdl.tf_max) ** 2
                + mdl.eps_sdf * torch.sum(-p[1:]))

    def running_cost(t, k, x, u, p):
        # definition.jl:187-219 (SCvx quadratic; GuSTO's S-matrix is the
        # same quadratic form)
        T, M = u[:3], u[3:6]
        return (1.0 - mdl.gamma) * (torch.dot(T, T) / mdl.T_max ** 2
                                    + torch.dot(M, M) / mdl.M_max ** 2)

    def X(t, k, x, p):
        # definition.jl:286-348: speed and rate SOCs, the duration box, and
        # the per-room LINF SDF bounds 1 - delta_ik >= ||(r-c_i)/s_i||_inf
        c = cst(x)
        r, v, om = x[:3], x[3:6], x[10:13]
        dk = delta_at(p, k)
        one = x.new_ones(1)
        cons = [
            soc(torch.cat([mdl.v_max * one, v])),
            soc(torch.cat([mdl.omega_max * one, om])),
            nonpos(torch.stack([p[0] - mdl.tf_max, mdl.tf_min - p[0]])),
        ]
        for i in range(n_iss):
            cons.append(linf(torch.cat(
                [(1.0 - dk[i])[None], (r - c["room_c"][i]) / c["room_s"][i]])))
        return cons

    def U(t, k, u, p):
        # definition.jl:351-376: thrust and torque SOC bounds
        one = u.new_ones(1)
        return [soc(torch.cat([mdl.T_max * one, u[:3]])),
                soc(torch.cat([mdl.M_max * one, u[3:6]]))]

    def s(t, k, x, u, p):
        # definition.jl:384-403: ellipsoid obstacles + smooth room-union SDF
        c = cst(x)
        r = x[:3]
        obs_rows = torch.stack([1.0 - Ellipsoid(c["H"][i], c["c"][i])(r)
                                for i in range(n_obs)])
        d = logsumexp(delta_at(p, k), kappa=mdl.hom)
        return torch.cat([obs_rows, (-d)[None]])

    def gic(x, p):
        return x - cst(x)["x0"]

    def gtc(x, p):
        return x - cst(x)["xf"]

    def actions(x):
        # quaternion renormalization after each RK4 step
        # (definition.jl:69-82, reference problem.jl:296-305)
        return torch.cat([x[:6], quat.normalize(x[6:10]), x[10:]])

    def guess(N_):
        # definition.jl:84-167: L-shaped axis-aligned position path, SLERP
        # attitude, constant angular velocity, zero input, SDF slack guess
        assert N_ == N
        tf = 0.5 * (mdl.tf_min + mdl.tf_max)
        r0_, rf_ = np.asarray(mdl.r0), np.asarray(mdl.rf)
        speed = np.abs(rf_ - r0_).sum() / tf
        leg_t = np.abs(rf_ - r0_) / speed
        cumul = np.cumsum(leg_t)
        x = np.zeros((N, 13))
        times = np.linspace(0.0, tf, N)
        for k, tk in enumerate(times):
            i = int(np.searchsorted(cumul, min(tk, cumul[-1] - 1e-12)))
            t0 = cumul[i - 1] if i > 0 else 0.0
            ra = r0_.copy()
            ra[:i] = rf_[:i]
            rb = ra.copy()
            rb[i] = rf_[i]
            lam = np.clip((tk - t0) / max(cumul[i] - t0, 1e-12), 0.0, 1.0)
            x[k, :3] = (1 - lam) * ra + lam * rb
            d = rb - ra
            x[k, 3:6] = speed * d / max(np.linalg.norm(d), 1e-12)
        q0_t, qf_t = mdl.q0(), mdl.qf()
        x[:, 6:10] = torch.stack([quat.slerp(q0_t, qf_t, float(m))
                                  for m in np.linspace(0.0, 1.0, N)]).numpy()
        rotvec = quat.log(quat.mul(qf_t, quat.conj(q0_t))).numpy()
        x[:, 10:13] = rotvec / tf
        u = np.zeros((N, 6))
        # room SDF guess: delta[k,i] = 1 - ||(r_k - c_i)/s_i||_inf
        # (definition.jl:149-156)
        dist = np.abs(x[:, None, :3] - room_c[None]) / room_s[None]
        delta = 1.0 - dist.max(axis=-1)
        p = np.concatenate([[tf], delta.ravel()])
        return x, u, p

    # scaling advice exactly as the reference gives it (definition.jl:52-67):
    # position extent, flight time, delta in [-100, 1]. Velocity, attitude,
    # rates and inputs are left unadvised (NaN), so the LP auto-scaling
    # bounds them from the X/U sets (v in +-v_max, omega in +-omega_max, T/M
    # from the SOC bounds; the unconstrained quaternion keeps the [0, 1]
    # default) — reference scp.jl:376-517
    min_pos = np.minimum(mdl.r0, mdl.rf)
    max_pos = np.maximum(mdl.r0, mdl.rf)
    x_lo = np.concatenate([min_pos, np.full(10, np.nan)])
    x_hi = np.concatenate([max_pos, np.full(10, np.nan)])
    p_lo = np.concatenate([[mdl.tf_min], -100.0 * np.ones(N * n_iss)])
    p_hi = np.concatenate([[mdl.tf_max], np.ones(N * n_iss)])

    return TrajectoryProblem(
        nx=13, nu=6, np=npp, f=f, guess=guess,
        terminal_cost=terminal_cost, running_cost=running_cost,
        X=X, U=U, s=s, gic=gic, gtc=gtc,
        integration_actions=actions,
        xrg=BoundingBox(lo=x_lo, hi=x_hi),
        prg=BoundingBox(lo=p_lo, hi=p_hi),
    )
