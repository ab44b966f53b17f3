"""Apollo CSM transposition and docking rendezvous.

Counterpart of `scptoolbox_tpu/models/rendezvous_3d.py`
(`apollo_csm_geometry`, `Rendezvous3DParameters`, `rendezvous_3d`,
`solve_rendezvous_3d`; reference test/examples/rendezvous_3d/). A 6-DoF
chaser with 16 RCS thrusters (4 quads x 4 nozzles, geometry from the Apollo
CSM operations data book) docks with a target under Clohessy-Wiltshire
relative dynamics, solved by PTR with IMPULSE discretization: the thruster
impulses are state jumps at the nodes. The discrete logic (the minimum
impulse bit: a thruster fires at >= imp_min or not at all; plume
impingement keep-out for forward thrusters near the target; an approach
cone) is smoothed by sigmoid ORs whose sharpness `hom` climbs a ladder
driven by the solver callback: when the relative cost improvement drops
below beta the homotopy advances, the iteration budget grows and stopping
is vetoed (definition.jl:96-151). The gradient keep-out rows use
torch.func.grad of the smooth OR where the reference hand-codes the
derivatives, and the reference's host-side `mib_inflection()` test is a 0/1
weight.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
from torch.func import grad, vmap

from scptoolbox_torch.ops.discretize import DiscretizationType
from scptoolbox_torch.parser.problem import (BoundingBox, Constants,
                                             TrajectoryProblem, l1, linf,
                                             nonpos, soc)
from scptoolbox_torch.solvers import ptr
from scptoolbox_torch.solvers.solution import SCPSolution
from scptoolbox_torch.utils import quaternion as quat
from scptoolbox_torch.utils.smooth import Homotopy, smooth_or

IN2M = 0.0254
LB2KG = 0.453592
FT2SLUG2M2KG = 1.35581795

# state / input / parameter slots (reference parameters.jl:366-377)
ID_R = slice(0, 3)
ID_V = slice(3, 6)
ID_Q = slice(6, 10)
ID_W = slice(10, 13)
ID_RCS = slice(0, 16)
ID_RCS_REF = slice(16, 32)
ID_RCS_EQ = 32
ID_T = 0
ID_DOCK_TOL = slice(1, 14)
PF = slice(0, 16, 4)   # the forward nozzles (pf) of quads A-D


def _rot(axis: str, deg: float) -> np.ndarray:
    """Right-handed rotation matrix about a named axis (degrees)."""
    c, s = math.cos(math.radians(deg)), math.sin(math.radians(deg))
    if axis == "x":
        return np.asarray([[1, 0, 0], [0, c, -s], [0, s, c]])
    if axis == "y":
        return np.asarray([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    return np.asarray([[c, -s, 0], [s, c, 0], [0, 0, 1]])


def _hom(R=None, t=None) -> np.ndarray:
    H = np.eye(4)
    if R is not None:
        H[:3, :3] = R
    if t is not None:
        H[:3, 3] = t
    return H


def _hinv(H: np.ndarray) -> np.ndarray:
    R, v = H[:3, :3], H[:3, 3]
    Hi = np.eye(4)
    Hi[:3, :3] = R.T
    Hi[:3, 3] = -R.T @ v
    return Hi


def apollo_csm_geometry():
    """Thruster positions and directions in the dynamical frame, and the
    docking-port transform (reference ApolloCSM constructor,
    parameters.jl:107-200): (r_rcs (16, 3), f_rcs (16, 3), H_DP), numpy.
    Thruster order: quads A, B, C, D x nozzles pf, pa, rf, ra
    (rcs_select, parameters.jl:244-254)."""
    H_SD = _hom(t=np.asarray([933.9, 5.0, 4.7]) * IN2M)
    H_SR = _hom(R=_rot("x", -(7 + 15 / 60)))
    pan_RQ = {
        "A": np.asarray([958.97, 0.0, -83.56]) * IN2M,
        "B": np.asarray([958.97, 83.56, 0.0]) * IN2M,
        "C": np.asarray([958.97, 0.0, 83.56]) * IN2M,
        "D": np.asarray([958.97, -83.56, 0.0]) * IN2M,
    }
    rot_RQ = {"A": _rot("x", -90), "B": _rot("x", 0), "C": _rot("x", 90),
              "D": _rot("x", 180)}
    cant = 10.0
    pan_QT = {
        "pf": np.asarray([6.75, 0.0, 0.0]) * IN2M,
        "pa": np.asarray([-6.75, 0.0, 0.0]) * IN2M,
        "rf": np.asarray([0.94, 0.0, 3.125]) * IN2M,
        "ra": np.asarray([-0.94, 0.0, -3.125]) * IN2M,
    }
    rot_QT = {
        "pf": _rot("z", cant),
        "pa": _rot("y", 180) @ _rot("z", cant),
        "rf": _rot("y", -90) @ _rot("z", cant),
        "ra": _rot("y", 90) @ _rot("z", cant),
    }
    H_DS = _hinv(H_SD)
    r_rcs, f_rcs = [], []
    for quad in ("A", "B", "C", "D"):
        H_RQ = _hom(R=rot_RQ[quad], t=pan_RQ[quad])
        for noz in ("pf", "pa", "rf", "ra"):
            H_QT = _hom(R=rot_QT[noz], t=pan_QT[noz])
            H_DT = H_DS @ H_SR @ H_RQ @ H_QT
            r_rcs.append(H_DT[:3, 3])
            f_rcs.append(H_DT[:3, :3] @ np.asarray([-1.0, 0.0, 0.0]))
    H_SP = _hom(t=np.asarray([1110.25, 0.0, 0.0]) * IN2M) @ _hom(
        R=_rot("x", -30))
    H_DP = H_DS @ H_SP
    return np.stack(r_rcs), np.stack(f_rcs), H_DP


@dataclasses.dataclass(frozen=True)
class Rendezvous3DParameters:
    """Model constants (reference parameters.jl:355-450)."""

    m_lb: float = 66850.6
    imp_min: float = 50.0    # [N s] minimum impulse bit
    imp_max: float = 445.0   # [N s]
    orbit_alt: float = 400e3
    r0: tuple = (100.0, 20.0, -20.0)
    v0: tuple = (0.0, 0.0, 0.0)
    rf_tol: float = 0.1
    vf_tol: float = 0.01
    ang_tol_deg: float = 1.0
    wf_tol_deg: float = 0.01
    r_plume: float = 20.0
    r_appch: float = 30.0
    theta_appch_deg: float = 10.0
    tf_min: float = 100.0
    tf_max: float = 1000.0
    beta: float = 1e1 / 100  # homotopy-update improvement threshold
    gamma_c: float = 1.0     # deadband relaxation cost weight
    gamma_g: float = 5.0     # deadband gradient keepout offset
    hom_steps: int = 10

    @property
    def m(self) -> float:
        return self.m_lb * LB2KG

    @property
    def J(self) -> np.ndarray:
        Jxx, Jyy, Jzz = 36324.0, 80036.0, 81701.0
        Jxy, Jxz, Jyz = -2111.0, 273.0, 2268.0
        J = np.asarray([[Jxx, -Jxy, -Jxz], [-Jxy, Jyy, -Jyz],
                        [-Jxz, -Jyz, Jzz]])
        return J * FT2SLUG2M2KG

    @property
    def n_orbit(self) -> float:
        mu, Re = 3.986e14, 6378e3
        return float(np.sqrt(mu / (Re + self.orbit_alt) ** 3))

    def hom_grid(self) -> np.ndarray:
        hom = Homotopy(delta_min=1e-2, delta_max=10.0)
        return np.asarray([float(hom(x))
                           for x in np.linspace(0.0, 1.0, self.hom_steps)])

    def terminal_pose(self):
        """Docked pose from the docking-port geometry (parameters.jl:399-406,
        H_LD = yaw(180) inv(H_DP)): (rf (3,), qf (4,)), float64 numpy."""
        _, _, H_DP = apollo_csm_geometry()
        H_LD = _hom(R=_rot("z", 180)) @ _hinv(H_DP)
        qf = quat.from_dcm(torch.as_tensor(H_LD[:3, :3], dtype=torch.float64))
        return H_LD[:3, 3].copy(), qf.numpy()


def _mib_or(fr, hom, mdl):
    """Smooth minimum-impulse-bit OR(fr - imp_min) (definition.jl:517-540)."""
    span = mdl.imp_max - mdl.imp_min
    return smooth_or([fr - mdl.imp_min], kappa=hom, match=span,
                     normalize=span)


def rendezvous_3d(mdl: Rendezvous3DParameters = Rendezvous3DParameters(),
                  N: int = 25) -> TrajectoryProblem:
    """The TrajectoryProblem (reference definition.jl:23-765). N enters
    through the terminal-node mask of the attitude alignment row
    (definition.jl:353-420 `if k == N`)."""
    r_rcs, f_rcs, _ = apollo_csm_geometry()
    rf_vec, qf = mdl.terminal_pose()
    norb = mdl.n_orbit
    q0 = np.asarray([0.0, 0.0, 0.0, 1.0])
    cst = Constants(
        f_rcs=f_rcs, torque_arms=np.cross(r_rcs, f_rcs), J=mdl.J,
        iJ=np.linalg.inv(mdl.J), qf=qf,
        x0=np.concatenate([mdl.r0, mdl.v0, q0, np.zeros(3)]),
        xf=np.concatenate([rf_vec, [-0.1, 0.0, 0.0], qf, np.zeros(3)]))
    cos_ang_tol = math.cos(math.radians(mdl.ang_tol_deg) / 2.0)
    wf_tol = math.radians(mdl.wf_tol_deg)
    r0n = float(np.linalg.norm(mdl.r0))
    or_plume_max = r0n - mdl.r_plume
    or_appch_max = r0n - mdl.r_appch
    cos_appch = math.cos(math.radians(mdl.theta_appch_deg))

    def thrust_terms(x, u):
        # rotate by the normalized quaternion: `rotate` scales with ||q||^2
        # and the subproblem has no convex way to pin ||q|| = 1, so the raw
        # q would let each re-linearization reward inflating the quaternion
        # (more apparent thrust per impulse); on the unit sphere this is the
        # reference model
        c = cst(x)
        q = quat.normalize(x[ID_Q])
        rcs = u[ID_RCS]
        dv = torch.sum(rcs[:, None] * quat.rotate(q, c["f_rcs"]),
                       dim=0) / mdl.m
        dw = c["iJ"] @ torch.sum(rcs[:, None] * c["torque_arms"], dim=0)
        return dv, dw

    def f(t, x, u, p):
        # coasting rigid body + Clohessy-Wiltshire (definition.jl:221-259);
        # under IMPULSE integration it is evaluated with u = 0
        c = cst(x)
        r, v, q, w = x[ID_R], x[ID_V], x[ID_Q], x[ID_W]
        dv_T, dw_T = thrust_terms(x, u)
        dv = dv_T + torch.stack([
            -2.0 * norb * v[2], -norb ** 2 * r[1],
            3.0 * norb ** 2 * r[2] + 2.0 * norb * v[0]])
        dq = 0.5 * quat.mul(q, quat.from_parts(w, 0.0))
        dw = dw_T - c["iJ"] @ torch.linalg.cross(w, c["J"] @ w)
        return p[ID_T] * torch.cat([v, dv, dq, dw])

    def impulse(t, x, u, p):
        # the state jump at node k: impulses only, no time dilation
        # (definition.jl:224-246 `impulse = k < 0` branch)
        dv, dw = thrust_terms(x, u)
        z = x.new_zeros(4)
        return torch.cat([z[:3], dv, z, dw])

    def running_cost(t, k, x, u, p):
        # definition.jl:196-211
        return (torch.sum(u[ID_RCS]) / mdl.imp_max
                + mdl.gamma_c * u[ID_RCS_EQ] / mdl.imp_min)

    def X(t, k, x, p):
        # terminal docking tolerances (definition.jl:346-423 `if k == N`).
        # The parameter-only tolerance boxes (drf, dvf, dwf in LINF balls)
        # do not depend on the node and are posted at every node (the same
        # feasible set, and no masked row that is identically zero); the
        # attitude alignment keeps the terminal mask and is strictly
        # feasible at the other nodes
        last = (k == N - 1).to(x.dtype)
        dtol = p[ID_DOCK_TOL]
        drf, dvf, dwf = dtol[0:3], dtol[3:6], dtol[10:13]
        qk = x[ID_Q]
        one = x.new_ones(1)
        return [
            linf(torch.cat([mdl.rf_tol * one, drf])),
            linf(torch.cat([mdl.vf_tol * one, dvf])),
            nonpos((last * (cos_ang_tol - torch.dot(qk, cst(x)["qf"]))
                    - (1.0 - last))[None]),
            linf(torch.cat([wf_tol * one, dwf])),
            # ||q|| <= 1, the convex restriction of the unit sphere: it
            # removes the one direction in which the subproblem could drift
            # off the sphere and cuts no feasible trajectory
            soc(torch.cat([one, qk])),
        ]

    def U(t, k, u, p):
        # definition.jl:426-497
        fv, frv = u[ID_RCS], u[ID_RCS_REF]
        feq = u[ID_RCS_EQ]
        imp_max = mdl.imp_max * u.new_ones(1)
        return [
            nonpos(torch.cat(
                [-fv, -frv,
                 torch.stack([p[ID_T] - mdl.tf_max, mdl.tf_min - p[ID_T]])])),
            linf(torch.cat([imp_max, fv])),
            linf(torch.cat([imp_max, frv])),
            l1(torch.cat([feq[None], fv - frv])),
        ]

    def s(t, k, x, u, p, consts):
        # definition.jl:587-697: minimum impulse bit, gradient keep-out,
        # plume impingement, approach cone, all at the sharpness hom
        hom = consts["hom"]
        r = x[ID_R]
        fv, frv = u[ID_RCS], u[ID_RCS_REF]

        OR = _mib_or(frv, hom, mdl)                       # (16,)
        mib_rows = torch.cat([fv - OR * frv, OR * frv - fv])

        # forbid exploiting the deadband relaxation: d(OR(fr) fr)/dfr may
        # not exceed its value at fr = imp_min + gamma_g, enforced only when
        # the relaxed curve has an interior gradient peak (the reference's
        # mib_inflection() test, definition.jl:542-616, as a 0/1 weight)
        g_of = grad(lambda z: _mib_or(z, hom, mdl) * z)
        at = lambda v: torch.as_tensor(v, dtype=u.dtype, device=u.device)
        grad_db = g_of(at(mdl.imp_min))
        grad_plus = g_of(at(mdl.imp_min + mdl.gamma_g))
        grad_minus = g_of(at(mdl.imp_min - mdl.gamma_g))
        inflected = ((grad_db > grad_minus) & (grad_db > grad_plus)).to(
            u.dtype)
        keepout_rows = inflected * (vmap(g_of)(frv) - grad_plus)

        # plume impingement: the forward thrusters may not fire near the
        # target
        rTr = torch.dot(r, r)
        OR_plume = smooth_or([rTr - mdl.r_plume ** 2], kappa=hom,
                             match=or_plume_max, normalize=or_plume_max)
        plume_rows = fv[PF] - OR_plume * mdl.imp_max

        # approach cone inside r_appch (the normalization is the plume's, as
        # in the reference, definition.jl:573-585)
        OR_appch = smooth_or([rTr - mdl.r_appch ** 2], kappa=hom,
                             match=or_appch_max, normalize=or_plume_max)
        rn = torch.sqrt(rTr + 1e-12)
        cone_row = cos_appch - OR_appch * (1.0 + cos_appch) - r[0] / rn
        return torch.cat(
            [mib_rows, keepout_rows, plume_rows, cone_row[None]])

    def gic(x, p):
        return x - cst(x)["x0"]

    def gtc(x, p):
        # x + dock_tol == the terminal pose (definition.jl:734-762), and the
        # axial position tolerance pinned to zero (drf[0] = 0, a global
        # equality rather than a masked per-node zero row)
        dtol = p[ID_DOCK_TOL]
        return torch.cat([x + dtol - cst(x)["xf"], dtol[0][None]])

    def actions(x):
        return torch.cat([x[:6], quat.normalize(x[ID_Q]), x[10:13]])

    q0_t = torch.as_tensor(q0)
    qf_t = torch.as_tensor(qf)
    rotvec = quat.log(quat.mul(quat.conj(q0_t), qf_t)).numpy()

    def guess(N_, consts):
        # definition.jl:153-192: a straight line and a SLERP coast
        tf = 0.8 * (mdl.tf_min + mdl.tf_max)
        tau = np.linspace(0.0, 1.0, N_)[:, None]
        r_g = np.asarray(mdl.r0)[None] * (1 - tau) + rf_vec[None] * tau
        v_g = np.broadcast_to((rf_vec - np.asarray(mdl.r0)) / tf, (N_, 3))
        q_g = torch.stack([quat.slerp(q0_t, qf_t, m_) for m_ in
                           torch.linspace(0.0, 1.0, N_,
                                          dtype=torch.float64)]).numpy()
        w_g = np.broadcast_to(rotvec / tf, (N_, 3))
        x = np.concatenate([r_g, v_g, q_g, w_g], axis=1)
        p = np.zeros(14)
        p[ID_T] = tf
        return x, np.zeros((N_, 33)), p

    # scaling advice (definition.jl:47-79)
    v_max = r0n / mdl.tf_min
    w_max = float(np.linalg.norm(rotvec)) / mdl.tf_min
    x_lo = np.concatenate([-r0n * np.ones(3), -v_max * np.ones(3),
                           np.zeros(4), -w_max * np.ones(3)])
    x_hi = np.concatenate([r0n * np.ones(3), v_max * np.ones(3),
                           np.ones(4), w_max * np.ones(3)])
    u_lo = np.zeros(33)
    u_hi = np.concatenate([mdl.imp_max * np.ones(32), [16 * mdl.imp_min]])
    p_lo = np.concatenate([[mdl.tf_min], -mdl.rf_tol * np.ones(3),
                           -mdl.vf_tol * np.ones(3), np.zeros(4),
                           -wf_tol * np.ones(3)])
    p_hi = np.concatenate([[mdl.tf_max], mdl.rf_tol * np.ones(3),
                           mdl.vf_tol * np.ones(3), np.ones(4),
                           wf_tol * np.ones(3)])

    return TrajectoryProblem(
        nx=13, nu=33, np=14, f=f, impulse=impulse, guess=guess,
        consts={"hom": torch.tensor(float(mdl.hom_grid()[0]),
                                    dtype=torch.float64)},
        running_cost=running_cost, X=X, U=U, s=s, gic=gic, gtc=gtc,
        integration_actions=actions,
        xrg=BoundingBox(lo=x_lo, hi=x_hi), urg=BoundingBox(lo=u_lo, hi=u_hi),
        prg=BoundingBox(lo=p_lo, hi=p_hi))


def solve_rendezvous_3d(
        N: int = 25,
        mdl: Rendezvous3DParameters = Rendezvous3DParameters(),
        pars: Optional[ptr.PTRParameters] = None,
        beta: Optional[float] = None, verbose: bool = False,
        dtype=None, device=None) -> SCPSolution:
    """PTR with the callback-driven homotopy ladder (reference
    definition.jl:96-151 and tests.jl:22-64): when the relative improvement
    falls inside (worsen_tol, beta] the sharpness advances one rung, the
    iteration budget is extended and stopping is vetoed. On the card unless
    `device` says otherwise."""
    pbm = rendezvous_3d(mdl, N)
    if pars is None:
        pars = ptr.PTRParameters(
            N=N, Nsub=10, iter_max=30,
            disc_method=DiscretizationType.IMPULSE,
            wvc=1e4, wtr=5e0, eps_abs=-np.inf, eps_rel=1e-5, feas_tol=5e-3,
            ipm_max_iter=100)  # the reference runs ECOS with maxit=1000
    solver = ptr.PTR(pbm, pars, dtype=dtype, device=device)
    hom_grid = mdl.hom_grid()
    state = {"i": 0, "last_update": 0}
    beta = mdl.beta if beta is None else beta
    worsen_tol = -1e-1 / 100

    def callback(rec):
        # definition.jl:101-138
        advance = worsen_tol <= rec.improv_rel <= beta
        if advance and state["i"] < len(hom_grid) - 1:
            state["i"] += 1
            solver.consts = {"hom": torch.tensor(
                float(hom_grid[state["i"]]), dtype=solver.dtype,
                device=solver.device)}
            solver.extra_iters += rec.iteration - state["last_update"]
            state["last_update"] = rec.iteration
            if verbose:
                print(f"  homotopy -> {float(hom_grid[state['i']]):.2e}")
            return True
        return False

    pbm.callback = callback
    # the homotopy rung as a progress-table column (reference
    # problem_add_table_column!, definition.jl:141-148)
    pbm.add_table_column(
        "hom", "hom", "{:>10s}",
        lambda rec: f"{float(hom_grid[state['i']]):.2e}")
    return solver.solve(verbose=verbose)
