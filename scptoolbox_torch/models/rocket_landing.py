"""Mars 3-DoF powered-descent guidance by lossless convexification.

Counterpart of `scptoolbox_tpu/models/rocket_landing.py` (`Rocket` :39,
`PDGSolution` :111, `build_program` :126, `solve_pdg` :264, `solve_lcvx`
:285, `simulate` :297; reference test/examples/rocket_landing/). Minimum
fuel descent with z = log m, the thrust-annulus relaxation xi >= ||u||, thrust
bounds linearized (upper) or quadratic (lower) about the nominal mass
profile, glide-slope and pointing cones. The flight time tf is a parameter
of one ConicProgram (dt = tf / (N - 1), the exact ZOH matrices and the mass
profile bounds are functions of it), and a golden-section search over tf
re-solves that program with a new tf per probe.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from scptoolbox_torch.ops.ipm import IPMStatus
from scptoolbox_torch.parser.problem import nonpos, soc, zero
from scptoolbox_torch.parser.program import ConicProgram
from scptoolbox_torch.utils.geometry import skew
from scptoolbox_torch.utils.linsys import c2d_zoh
from scptoolbox_torch.utils.search import golden


@dataclasses.dataclass(frozen=True)
class Rocket:
    """Mars-landing vehicle (reference parameters.jl:80-150): six engines
    canted phi off vertical, throttled to [30%, 80%] of T_max; alpha =
    1/(Isp g_e cos phi) is the mass-depletion rate per unit thrust."""

    m_dry: float = 1505.0
    m_wet: float = 1905.0
    Isp: float = 225.0
    n_eng: int = 6
    phi_deg: float = 27.0
    T_max_engine: float = 3.1e3
    throttle: tuple = (0.3, 0.8)
    gamma_gs_deg: float = 86.0   # max approach (glide-slope) angle
    gamma_p_deg: float = 40.0    # max pointing angle
    v_max: float = 500e3 / 3600.0
    g_mars: float = 3.7114
    latitude_deg: float = 30.0
    r0: tuple = (2000.0, 0.0, 1500.0)
    v0: tuple = (80.0, 30.0, -75.0)

    @property
    def phi(self):
        return math.radians(self.phi_deg)

    @property
    def alpha(self):
        return 1.0 / (self.Isp * 9.807 * math.cos(self.phi))

    @property
    def rho_min(self):
        return (self.n_eng * self.throttle[0] * self.T_max_engine
                * math.cos(self.phi))

    @property
    def rho_max(self):
        return (self.n_eng * self.throttle[1] * self.T_max_engine
                * math.cos(self.phi))

    @property
    def omega(self):
        """Planet angular velocity at the landing site's latitude."""
        th = math.radians(self.latitude_deg)
        w = 2.0 * math.pi / (24.6229 * 3600.0)
        return np.asarray([w * math.cos(th), 0.0, w * math.sin(th)])

    def continuous_dynamics(self):
        """(A_c, B_c, p_c) of d/dt [r; v; z] in the rotating frame
        (parameters.jl:109-127), input (u, xi), dz/dt = -alpha xi."""
        wx = skew(torch.as_tensor(self.omega)).numpy()
        A = np.zeros((7, 7))
        A[0:3, 3:6] = np.eye(3)
        A[3:6, 0:3] = -(wx @ wx)
        A[3:6, 3:6] = -2.0 * wx
        B = np.zeros((7, 4))
        B[3:6, 0:3] = np.eye(3)
        B[6, 3] = -self.alpha
        p = np.zeros(7)
        p[5] = -self.g_mars
        return A, B, p

    @property
    def tf_bounds(self):
        """Physical flight-time bracket of the golden search
        (tests.jl:28-30)."""
        v0n = float(np.linalg.norm(self.v0))
        tf_min = self.m_dry * v0n / self.rho_max
        tf_max = (self.m_wet - self.m_dry) / (self.alpha * self.rho_min)
        return tf_min, tf_max


class PDGSolution(NamedTuple):
    t: np.ndarray        # (N,)
    r: np.ndarray        # (N, 3)
    v: np.ndarray        # (N, 3)
    z: np.ndarray        # (N,) log-mass
    u: np.ndarray        # (N-1, 3) thrust acceleration
    xi: np.ndarray       # (N-1,) acceleration-magnitude slack
    cost: float
    T: np.ndarray        # (N-1, 3) thrust [N]
    T_nrm: np.ndarray    # (N-1,)
    m: np.ndarray        # (N,) mass [kg]
    gamma: np.ndarray    # (N-1,) pointing angle [rad]
    status: int


def build_program(rocket: Rocket, N: int = 80, dtype=None,
                  device=None) -> ConicProgram:
    """The fixed-tf PDG conic program with tf as a parameter (reference
    definition.jl:46-136), on the card unless `device` says otherwise."""
    prg = ConicProgram(dtype=dtype, device=device)
    on = lambda a: torch.as_tensor(a, dtype=prg.dtype, device=prg.device)
    A_np, B_np, p_np = rocket.continuous_dynamics()
    A_c = on(A_np)
    # p_c as a constant input column: one exact ZOH exponential covers both
    Bp_c = on(np.concatenate([B_np, p_np[:, None]], axis=1))
    al, rmin, rmax = rocket.alpha, rocket.rho_min, rocket.rho_max
    m_wet, m_dry = rocket.m_wet, rocket.m_dry
    cos_gp = math.cos(math.radians(rocket.gamma_p_deg))
    g_gs = math.radians(rocket.gamma_gs_deg)
    H_gs = on([[math.cos(g_gs), 0.0, -math.sin(g_gs)],
               [-math.cos(g_gs), 0.0, -math.sin(g_gs)],
               [0.0, math.cos(g_gs), -math.sin(g_gs)],
               [0.0, -math.cos(g_gs), -math.sin(g_gs)]])
    r0, v0 = on(rocket.r0), on(rocket.v0)

    def t_grid(tf):
        dt = tf / (N - 1)
        return dt, torch.arange(N, dtype=tf.dtype, device=tf.device) * dt

    def z0_of(t):
        # nominal max-thrust log-mass profile (definition.jl:91-94)
        return torch.log(m_wet - al * rmax * t)

    r = prg.variable("r", N, 3)
    v = prg.variable("v", N, 3)
    z = prg.variable("z", N)
    u = prg.variable("u", N - 1, 3)
    xi = prg.variable("xi", N - 1)
    tf = prg.parameter("tf", 0.5 * sum(rocket.tf_bounds))

    def dyn(r, v, z, u, xi, tf):
        # exact ZOH at dt(tf) (definition.jl:44, 87-89)
        dt, _ = t_grid(tf)
        Ad, Bd = c2d_zoh(A_c, Bp_c, dt)
        X = torch.cat([r, v, z[:, None]], dim=1)            # (N, 7)
        U = torch.cat([u, xi[:, None]], dim=1)              # (N-1, 4)
        res = X[1:] - X[:-1] @ Ad.T - U @ Bd[:, :4].T - Bd[:, 4]
        return [zero(res.reshape(-1))]

    prg.add_constraint("dyn", dyn, (r, v, z, u, xi, tf))

    def thrust_upper(z, xi, tf):
        # xi <= mu_max (1 - dz), affine (definition.jl:96)
        _, t = t_grid(tf)
        z0 = z0_of(t[:-1])
        mu_max = rmax * torch.exp(-z0)
        return [nonpos(xi - mu_max * (1.0 - (z[:-1] - z0)))]

    prg.add_constraint("thrust_upper", thrust_upper, (z, xi, tf))

    def thrust_lower(z, xi, tf):
        # xi >= mu_min (1 - dz + dz^2/2) (definition.jl:95), as the SOC
        # [q+1, 2 dz, q-1] with q = 2 (xi - mu_min (1 - dz)) / mu_min
        _, t = t_grid(tf)
        z0 = z0_of(t[:-1])
        mu_min = rmin * torch.exp(-z0)
        dz = z[:-1] - z0
        q = 2.0 * (xi - mu_min * (1.0 - dz)) / mu_min
        rows = torch.stack([q + 1.0, 2.0 * dz, q - 1.0], dim=1)
        return [soc(rows[k]) for k in range(N - 1)]

    prg.add_constraint("thrust_lower", thrust_lower, (z, xi, tf))

    def mass_bounds(z, tf):
        # z0(t) <= z <= log(m_wet - alpha rho_min t) (definition.jl:99-100)
        _, t = t_grid(tf)
        return [nonpos(torch.cat(
            [z0_of(t) - z, z - torch.log(m_wet - al * rmin * t)]))]

    prg.add_constraint("mass_bounds", mass_bounds, (z, tf))

    def lcvx_cone(u, xi):
        # ||u_k|| <= xi_k (definition.jl:103)
        rows = torch.cat([xi[:, None], u], dim=1)
        return [soc(rows[k]) for k in range(N - 1)]

    prg.add_constraint("lcvx", lcvx_cone, (u, xi))
    # u_z >= xi cos(gamma_p) (definition.jl:106-107)
    prg.add_constraint("pointing", lambda u, xi: [nonpos(
        xi * cos_gp - u[:, 2])], (u, xi))
    prg.add_constraint("glide_slope", lambda r: [nonpos(
        (r @ H_gs.T).reshape(-1))], (r,))

    def vel_bound(v):
        rows = torch.cat([torch.full((N, 1), rocket.v_max, dtype=v.dtype,
                                     device=v.device), v], dim=1)
        return [soc(rows[k]) for k in range(N)]

    prg.add_constraint("vel_bound", vel_bound, (v,))

    def bcs(r, v, z):
        # definition.jl:126-131
        return [
            zero(torch.cat([r[0] - r0, v[0] - v0,
                            (z[0] - math.log(m_wet)).reshape(1), r[-1],
                            v[-1]])),
            nonpos((math.log(m_dry) - z[-1]).reshape(1)),
        ]

    prg.add_constraint("bcs", bcs, (r, v, z))
    prg.add_cost(lambda xi, tf: t_grid(tf)[0] * torch.sum(xi), (xi, tf))

    # scaling as in the reference (definition.jl:56-74)
    prg.scale(r, np.maximum(np.abs(rocket.r0), 1.0), np.zeros(3))
    prg.scale(v, np.maximum(np.abs(rocket.v0), 1.0), np.zeros(3))
    s_z = 0.5 * (math.log(m_dry) + math.log(m_wet))
    prg.scale(z, math.log(m_wet) - s_z, s_z)
    a_max = rmax / m_dry
    s_u3 = 0.5 * (rmin / m_wet * cos_gp + a_max)
    sin_gp = math.sin(math.radians(rocket.gamma_p_deg))
    prg.scale(u, [a_max * sin_gp, a_max * sin_gp, a_max - s_u3],
              [0.0, 0.0, s_u3])
    prg.scale(xi, a_max - s_u3, s_u3)
    prg.build()
    return prg


def solve_pdg(prg: ConicProgram, rocket: Rocket, tf: float,
              N: int = 80) -> PDGSolution:
    """The fixed-flight-time subproblem (reference `solve_pdg_fft`,
    definition.jl:33-154), with the thrust, mass and pointing angle derived;
    the cost is +inf unless the IPM is OPTIMAL."""
    sol = prg.solve(tf=tf)
    vals = {k: val.cpu().numpy() for k, val in sol.values.items()}
    ok = int(sol.status) == int(IPMStatus.OPTIMAL)
    z = vals["z"]
    m = np.exp(z)
    u = vals["u"]
    T = m[:-1, None] * u
    T_nrm = np.linalg.norm(T, axis=1)
    with np.errstate(invalid="ignore", divide="ignore"):
        gamma = np.arccos(np.clip(T[:, 2] / np.maximum(T_nrm, 1e-12), -1, 1))
    return PDGSolution(
        t=np.linspace(0.0, tf, N), r=vals["r"], v=vals["v"], z=z, u=u,
        xi=vals["xi"], cost=float(sol.obj) if ok else math.inf,
        T=T, T_nrm=T_nrm, m=m, gamma=gamma, status=int(sol.status))


def solve_lcvx(rocket: Rocket = Rocket(), N: int = 80, tol: float = 1e-3,
               dtype=None, device=None) -> PDGSolution:
    """Golden-section search of the fuel cost over the flight time
    (reference tests.jl:28-35): every probe re-solves the same program with
    a new tf."""
    prg = build_program(rocket, N, dtype, device)
    t_opt, _ = golden(lambda tf: solve_pdg(prg, rocket, tf, N).cost,
                      *rocket.tf_bounds, tol=tol)
    return solve_pdg(prg, rocket, t_opt, N)


def simulate(rocket: Rocket, sol: PDGSolution, dt: float = 1e-2):
    """Continuous-time replay of the ZOH optimal thrust (reference
    `simulate`, definition.jl:169-260): T = m_k u_k held over each interval
    on the true mass dynamics, through u = T / m, xi = |T| / m (numpy)."""
    A_c, B_c, p_c = rocket.continuous_dynamics()
    T_opt = sol.T
    t_knots = sol.t

    def control(t, x):
        i = min(np.searchsorted(t_knots, t, side="right") - 1,
                T_opt.shape[0] - 1)
        T = T_opt[max(i, 0)]
        m = math.exp(x[6])
        return np.concatenate([T / m, [np.linalg.norm(T) / m]])

    def fdot(t, x):
        return A_c @ x + B_c @ control(t, x) + p_c

    tf = float(t_knots[-1])
    n_steps = int(round(tf / dt))
    ts = np.linspace(0.0, tf, n_steps + 1)
    X = np.zeros((n_steps + 1, 7))
    X[0] = np.concatenate([rocket.r0, rocket.v0, [math.log(rocket.m_wet)]])
    for k in range(n_steps):
        h = ts[k + 1] - ts[k]
        x = X[k]
        k1 = fdot(ts[k], x)
        k2 = fdot(ts[k] + h / 2, x + h / 2 * k1)
        k3 = fdot(ts[k] + h / 2, x + h / 2 * k2)
        k4 = fdot(ts[k + 1], x + h * k3)
        X[k + 1] = x + h / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
    return ts, X
