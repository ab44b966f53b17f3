"""Linearization + discretization by variational STM integration.

Counterpart of `scptoolbox_tpu/ops/discretize.py` (`DLTV` :52, `discretize`
:94 with its FOH and IMPULSE branches, `propagate` :247). For every interval
the variational equations of the state-transition matrix Phi and its inverse
Psi (propagated by its own ODE dPsi/dt = -Psi A) are integrated around the
reference with Nsub RK4 steps, giving

    x_{k+1} = A_k x_k + Bm_k u_k + Bp_k u_{k+1} + F_k p + r_k + E_k v_k.

FOH interpolates the input linearly over the interval. IMPULSE applies the
input as a state jump `impulse(t_k, x_k, u_k, p)` at the node and coasts
with u = 0 (Bp = 0).

Where JAX vmaps over intervals and scans over substeps, this flattens every
interval of every scenario into one batch and loops over the substeps in
Python; A(t), B(t), F(t) and the jump's Jacobians come from
`torch.func.jacfwd` under `torch.func.vmap`.
"""

from __future__ import annotations

import enum
from typing import Callable, NamedTuple, Optional

import torch
from torch.func import jacfwd, vmap

from scptoolbox_torch.parser.problem import bind_consts
from scptoolbox_torch.utils.integrate import rk4_step


class DiscretizationType(enum.Enum):
    FOH = "foh"
    IMPULSE = "impulse"


class DLTV(NamedTuple):
    """Discrete LTV update. Shapes (with a leading scenario batch B):
    A (B, N-1, nx, nx), Bm/Bp (B, N-1, nx, nu), F (B, N-1, nx, np),
    r (B, N-1, nx), E (B, N-1, nx, nv), defects (B, N-1, nx),
    xprop (B, N-1, nx)."""

    A: torch.Tensor
    Bm: torch.Tensor
    Bp: torch.Tensor
    F: torch.Tensor
    r: torch.Tensor
    E: torch.Tensor
    defects: torch.Tensor
    xprop: torch.Tensor

    def index(self, idx):
        return DLTV(*(t[idx] for t in self))


class _VarState(NamedTuple):
    x: torch.Tensor
    Phi: torch.Tensor
    Psi: torch.Tensor
    Bm: torch.Tensor
    Bp: torch.Tensor
    F: torch.Tensor
    intPsi: torch.Tensor


def _field_and_jacobians(f: Callable, jac: Optional[Callable]):
    """(t, x, u, p) -> (f, A, B, F), vmapped over a leading batch."""
    if jac is not None:
        return vmap(lambda t, x, u, p: (f(t, x, u, p),) + tuple(
            jac(t, x, u, p)))

    def one(t, x, u, p):
        g = lambda xx, uu, pp: (f(t, xx, uu, pp),) * 2
        (A, B, F), val = jacfwd(g, argnums=(0, 1, 2), has_aux=True)(x, u, p)
        return val, A, B, F

    return vmap(one)


def _jump_and_jacobians(impulse: Callable):
    """(t, x, u, p) -> (jump, Ju, Jp), vmapped over a leading batch."""

    def one(t, x, u, p):
        g = lambda uu, pp: (impulse(t, x, uu, pp),) * 2
        (Ju, Jp), val = jacfwd(g, argnums=(0, 1), has_aux=True)(u, p)
        return val, Ju, Jp

    return vmap(one)


def discretize(f: Callable, x_ref, u_ref, p_ref, t_grid, E, *,
               nsub: int = 15,
               method: DiscretizationType = DiscretizationType.FOH,
               jac: Optional[Callable] = None,
               impulse: Optional[Callable] = None,
               actions: Optional[Callable] = None,
               consts=None) -> DLTV:
    """Linearize/discretize dx/dt = f(t, x, u, p) about a batch of references
    x_ref (B, N, nx), u_ref (B, N, nu), p_ref (B, np) on the node times
    t_grid (N,); E (nx, nv) is the virtual-control injection.

    Under IMPULSE, f is the coasting field and `impulse` the state jump at
    each node. The STM is always the pure flow's, and the jump enters through
    its input and parameter Jacobians only: A_k = PhiF, Bm_k = PhiF Ju,
    F_k = PhiF (Jp + intPsiF). The jump's state Jacobian is left out on
    purpose, as in the reference (discretization.jl:385-391): with it the
    subproblem sees first-order exploits of the jump's state dependence (the
    3-D rendezvous thrust rotation R(q) u scales with ||q||^2, so inflating
    the quaternion off the unit sphere looks profitable), which diverge
    under re-linearization."""
    f = bind_consts(f, consts)
    jac = bind_consts(jac, consts)
    impulse = bind_consts(impulse, consts)
    actions = bind_consts(actions, consts)
    is_impulse = method == DiscretizationType.IMPULSE
    Bn, N, nx = x_ref.shape
    nu = u_ref.shape[2]
    npp = p_ref.shape[1]
    dt, dev = x_ref.dtype, x_ref.device
    M = Bn * (N - 1)
    x_k = x_ref[:, :-1].reshape(M, nx)
    u_k = u_ref[:, :-1].reshape(M, nu)
    u_kp1 = u_ref[:, 1:].reshape(M, nu)
    p_k = p_ref.repeat_interleave(N - 1, dim=0)
    t_k = t_grid[:-1].repeat(Bn)
    dt_k = (t_grid[1:] - t_grid[:-1]).repeat(Bn)
    fj = _field_and_jacobians(f, jac)
    act = vmap(actions) if actions is not None else None
    if is_impulse:
        jump, Ju, Jp = (v.to(dt) for v in _jump_and_jacobians(impulse)(
            t_k, x_k, u_k, p_k))
        x_start = x_k + jump
        u_coast = torch.zeros_like(u_k)

    def rhs(tau, s: _VarState):
        t = t_k + tau
        if is_impulse:
            # the input acts only through the jump
            u = u_coast
            sig_m = sig_p = torch.zeros_like(tau)
        else:
            sig_p = tau / dt_k
            sig_m = 1.0 - sig_p
            u = u_k + (u_kp1 - u_k) * sig_p[:, None]
        xdot, A_t, B_t, F_t = (v.to(dt) for v in fj(t, s.x, u, p_k))
        PsiB = s.Psi @ B_t
        return _VarState(
            x=xdot, Phi=A_t @ s.Phi, Psi=-s.Psi @ A_t,
            Bm=sig_m[:, None, None] * PsiB,
            Bp=sig_p[:, None, None] * PsiB,
            F=s.Psi @ F_t, intPsi=s.Psi)

    eye = torch.eye(nx, dtype=dt, device=dev).expand(M, nx, nx)
    s = _VarState(x=x_start if is_impulse else x_k, Phi=eye, Psi=eye,
                  Bm=x_k.new_zeros(M, nx, nu), Bp=x_k.new_zeros(M, nx, nu),
                  F=x_k.new_zeros(M, nx, npp), intPsi=x_k.new_zeros(M, nx, nx))
    dsub = dt_k / nsub
    for i in range(nsub):
        s = rk4_step(rhs, s, i * dsub, dsub)
        if act is not None:
            s = s._replace(x=act(s.x))

    PhiF = s.Phi
    A_k = PhiF
    if is_impulse:
        Bm_k = PhiF @ Ju
        Bp_k = x_k.new_zeros(M, nx, nu)
        F_k = PhiF @ (Jp + s.F)
    else:
        Bm_k = PhiF @ s.Bm
        Bp_k = PhiF @ s.Bp
        F_k = PhiF @ s.F
    E_k = PhiF @ s.intPsi @ E
    xprop = s.x
    mv = lambda Mx, v: (Mx @ v[:, :, None])[..., 0]
    r_k = xprop - mv(A_k, x_k) - mv(Bm_k, u_k) - mv(Bp_k, u_kp1) - mv(F_k, p_k)
    shape = lambda t: t.reshape((Bn, N - 1) + t.shape[1:])
    xprop = shape(xprop)
    return DLTV(A=shape(A_k), Bm=shape(Bm_k), Bp=shape(Bp_k), F=shape(F_k),
                r=shape(r_k), E=shape(E_k), defects=x_ref[:, 1:] - xprop,
                xprop=xprop)


def propagate(f: Callable, x0, u_ref, p_ref, t_grid, *, nsub: int = 30,
              method: DiscretizationType = DiscretizationType.FOH,
              impulse: Optional[Callable] = None,
              actions: Optional[Callable] = None, consts=None):
    """Continuous-time replay of a solution from x0 (nx,), under linearly
    interpolated inputs (FOH) or coasting after each node's jump (IMPULSE):
    returns (ts, xs) on the (N-1)*nsub+1 fine grid (single scenario)."""
    f = bind_consts(f, consts)
    impulse = bind_consts(impulse, consts)
    actions = bind_consts(actions, consts)
    is_impulse = method == DiscretizationType.IMPULSE
    N = t_grid.shape[0]
    xs = [x0]
    ts = [t_grid[:1]]
    x = x0
    for k in range(N - 1):
        t_k = t_grid[k]
        h = t_grid[k + 1] - t_k
        u_k, u_kp1 = u_ref[k], u_ref[k + 1]
        if is_impulse:
            x = x + impulse(t_k, x, u_k, p_ref)
            u0 = torch.zeros_like(u_k)
            rhs = lambda tau, xx: f(t_k + tau, xx, u0, p_ref)
        else:
            rhs = lambda tau, xx: f(t_k + tau, xx, u_k + (u_kp1 - u_k)
                                    * (tau / h), p_ref)
        dsub = h / nsub
        for i in range(nsub):
            x = rk4_step(rhs, x, i * dsub, dsub)
            if actions is not None:
                x = actions(x)
            xs.append(x)
        taus = torch.arange(1, nsub + 1, dtype=t_grid.dtype,
                            device=t_grid.device) / nsub
        ts.append(t_k + h * taus)
    return torch.cat(ts), torch.stack(xs)
