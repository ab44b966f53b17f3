"""Projection of an initial guess onto the convex constraints.

Counterpart of `scptoolbox_tpu/solvers/projection.py:23` (`project_convex`;
reference `correct_convex!`, src/solvers/scp.jl:275-361): minimize the L1
distance, in scaled variables, from the guess to a point that meets every
convex state and input set. SCvx runs it before its first iteration
(scvx.jl:560-568). The program is a `ConicProgram`, one problem on the dense
Schur KKT (on the card, its Cholesky ladder).
"""

from __future__ import annotations

import torch

from scptoolbox_torch.config import SCPError, SCPStatus
from scptoolbox_torch.ops.ipm import IPMStatus
from scptoolbox_torch.parser.problem import TrajectoryProblem, bind_consts, l1
from scptoolbox_torch.parser.program import ConicProgram


def project_convex(pbm: TrajectoryProblem, scaling, x_ref, u_ref, p_ref,
                   t_grid, dtype=None, device=None):
    """(x, u, p): (x_ref (N, nx), u_ref (N, nu), p_ref (np,)) projected onto
    the convex X/U sets, as tensors of the program's dtype on its device
    (the card unless told otherwise). Raises
    SCPError(GUESS_PROJECTION_FAILED) unless the IPM ends OPTIMAL or
    ALMOST_OPTIMAL (reference scp.jl:352-358)."""
    if pbm.X is None and pbm.U is None:
        return x_ref, u_ref, p_ref
    N = x_ref.shape[0]
    nx, nu, npp = pbm.nx, pbm.nu, pbm.np
    X_fn = bind_consts(pbm.X, pbm.consts)
    U_fn = bind_consts(pbm.U, pbm.consts)

    prg = ConicProgram(dtype=dtype, device=device)
    T = lambda a: torch.as_tensor(a, dtype=prg.dtype, device=prg.device)
    x_ref, u_ref, p_ref = T(x_ref), T(u_ref), T(p_ref)
    iSx, iSu = 1.0 / T(scaling.Sx), 1.0 / T(scaling.Su)
    x = prg.variable("x", N, nx)
    u = prg.variable("u", N, nu)
    p = prg.variable("p", npp) if npp > 0 else None
    ex = prg.variable("ex", N)
    eu = prg.variable("eu", N)
    ep = prg.variable("ep") if npp > 0 else None

    for k in range(N):
        tk = T(float(t_grid[k]))
        kk = torch.as_tensor(k, device=prg.device)
        for name, fn, z in (("X", X_fn, x), ("U", U_fn, u)):
            if fn is None:
                continue
            if npp > 0:
                prg.add_constraint(
                    f"{name}{k}",
                    lambda zv, pv, fn=fn, k=k, tk=tk, kk=kk: fn(
                        tk, kk, zv[k], pv),
                    (z, p))
            else:
                prg.add_constraint(
                    f"{name}{k}",
                    lambda zv, fn=fn, k=k, tk=tk, kk=kk: fn(
                        tk, kk, zv[k], p_ref),
                    (z,))
        prg.add_constraint(
            f"ex{k}", lambda xv, exv, k=k: [l1(torch.cat(
                [exv[k:k + 1], iSx * (xv[k] - x_ref[k])]))], (x, ex))
        prg.add_constraint(
            f"eu{k}", lambda uv, euv, k=k: [l1(torch.cat(
                [euv[k:k + 1], iSu * (uv[k] - u_ref[k])]))], (u, eu))
    if npp > 0:
        iSp = 1.0 / T(scaling.Sp)
        prg.add_constraint(
            "ep", lambda pv, epv: [l1(torch.cat(
                [epv.reshape(1), iSp * (pv - p_ref)]))], (p, ep))
        prg.add_cost(lambda exv, euv, epv:
                     torch.sum(exv) + torch.sum(euv) + epv, (ex, eu, ep))
    else:
        prg.add_cost(lambda exv, euv: torch.sum(exv) + torch.sum(euv),
                     (ex, eu))

    prg.scale(x, T(scaling.Sx).expand(N, nx), T(scaling.cx).expand(N, nx))
    prg.scale(u, T(scaling.Su).expand(N, nu), T(scaling.cu).expand(N, nu))
    if npp > 0:
        prg.scale(p, T(scaling.Sp), T(scaling.cp))
    prg.build()
    sol = prg.solve()
    if int(sol.status) not in (int(IPMStatus.OPTIMAL),
                               int(IPMStatus.ALMOST_OPTIMAL)):
        raise SCPError(SCPStatus.GUESS_PROJECTION_FAILED,
                       f"projection IPM status {int(sol.status)}")
    return (sol.values["x"], sol.values["u"],
            sol.values["p"] if npp > 0 else p_ref)
