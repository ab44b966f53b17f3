"""Post-solve KKT variational sensitivity of a solved ConicProgram.

Counterpart of `scptoolbox_tpu/parser/variation.py:43-299`: a new conic
program in the perturbation variables (dx, dz) whose constraints are the
linearized KKT conditions of the original problem at its primal-dual
solution,

    primal feasibility   s* + ds in K,   ds = db - dA x* - A dx
    dual feasibility     z* + dz in K*
    compl. slackness     d(s o z) = 0 per cone block (nonneg rows
                         elementwise, SOC blocks the Jordan product)
    stationarity         A' dz + d(A' z* + c) = 0,

solved for one parameter perturbation d(theta). The data (A, b, c) of the
lowered program is a function of the parameters, so every sensitivity is
one `torch.func.jvp` through `ConicProgram._assemble` (the exact linear
tangent; the assembly's in-place accumulation carries forward-mode
tangents), and the variational program is itself a ConicProgram whose
parameters are the d(theta), on the device and in the dtype of the
original.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
from torch.func import jvp

from scptoolbox_torch.parser.perturbation import PerturbationKind
from scptoolbox_torch.parser.problem import l1, nonpos, soc, zero
from scptoolbox_torch.parser.program import ConicProgram, ProgramSolution


class VariationResult(NamedTuple):
    """Directional sensitivities for one parameter perturbation."""

    dvalues: Dict[str, torch.Tensor]  # variable name -> d(solution block)
    dx: torch.Tensor                  # stacked physical d(decision)
    dz: torch.Tensor                  # dual perturbation (lowered rows)
    status: torch.Tensor


def _jordan(u, v):
    """The SOC Jordan product u o v = [<u, v>, u0 v1 + v0 u1]."""
    return torch.cat([torch.dot(u, v)[None], u[0] * v[1:] + v[0] * u[1:]])


class Variation:
    """The variational (KKT perturbation) program of a solved ConicProgram.

        sol = prg.solve(**pvals)
        var = Variation(prg, sol, pvals)
        dres = var.solve({"tf": 1.0})   # d(solution) in the direction tf

    mode="derivative" (default) keeps the smooth KKT tangent system
    (equalities only): exact directional derivatives under strict
    complementarity. mode="finite" adds cone feasibility of the perturbed
    primal and dual points (valid for finite perturbations, conservative on
    curved boundaries). relax=True softens complementary slackness by
    slacks mu under an L1 penalty; reg weights the least-norm selection.
    perturbations: {variable name: parser.perturbation.Perturbation}, the
    per-element bounds on the physical delta (FIXED pins it to 0, ABSOLUTE
    bounds |delta| by the amount, RELATIVE by amount * |nominal|)."""

    def __init__(self, prg: ConicProgram, sol: ProgramSolution,
                 pvals: Optional[Dict] = None, *, relax: bool = False,
                 reg: float = 1e-8, mode: str = "derivative",
                 perturbations: Optional[Dict] = None):
        assert prg._built, "solve the program before building its variation"
        assert mode in ("derivative", "finite")
        self.prg = prg
        self.relax = relax
        self.mode = mode
        dtype, dev = prg.dtype, prg.device
        T = lambda v: torch.as_tensor(v, dtype=dtype, device=dev)
        pv = {name: T(pvals.get(name, default)) if pvals else default
              for name, (_, default) in prg._pars.items()}
        self._pv = pv

        # lowered data at the solution point (scaled decision space)
        A, b, c, _ = prg._assemble(pv)
        spec = prg.spec
        n, m = A.shape[1], A.shape[0]
        xhat = (sol.x - prg._c_full) / prg._S_full
        s_star = b - A @ xhat
        z_star = sol.z
        self._A, self._xhat, self._zstar = A, xhat, z_star
        nz, nl = spec.nz, spec.nl
        soc_dims = spec.socs

        kkt = ConicProgram(dtype=dtype, device=dev)
        dx = kkt.variable("dx", n)
        dz = kkt.variable("dz", m)
        # complementary-slackness rows: elementwise on nonneg rows, the
        # full Jordan product on SOC blocks
        n_cs = nl + sum(soc_dims)
        mu = kkt.variable("mu", n_cs) if relax and n_cs else None
        dth = {name: kkt.parameter(f"d_{name}", torch.zeros_like(val))
               for name, val in pv.items()}
        dth_list = tuple(dth.values())
        order = tuple(dth.keys())

        def tangent(fn, dvals):
            """The tangent of fn(parameters) in the direction dvals."""
            return jvp(fn, (pv,), (dict(zip(order, dvals)),))[1]

        def dsdb(*dvals):
            """d(b - A x*) under the perturbation (x* held fixed)."""
            def r_of(p):
                Ap, bp, _, _ = prg._assemble(p)
                return bp - Ap @ xhat
            return tangent(r_of, dvals)

        def dstat(*dvals):
            """d(A' z* + c) under the perturbation."""
            def g_of(p):
                Ap, _, cp, _ = prg._assemble(p)
                return Ap.T @ z_star + cp
            return tangent(g_of, dvals)

        none = lambda: [zero(torch.zeros(1, dtype=dtype, device=dev))]

        def cone_rows(v, cons):
            if nl > 0:
                cons.append(nonpos(-v[nz:nz + nl]))
            off = nz + nl
            for d in soc_dims:
                cons.append(soc(v[off:off + d]))
                off += d
            return cons or none()

        # primal feasibility: in derivative mode only the equality rows
        # constrain the tangent (the cone rows go through complementary
        # slackness; s* + ds in K would cut a curved boundary's tangent)
        def primal_feas(dxv, *dvals):
            v = s_star + dsdb(*dvals) - A @ dxv
            cons = [zero(v[:nz])] if nz > 0 else []
            return cone_rows(v, cons) if mode == "finite" else (
                cons or none())

        if nz > 0 or mode == "finite":
            kkt.add_constraint("primal_feas", primal_feas, (dx, *dth_list))

        # dual feasibility: z* + dz in K* (free x nonneg x SOC)
        if mode == "finite" and (nl > 0 or soc_dims):
            kkt.add_constraint("dual_feas",
                               lambda dzv: cone_rows(z_star + dzv, []),
                               (dz,))

        if n_cs:
            def compl_slack(dxv, dzv, *rest):
                if relax:
                    muv, dvals = rest[0], rest[1:]
                else:
                    muv, dvals = torch.zeros(n_cs, dtype=dtype,
                                             device=dev), rest
                ds = dsdb(*dvals) - A @ dxv
                rows = []
                if nl > 0:
                    ln = slice(nz, nz + nl)
                    rows.append(s_star[ln] * dzv[ln] + ds[ln] * z_star[ln]
                                - muv[:nl])
                off, moff = nz + nl, nl
                for d in soc_dims:
                    blk = slice(off, off + d)
                    rows.append(_jordan(s_star[blk], dzv[blk])
                                + _jordan(ds[blk], z_star[blk])
                                - muv[moff:moff + d])
                    off += d
                    moff += d
                return [zero(torch.cat(rows))]

            args = ((dx, dz, mu, *dth_list) if relax
                    else (dx, dz, *dth_list))
            kkt.add_constraint("compl_slack", compl_slack, args)

        kkt.add_constraint(
            "stat", lambda dzv, *dvals: [zero(A.T @ dzv + dstat(*dvals))],
            (dz, *dth_list))

        # per-element perturbation bounds on the physical delta: the kkt dx
        # is scaled, so the bounds go through the block's diagonal scale
        if perturbations:
            S_all = prg._S_full
            for vname, pert in perturbations.items():
                sl_v = prg.layout.sl(vname)
                x_nom = sol.x[sl_v].cpu().numpy()
                kinds = pert.kind.reshape(-1)
                amounts = np.asarray(pert.amount, float).reshape(-1)
                assert kinds.size == sl_v.stop - sl_v.start, (
                    f"perturbation for {vname!r} has {kinds.size} elements, "
                    f"block has {sl_v.stop - sl_v.start}")
                fixed = np.asarray([k == PerturbationKind.FIXED
                                    for k in kinds])
                rel = np.asarray([k == PerturbationKind.RELATIVE
                                  for k in kinds])
                bounded = np.asarray(
                    [k in (PerturbationKind.ABSOLUTE,
                           PerturbationKind.RELATIVE) for k in kinds])
                bnd = amounts.copy()
                bnd[rel] = amounts[rel] * np.abs(x_nom[rel])
                fix_idx = np.flatnonzero(fixed) + sl_v.start
                bnd_idx = np.flatnonzero(bounded) + sl_v.start
                if fix_idx.size:
                    kkt.add_constraint(
                        f"pert_fix_{vname}",
                        lambda dxv, i=fix_idx: [zero(dxv[i])], (dx,))
                if bnd_idx.size:
                    def box(dxv, i=bnd_idx, amt=T(bnd[bounded])):
                        # |S_i dx_i| <= amount_i
                        d_phys = S_all[i] * dxv[i]
                        return [nonpos(torch.cat([d_phys - amt,
                                                  -d_phys - amt]))]

                    kkt.add_constraint(f"pert_bnd_{vname}", box, (dx,))

        # objective: the least-norm perturbation (the variational system may
        # be degenerate); with relax, an L1 penalty on mu
        if relax and n_cs:
            t_mu = kkt.variable("t_mu")
            kkt.add_constraint(
                "mu_l1", lambda muv, tv: [l1(torch.cat(
                    [tv.reshape(1), muv]))], (mu, t_mu))
            kkt.add_cost(lambda tv: 1e3 * torch.sum(tv), (t_mu,))
        kkt.add_cost(lambda dxv, dzv: 0.5 * reg * (torch.dot(dxv, dxv)
                                                   + torch.dot(dzv, dzv)),
                     (dx, dz))
        kkt.build()
        self.kkt = kkt
        self._n = n

    def solve(self, dtheta: Optional[Dict] = None, *, tol: float = 1e-8,
              max_iter: int = 60) -> VariationResult:
        """Solve the variational program for one perturbation direction:
        the physical sensitivities of every variable block."""
        params = {f"d_{k}": v for k, v in (dtheta or {}).items()}
        out = self.kkt.solve(tol=tol, max_iter=max_iter, **params)
        d_phys = self.prg._S_full * out.values["dx"]
        dvalues = {name: d_phys[self.prg.layout.sl(name)].reshape(v.shape)
                   for name, v in self.prg._vars.items()}
        return VariationResult(dvalues=dvalues, dx=d_phys,
                               dz=out.values["dz"], status=out.status)


def variation(prg: ConicProgram, sol: ProgramSolution,
              pvals: Optional[Dict] = None, **kw) -> Variation:
    """Variation(prg, sol, pvals, **kw): the KKT variational program."""
    return Variation(prg, sol, pvals, **kw)
