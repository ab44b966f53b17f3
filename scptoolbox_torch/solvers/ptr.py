"""PTR: penalized trust region SCP, serial and batched over scenarios.

Counterpart of `scptoolbox_tpu/solvers/ptr.py` (`PTRParameters` :54,
`_TrustRegion`, `PTR.__init__`, `_discretize`, `_assemble`, `_solve_sub`,
`_postprocess`, `_step_impl`, `_step_timed` :313, the serial `PTR.solve`
:341, `solve_batched` :480 and the module-level `solve` :639).
One SCP iteration: assemble the conic subproblem around the reference ->
batched IPM -> extract -> re-discretize around the solution for the
feasibility check. Per-node trust-region radii are decision variables
bounded below by the q-norm of the scaled deviation; the cost is
J_orig + wtr (trapz(eta_x) + trapz(eta_u) + eta_p) + wvc (virtual-control
penalties). Every step is taken on a batch of scenarios; each scenario
applies the serial stopping rule (ptr.jl:908-932), and a scenario that has
stopped is frozen and no longer computed. The serial solve is the batched
step at a batch of one, with the host-side history, progress table, user
callback and the final continuous-time replay.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

import numpy as np
import torch

from scptoolbox_torch.config import (SCPError, SCPStatus, default_dtype,
                                     resolve_device)
from scptoolbox_torch.ops import ipm
from scptoolbox_torch.ops.discretize import (DiscretizationType, discretize,
                                             propagate)
from scptoolbox_torch.parser.problem import (ConeKind, TrajectoryProblem,
                                             bind_consts)
from scptoolbox_torch.solvers.autoscale import solver_scaling
from scptoolbox_torch.solvers.solution import IterationRecord, SCPSolution
from scptoolbox_torch.solvers.structure import (ipm_kkt_kwargs, random_dltv,
                                                resolve_kkt)
from scptoolbox_torch.solvers.subproblem import Assembler
from scptoolbox_torch.solvers.template import (BlockPoster, SCPTemplate,
                                               _perturb_consts)
from scptoolbox_torch.utils.table import Column, Table


@dataclasses.dataclass(frozen=True)
class PTRParameters:
    """PTR algorithm parameters (reference ptr.jl:57-71)."""

    N: int = 30
    Nsub: int = 15
    iter_max: int = 30
    disc_method: DiscretizationType = DiscretizationType.FOH
    wvc: float = 1e2
    wtr: float = 1e-2
    eps_abs: float = 1e-5
    eps_rel: float = 1e-3
    feas_tol: float = 5e-3
    q_tr: float = math.inf
    q_exit: float = math.inf
    ipm_tol: float = 1e-8
    ipm_max_iter: int = 60
    ipm_tol_almost: float = 1e-5
    structured_kkt: object = None
    kkt_method: object = None
    timing_detail: bool = False   # per-phase timing in the serial history


_Q2KIND = {1.0: ConeKind.L1, 2.0: ConeKind.SOC, math.inf: ConeKind.LINF}


class _TrustRegion:
    """Per-node trust-region rows eta >= ||iS (z - z_ref)||_q."""

    def __init__(self, name: str, nz: int, count: int, q: float, tmpl):
        self.name, self.nz, self.count, self.q = name, nz, count, q
        if q == 4.0:
            tmpl.plan.soc(name + "_tr", count, nz + 2)
        else:
            self.poster = BlockPoster(name + "_tr", _Q2KIND[float(q)],
                                      1 + nz, count, tmpl.layout, tmpl.plan)

    def post(self, asm, tmpl, z_idx, eta_idx, iS, z_ref):
        """z_idx (count, nz), eta_idx (count,) static; iS (nz,);
        z_ref (B, count, nz)."""
        count, nz = self.count, self.nz
        dt, dev = z_ref.dtype, z_ref.device
        cols = np.concatenate([np.asarray(z_idx).reshape(count, nz),
                               np.asarray(eta_idx).reshape(count, 1)], 1)
        diS = torch.diag(iS)
        Bn = z_ref.shape[0]
        if self.q == 4.0:
            # eta >= ||delta||_2^2 : SOC [eta+1, 2 delta, eta-1]
            J = torch.zeros(nz + 2, nz + 1, dtype=dt, device=dev)
            J[0, nz] = 1.0
            J[1:nz + 1, :nz] = 2.0 * diS
            J[nz + 1, nz] = 1.0
            ones = torch.ones(Bn, count, 1, dtype=dt, device=dev)
            v0 = torch.cat([ones, -2.0 * z_ref * iS, -ones], dim=2)
            asm.res_soc(tmpl.plan.rows(self.name + "_tr"), cols,
                        J.expand(count, nz + 2, nz + 1), v0)
        else:
            J = torch.zeros(1 + nz, nz + 1, dtype=dt, device=dev)
            J[0, nz] = 1.0
            J[1:, :nz] = diS
            v0 = torch.cat([torch.zeros(Bn, count, 1, dtype=dt, device=dev),
                            -z_ref * iS], dim=2)
            self.poster.post(asm, tmpl.plan, tmpl.layout, cols,
                             J.expand(count, 1 + nz, nz + 1), v0)


def _pnorm(v, q):
    if q == math.inf:
        return torch.amax(torch.abs(v), dim=-1)
    return torch.sum(torch.abs(v) ** q, dim=-1) ** (1.0 / q)


class PTR:
    """PTR solver bound to one TrajectoryProblem, on one device and dtype
    (the card and float32 unless told otherwise)."""

    def __init__(self, pbm: TrajectoryProblem, pars: PTRParameters,
                 dtype=None, device=None):
        self.pbm = pbm
        self.pars = pars
        self.device = resolve_device(device)
        self.dtype = dtype or default_dtype(self.device)
        N = pars.N
        self.t_np = np.linspace(0.0, 1.0, N)
        tmpl = SCPTemplate(pbm, N, self.t_np, dtype=self.dtype,
                           device=self.device)
        lay = tmpl.layout
        lay.add("eta_x", N)
        lay.add("eta_u", N)
        if pbm.np > 0:
            lay.add("eta_p")
        self._tr_x = _TrustRegion("x", pbm.nx, N, pars.q_tr, tmpl)
        self._tr_u = _TrustRegion("u", pbm.nu, N, pars.q_tr, tmpl)
        if pbm.np > 0:
            self._tr_p = _TrustRegion("p", pbm.np, 1, pars.q_tr, tmpl)
        self.spec = tmpl.freeze()
        self.tmpl = tmpl
        self.consts = pbm.consts

        T = self._t
        xg, ug, pg = bind_consts(pbm.guess, pbm.consts)(N)
        self._guess = (T(xg), T(ug), T(pg))
        self.scaling = solver_scaling(pbm, self.t_np, self.dtype, self.device)
        self._S_full, self._c_full = tmpl.scaling_vectors(self.scaling)
        self._E = torch.eye(pbm.nx, dtype=self.dtype, device=self.device)
        self._t_grid = T(self.t_np)

        def _probe(seed):
            rng = np.random.default_rng(seed)
            dltv = random_dltv(rng, N, pbm.nx, pbm.nu, pbm.np, self.dtype,
                               self.device)
            consts = (_perturb_consts(pbm.consts, rng) if seed >= 2
                      else pbm.consts)
            r = lambda *sh: T(rng.standard_normal(sh))[None]
            rx, ru, rp = r(N, pbm.nx), r(N, pbm.nu), r(pbm.np)
            A = self._assemble(rx, ru, rp, dltv, consts)[0]
            return A[0].cpu().numpy()

        self._kkt_method, self._kkt_builder = resolve_kkt(
            tmpl, _probe, pars.kkt_method, pars.structured_kkt)

    def _t(self, a):
        return torch.as_tensor(np.asarray(a), dtype=self.dtype,
                               device=self.device)

    @property
    def kkt_builder(self):
        """The probed staged KKT builder (None on the dense methods)."""
        return self._kkt_builder

    def _discretize(self, x, u, p, consts=None):
        return discretize(
            self.pbm.f, x, u, p, self._t_grid, self._E, nsub=self.pars.Nsub,
            method=self.pars.disc_method, jac=self.pbm.jac,
            impulse=self.pbm.impulse, actions=self.pbm.integration_actions,
            consts=self.consts if consts is None else consts)

    def _assemble(self, ref_x, ref_u, ref_p, dltv, consts):
        """Batched subproblems (A (B, m, n), b, c, const) around the
        references ref_x (B, N, nx), ref_u (B, N, nu), ref_p (B, np)."""
        tmpl, pars = self.tmpl, self.pars
        lay = tmpl.layout
        N = pars.N
        dt, dev = self.dtype, self.device
        asm = Assembler(tmpl.m, tmpl.n, ref_x.shape[0], dt, dev)
        tmpl.assemble_core(asm, ref_x, ref_u, ref_p, dltv, consts)
        sc = self.scaling
        self._tr_x.post(asm, tmpl, lay.idx("x"), lay.idx("eta_x"),
                        1.0 / sc.Sx, ref_x)
        self._tr_u.post(asm, tmpl, lay.idx("u"), lay.idx("eta_u"),
                        1.0 / sc.Su, ref_u)
        if self.pbm.np > 0:
            self._tr_p.post(asm, tmpl, lay.idx("p")[None, :],
                            lay.idx("eta_p").reshape(1), 1.0 / sc.Sp,
                            ref_p[:, None, :])
        w = torch.as_tensor(tmpl.w_trapz, dtype=dt, device=dev)
        asm.add_c(lay.idx("eta_x"), pars.wtr * w)
        asm.add_c(lay.idx("eta_u"), pars.wtr * w)
        if self.pbm.np > 0:
            asm.add_c(lay.idx("eta_p").reshape(1),
                      torch.full((1,), pars.wtr, dtype=dt, device=dev))
        asm.add_c(lay.idx("wvd"), (pars.wvc * w[:-1])[:, None].expand(
            N - 1, self.pbm.nx))
        if tmpl.struct.ns:
            asm.add_c(lay.idx("vs"), (pars.wvc * w)[:, None].expand(
                N, tmpl.struct.ns))
        for nm in ("vic", "vtc"):
            if lay.has(nm + "_pos"):
                for sfx in ("_pos", "_neg"):
                    idx = lay.idx(nm + sfx)
                    asm.add_c(idx, torch.full(idx.shape, pars.wvc, dtype=dt,
                                              device=dev))
        return asm.finish(self._S_full, self._c_full)

    def _solve_sub(self, A, b, c):
        return ipm.solve_batched(
            A, b, c, self.spec, tol=self.pars.ipm_tol,
            tol_almost=self.pars.ipm_tol_almost,
            max_iter=self.pars.ipm_max_iter,
            **ipm_kkt_kwargs(self._kkt_method, self._kkt_builder))

    def _postprocess(self, sol, const, ref_x, ref_u, ref_p, J_aug_ref,
                     consts):
        """Extract the solutions, re-discretize around them and compute the
        stopping metrics, per scenario."""
        pars, tmpl = self.pars, self.tmpl
        sc = self.scaling
        d = self._S_full * sol.x + self._c_full
        x, u, p = tmpl.extract(d)
        if self.pbm.integration_actions is not None:
            act = bind_consts(self.pbm.integration_actions, consts)
            x = torch.func.vmap(act)(x.reshape(-1, x.shape[-1])).reshape(
                x.shape)
        J_aug = sol.obj + const
        J_orig = tmpl.original_cost(x, u, p, consts)
        dltv_new = self._discretize(x, u, p, consts)
        defect_norm = torch.amax(torch.abs(dltv_new.defects / sc.Sx),
                                 dim=(1, 2))
        feas = defect_norm <= pars.feas_tol
        q = pars.q_exit
        dx = torch.amax(_pnorm((x - ref_x) / sc.Sx, q), dim=1)
        dp = (_pnorm((p - ref_p) / sc.Sp, q) if self.pbm.np > 0
              else torch.zeros_like(dx))
        lay = tmpl.layout
        return dict(
            x=x, u=u, p=p, dltv=dltv_new, J_aug=J_aug, J_orig=J_orig,
            feas=feas, deviation=dx + dp,
            improv_rel=(J_aug_ref - J_aug) / torch.abs(J_aug_ref),
            defect_norm=defect_norm,
            vd_norm=torch.amax(torch.abs(d[:, lay.sl("wvd")]), dim=1),
            vs_norm=(torch.amax(torch.abs(d[:, lay.sl("vs")]), dim=1)
                     if tmpl.struct.ns else torch.zeros_like(dx)),
            eta_max=torch.amax(d[:, lay.sl("eta_x")], dim=1),
            ipm_status=sol.status, ipm_iters=sol.iters, pres=sol.pres,
            dres=sol.dres)

    def _step_impl(self, ref_x, ref_u, ref_p, dltv, J_aug_ref, consts=None):
        """One PTR iteration for a batch of scenarios."""
        if consts is None:
            consts = self.consts
        A, b, c, const = self._assemble(ref_x, ref_u, ref_p, dltv, consts)
        sol = self._solve_sub(A, b, c)
        return self._postprocess(sol, const, ref_x, ref_u, ref_p, J_aug_ref,
                                 consts)

    def _step_timed(self, ref_x, ref_u, ref_p, dltv, J_aug_ref, consts):
        """The step split into assemble / IPM / post-process, each ended by a
        device synchronization: (out, {formulate, solve, discretize, total,
        overhead}) as the reference times its iterations."""
        sync = ((lambda: torch.cuda.synchronize(self.device))
                if self.device.type == "cuda" else (lambda: None))
        t0 = time.perf_counter()
        A, b, c, const = self._assemble(ref_x, ref_u, ref_p, dltv, consts)
        sync()
        t1 = time.perf_counter()
        sol = self._solve_sub(A, b, c)
        sync()
        t2 = time.perf_counter()
        out = self._postprocess(sol, const, ref_x, ref_u, ref_p, J_aug_ref,
                                consts)
        sync()
        t3 = time.perf_counter()
        return out, {"formulate": t1 - t0, "solve": t2 - t1,
                     "discretize": t3 - t2, "total": t3 - t0,
                     "overhead": 0.0}

    def solve(self, warm: Optional[SCPSolution] = None,
              verbose: bool = False) -> SCPSolution:
        """The serial PTR loop (reference ptr.jl:448-532) from the problem's
        guess or a previous solution, one scenario: a history record per
        iteration, the problem's callback (True vetoes stopping; it may
        raise `self.extra_iters` to extend the budget and move
        `self.consts`, which every iteration reads), a progress table
        when verbose, an emergency exit that keeps the last finite iterate,
        and the continuous-time replay of the result at 2 Nsub substeps."""
        pars = self.pars
        user_cols = list(self.pbm.table_columns or ())
        table = Table([
            Column("iter", "iter", "{:4d}"),
            Column("J_orig", "J", "{:12.4e}"),
            Column("J_aug", "J_aug", "{:12.4e}"),
            Column("dJ_rel", "dJ %", "{:9.2e}"),
            Column("defect", "defect", "{:9.2e}"),
            Column("vd", "vd", "{:8.1e}"),
            Column("vs", "vs", "{:8.1e}"),
            Column("dev", "deviation", "{:9.2e}"),
            Column("eta", "eta", "{:8.1e}"),
            Column("ipm", "ipm", "{:4d}"),
        ] + [Column(key, heading, fmt)
             for key, heading, fmt, _ in user_cols]) if verbose else None

        if warm is not None:
            ref = tuple(self._t(a)[None] for a in (warm.xd, warm.ud, warm.p))
        else:
            ref = tuple(a[None] for a in self._guess)
        dltv = self._discretize(*ref)
        J_aug_ref = torch.full((1,), math.inf, dtype=self.dtype,
                               device=self.device)
        history = []
        status = SCPStatus.FAILED
        out = last_good = None
        diverged = False
        n_iter = 0
        self.extra_iters = 0
        it = -1
        np_ = lambda a: a[0].cpu().numpy()
        while it + 1 < pars.iter_max + self.extra_iters:
            it += 1
            t0 = time.perf_counter()
            # self.consts is read at every iteration: the callback may move
            # it (a homotopy ladder driven by the solver, rendezvous_3d)
            if pars.timing_detail:
                out, timing = self._step_timed(*ref, dltv, J_aug_ref,
                                               self.consts)
            else:
                out = self._step_impl(*ref, dltv, J_aug_ref, self.consts)
                timing = None
            J_aug = float(out["J_aug"][0])
            feas = bool(out["feas"][0])
            deviation = float(out["deviation"][0])
            improv_rel = float(out["improv_rel"][0])
            n_iter = it + 1
            if not math.isfinite(J_aug):
                # a numerically dead subproblem is not accepted as the next
                # reference (reference ptr.jl:486-491)
                out = last_good
                diverged = True
                break
            last_good = out
            rec = IterationRecord(
                iteration=n_iter, x=np_(out["x"]), u=np_(out["u"]),
                p=np_(out["p"]), J_aug=J_aug,
                J_orig=float(out["J_orig"][0]), feas=feas,
                deviation=deviation, improv_rel=improv_rel,
                ipm_status=int(out["ipm_status"][0]),
                ipm_iters=int(out["ipm_iters"][0]),
                defect_norm=float(out["defect_norm"][0]),
                vd_norm=float(out["vd_norm"][0]),
                vs_norm=float(out["vs_norm"][0]),
                timing=(dict(timing, overhead=(time.perf_counter() - t0
                                               - timing["total"]))
                        if timing else
                        {"total": time.perf_counter() - t0}))
            history.append(rec)
            stop = (it > 0 and feas
                    and (abs(improv_rel) <= pars.eps_rel
                         or deviation <= pars.eps_abs))
            if self.pbm.callback is not None and self.pbm.callback(rec):
                stop = False
            # after the callback, so that user columns see what it set
            if table:
                table.print_row(dict(
                    iter=n_iter, J_orig=rec.J_orig, J_aug=J_aug,
                    dJ_rel=improv_rel, defect=rec.defect_norm,
                    vd=rec.vd_norm, vs=rec.vs_norm, dev=deviation,
                    eta=float(out["eta_max"][0]), ipm=rec.ipm_iters,
                    **{key: fn(rec) for key, _, _, fn in user_cols}))
            if stop:
                status = SCPStatus.SOLVED
                break
            ref = (out["x"], out["u"], out["p"])
            dltv = out["dltv"]
            J_aug_ref = out["J_aug"]

        if out is None:
            raise SCPError(SCPStatus.FAILED,
                           "PTR: first subproblem numerically dead")
        # exhausting iter_max with a clean final subproblem is SOLVED; the
        # emergency exit is FAILED (reference scp.jl:196-245, :965-980)
        if (status != SCPStatus.SOLVED and not diverged
                and int(out["ipm_status"][0]) in (
                    int(ipm.IPMStatus.OPTIMAL),
                    int(ipm.IPMStatus.ALMOST_OPTIMAL))):
            status = SCPStatus.SOLVED
        ts, xs = propagate(
            self.pbm.f, out["x"][0, 0], out["u"][0], out["p"][0],
            self._t_grid, nsub=2 * pars.Nsub, method=pars.disc_method,
            impulse=self.pbm.impulse, actions=self.pbm.integration_actions,
            consts=self.consts)
        return SCPSolution(
            status=status, algorithm="ptr", iterations=n_iter,
            xd=np_(out["x"]), ud=np_(out["u"]), p=np_(out["p"]),
            cost=float(out["J_orig"][0]), t_grid=self.t_np.copy(),
            feas=bool(out["feas"][0]), history=history,
            t_cont=ts.cpu().numpy(), x_cont=xs.cpu().numpy())

    def solve_batched(self, bx, bu, bp, n_iters: int):
        """Batched PTR from references bx (B, N, nx), bu (B, N, nu),
        bp (B, np), with at most n_iters iterations. Each scenario applies
        the serial stopping rule; a stopped (or numerically dead) scenario
        freezes and is not computed again, and the loop ends when every
        scenario has stopped. Returns per scenario the final x/u/p, J_aug,
        J_orig (the original cost of the returned trajectory), feas,
        defect_norm, status (SCPStatus codes), iters, ipm_status, plus
        per-iteration traces (deviation, improv_rel, J_aug, feas, active,
        ipm_iters; NaN, False or 0 for a frozen scenario)."""
        state = self._batched_start(bx, bu, bp)
        for it in range(n_iters):
            if not self._batched_iteration(state, it):
                break
        return self._batched_result(state)

    def _batched_start(self, bx, bu, bp):
        """The batched loop's state before its first iteration: copies of
        the references, their discretization, and every scenario active."""
        B = bx.shape[0]
        dev = self.device
        x, u, p = bx.clone(), bu.clone(), bp.clone()
        i32 = lambda v: torch.full((B,), int(v), dtype=torch.int32,
                                   device=dev)
        return dict(
            x=x, u=u, p=p, dltv=self._discretize(x, u, p, self.consts),
            J=torch.full((B,), math.inf, dtype=self.dtype, device=dev),
            done=torch.zeros(B, dtype=torch.bool, device=dev),
            status=i32(SCPStatus.FAILED), iters=i32(0),
            ipmst=i32(ipm.IPMStatus.MAX_ITER), traces=[])

    def _batched_iteration(self, state, it: int) -> bool:
        """Iteration `it` of the batched loop on `state` (from
        _batched_start): steps the active scenarios, applies the serial
        stopping rule, freezes the scenarios that stopped and appends the
        iteration's trace. Does nothing, and returns False, when every
        scenario of `state` has stopped."""
        pars = self.pars
        done = state["done"]
        if bool(done.all()):
            return False
        x, u, p, dltv, J = (state[k] for k in ("x", "u", "p", "dltv", "J"))
        idx = (~done).nonzero()[:, 0]
        out = self._step_impl(x[idx], u[idx], p[idx], dltv.index(idx),
                              J[idx], self.consts)
        finite = torch.isfinite(out["J_aug"])
        stop = (out["feas"] & ((torch.abs(out["improv_rel"])
                                <= pars.eps_rel)
                               | (out["deviation"] <= pars.eps_abs))
                if it > 0 else torch.zeros_like(finite))
        newly = stop | ~finite
        adv = idx[finite]
        x[adv] = out["x"][finite]
        u[adv] = out["u"][finite]
        p[adv] = out["p"][finite]
        state["dltv"] = type(dltv)(*(
            a.index_copy(0, adv, b_[finite])
            for a, b_ in zip(dltv, out["dltv"])))
        J[adv] = out["J_aug"][finite]
        state["ipmst"][adv] = out["ipm_status"][finite]
        state["status"][idx[newly]] = torch.where(
            stop & finite, int(SCPStatus.SOLVED),
            int(SCPStatus.FAILED)).to(torch.int32)[newly]
        state["iters"][idx] = it + 1
        done[idx[newly]] = True
        tr = self.frozen_trace(done.shape[0])
        for k in ("deviation", "improv_rel", "J_aug", "feas", "ipm_iters"):
            tr[k][idx] = out[k]
        tr["active"][idx] = True
        state["traces"].append(tr)
        return True

    def frozen_trace(self, B: int):
        """A batched trace entry in which all B scenarios are frozen: NaN,
        False or 0."""
        dev = self.device
        nan = lambda: torch.full((B,), math.nan, dtype=self.dtype,
                                 device=dev)
        no = lambda: torch.zeros(B, dtype=torch.bool, device=dev)
        return dict(deviation=nan(), improv_rel=nan(), J_aug=nan(),
                    feas=no(), active=no(),
                    ipm_iters=torch.zeros(B, dtype=torch.int32, device=dev))

    def _batched_result(self, state):
        """solve_batched's outputs from the loop's final state: a scenario
        still active at the end is SOLVED when its last subproblem was
        (almost) optimal, as the serial loop's exhausted budget is."""
        x, u, p, ipmst, status = (state[k] for k in ("x", "u", "p", "ipmst",
                                                     "status"))
        ipm_ok = ((ipmst == int(ipm.IPMStatus.OPTIMAL))
                  | (ipmst == int(ipm.IPMStatus.ALMOST_OPTIMAL)))
        status = torch.where(~state["done"] & ipm_ok,
                             torch.full_like(status, int(SCPStatus.SOLVED)),
                             status)
        defect = torch.amax(torch.abs(state["dltv"].defects
                                      / self.scaling.Sx), dim=(1, 2))
        return dict(x=x, u=u, p=p, J_aug=state["J"],
                    J_orig=self.tmpl.original_cost(x, u, p, self.consts),
                    feas=defect <= self.pars.feas_tol, defect_norm=defect,
                    status=status, iters=state["iters"], ipm_status=ipmst,
                    traces=state["traces"])


def solve(pbm: TrajectoryProblem, pars: PTRParameters,
          warm: Optional[SCPSolution] = None, verbose: bool = False,
          dtype=None, device=None) -> SCPSolution:
    """One-shot serial PTR solve (reference `PTR.solve`, ptr.jl:448), on the
    card unless `device` says otherwise."""
    return PTR(pbm, pars, dtype=dtype, device=device).solve(
        warm=warm, verbose=verbose)
