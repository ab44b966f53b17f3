"""SCvx: successive convexification with a hard trust region and a
reject/accept ratio test, serial and batched over scenarios.

Counterpart of `scptoolbox_tpu/solvers/scvx.py` (`SCvxParameters` :59,
`_pnorm` :96, the same as PTR's and taken from `solvers/ptr.py`,
`SCvx.__init__` :106, `_post_trust_region` :183, `_assemble`
:245, `_nonlinear_penalty` :272, `_step_impl` :299, `_post_solve` :314,
`_step_timed` :346, `_ref_J_aug_impl` :385, the serial `solve` :393,
`solve_batched` :529 / `_solve_batched_impl` :545 and the module-level
`solve` :630; reference src/solvers/scvx.jl). One iteration: assemble the
conic subproblem around the reference and its DLTV -> batched IPM ->
extract -> re-discretize and evaluate the nonlinear augmented cost.

  * hard trust region per node: ||dx_k||_q + ||du_k||_q + ||dp||_q <= eta
    (scaled deviations) through the epigraph columns dx_lq / du_lq / dp_lq
    (scvx.jl:578-678; q = 4 bounds the squared 2-norm, its GEOM row lowered
    to an SOC);
  * linear penalty lambda (trapz(P) + sum(Pf)) on the virtual controls,
    lowered to weighted slack sums (scvx.jl:804-901);
  * nonlinear augmented cost J_aug = J_orig + lambda (trapz(P_nl) + boundary
    violations), P_nl_k = ||defect_k||_1 + ||max(s_k, 0)||_1
    (scvx.jl:924-972);
  * rho = (J_aug(ref) - J_aug(sol)) / (J_aug(ref) - L(sol)): reject below
    rho_0; shrink / hold / grow eta in the rho_1 / rho_2 bands
    (scvx.jl:1000-1045);
  * stop when iter > 1, feasible and (pre_improv_rel <= eps_rel or
    deviation <= eps_abs) (scvx.jl:711-734);
  * the guess is first projected onto the convex constraints
    (solvers/projection.py).

Every step is taken on a batch of scenarios (the serial solve is a batch of
one). In `solve_batched` eta, J_ref and the reference trajectory with its
DLTV are per-scenario state; a stopped or non-finite scenario freezes and
leaves the IPM's batch.
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
from scptoolbox_torch.solvers.projection import project_convex
from scptoolbox_torch.solvers.ptr import _pnorm
from scptoolbox_torch.solvers.solution import IterationRecord, SCPSolution
from scptoolbox_torch.solvers.structure import (ipm_kkt_kwargs, random_dltv,
                                                resolve_kkt)
from scptoolbox_torch.solvers.subproblem import Assembler
from scptoolbox_torch.solvers.template import (BlockPoster, SCPTemplate,
                                               _perturb_consts)
from scptoolbox_torch.utils.table import Column, Table


@dataclasses.dataclass(frozen=True)
class SCvxParameters:
    """SCvx algorithm parameters (reference scvx.jl:60-81; defaults from the
    quadrotor test configuration, quadrotor/tests.jl:33-51)."""

    N: int = 30
    Nsub: int = 15
    iter_max: int = 15
    disc_method: DiscretizationType = DiscretizationType.FOH
    lam: float = 30.0           # virtual control weight lambda
    rho_0: float = 0.0          # reject below this ratio
    rho_1: float = 0.1          # shrink below this ratio
    rho_2: float = 0.7          # grow above this ratio
    beta_sh: float = 2.0        # shrink factor
    beta_gr: float = 2.0        # growth factor
    eta_init: float = 1.0
    eta_lb: float = 1e-3
    eta_ub: float = 10.0
    eps_abs: float = 1e-5
    eps_rel: float = 1e-4
    feas_tol: float = 1e-3
    q_tr: float = math.inf
    q_exit: float = math.inf
    ipm_tol: float = 1e-8
    ipm_max_iter: int = 60
    ipm_tol_almost: float = 1e-5
    project_guess: bool = True
    structured_kkt: object = None
    kkt_method: object = None
    timing_detail: bool = False   # per-phase timing in the serial history


_Q2KIND = {1.0: ConeKind.L1, 2.0: ConeKind.SOC, 4.0: ConeKind.SOC,
           math.inf: ConeKind.LINF}


class SCvx:
    """SCvx solver bound to one TrajectoryProblem, on one device and dtype
    (the card and float32 unless told otherwise)."""

    def __init__(self, pbm: TrajectoryProblem, pars: SCvxParameters,
                 dtype=None, device=None):
        self.pbm = pbm
        self.pars = pars
        self.device = resolve_device(device)
        self.dtype = dtype or default_dtype(self.device)
        N = pars.N
        nx, nu, npp = pbm.nx, pbm.nu, pbm.np
        self.t_np = np.linspace(0.0, 1.0, N)
        tmpl = SCPTemplate(pbm, N, self.t_np, dtype=self.dtype,
                           device=self.device, relax_dynamics=True,
                           relax_bcs=True)
        lay, plan = tmpl.layout, tmpl.plan

        # trust-region epigraph columns and their per-node norm cones
        kind = _Q2KIND[float(pars.q_tr)]
        lay.add("dx_lq", N)
        lay.add("du_lq", N)
        self._tr_x = BlockPoster("tr_x", kind, 1 + nx, N, lay, plan)
        self._tr_u = BlockPoster("tr_u", kind, 1 + nu, N, lay, plan)
        if npp > 0:
            lay.add("dp_lq")
            self._tr_p = BlockPoster("tr_p", kind, 1 + npp, 1, lay, plan)
        self._nsum = 2 + (1 if npp > 0 else 0)
        if pars.q_tr == 4.0:
            lay.add("w_tr", N)
            plan.soc("tr_w", N, 1 + self._nsum)
            # GEOM(w, eta, 1): eta >= w^2, lowered to an SOC at post time
            plan.soc("tr_geom", N, 3)
        else:
            plan.nonneg("tr_bound", N)
        self.spec = tmpl.freeze()
        self.tmpl = tmpl
        self.consts = pbm.consts

        T = self._t
        xg, ug, pg = bind_consts(pbm.guess, pbm.consts)(N)
        self._guess = (T(xg), T(ug), T(pg))
        self.scaling = solver_scaling(pbm, self.t_np, self.dtype, self.device)
        self._S_full, self._c_full = tmpl.scaling_vectors(self.scaling)
        self._E = torch.eye(nx, dtype=self.dtype, device=self.device)
        self._t_grid = T(self.t_np)

        def _probe(seed):
            rng = np.random.default_rng(seed)
            r = lambda *sh: T(rng.standard_normal(sh))[None]
            dltv = random_dltv(rng, N, nx, nu, npp, self.dtype, self.device)
            consts = (_perturb_consts(pbm.consts, rng) if seed >= 2
                      else pbm.consts)
            rx, ru, rp = r(N, nx), r(N, nu), r(npp)
            eta = T([1.0 + abs(rng.standard_normal())])
            A = self._assemble(rx, ru, rp, dltv, eta, consts)[0]
            return A[0].cpu().numpy()

        self._kkt_method, self._kkt_builder = resolve_kkt(
            tmpl, _probe, pars.kkt_method, pars.structured_kkt)

    def _t(self, a):
        # a copy: a warm start's arrays may be read-only views
        return torch.as_tensor(np.array(a), dtype=self.dtype,
                               device=self.device)

    @property
    def kkt_builder(self):
        """The probed staged or block KKT builder (None on the dense
        methods)."""
        return self._kkt_builder

    def _discretize(self, x, u, p, consts=None):
        return discretize(
            self.pbm.f, x, u, p, self._t_grid, self._E, nsub=self.pars.Nsub,
            method=self.pars.disc_method, jac=self.pbm.jac,
            impulse=self.pbm.impulse, actions=self.pbm.integration_actions,
            consts=self.consts if consts is None else consts)

    def _post_trust_region(self, asm, ref_x, ref_u, ref_p, eta):
        """The hard trust region (reference add_trust_region!,
        scvx.jl:578-678) around ref_x (B, N, nx), ref_u (B, N, nu),
        ref_p (B, np) with the radii eta (B,)."""
        tmpl, pars = self.tmpl, self.pars
        lay, plan = tmpl.layout, tmpl.plan
        N, nx, nu, npp = pars.N, self.pbm.nx, self.pbm.nu, self.pbm.np
        dt, dev = self.dtype, self.device
        Bn = ref_x.shape[0]
        sc = self.scaling

        def post_eps(poster, z_idx, lq_idx, iS, z_ref, count, nz):
            # cone(lq, iS (z - z_ref)): rows [lq | iS dz]
            cols = np.concatenate([np.asarray(z_idx).reshape(count, nz),
                                   np.asarray(lq_idx).reshape(count, 1)], 1)
            J = torch.zeros(1 + nz, nz + 1, dtype=dt, device=dev)
            J[0, nz] = 1.0
            J[1:, :nz] = torch.diag(iS)
            v0 = torch.cat([z_ref.new_zeros(Bn, count, 1), -z_ref * iS], 2)
            poster.post(asm, plan, lay, cols, J.expand(count, 1 + nz, nz + 1),
                        v0)

        post_eps(self._tr_x, lay.idx("x"), lay.idx("dx_lq"), 1.0 / sc.Sx,
                 ref_x, N, nx)
        post_eps(self._tr_u, lay.idx("u"), lay.idx("du_lq"), 1.0 / sc.Su,
                 ref_u, N, nu)
        if npp > 0:
            post_eps(self._tr_p, lay.idx("p")[None, :],
                     lay.idx("dp_lq").reshape(1, 1), 1.0 / sc.Sp,
                     ref_p[:, None, :], 1, npp)

        lq_cols = [lay.idx("dx_lq").reshape(N, 1),
                   lay.idx("du_lq").reshape(N, 1)]
        if npp > 0:
            lq_cols.append(np.broadcast_to(lay.idx("dp_lq").reshape(1, 1),
                                           (N, 1)))
        nsum = len(lq_cols)
        cols = np.concatenate(lq_cols, axis=1)
        if pars.q_tr == 4.0:
            # w >= ||(dx_lq, du_lq, dp_lq)||_2 ; eta >= w^2
            w_cols = lay.idx("w_tr").reshape(N, 1)
            J = torch.zeros(nsum + 1, nsum + 1, dtype=dt, device=dev)
            J[0, nsum] = 1.0
            J[1:, :nsum] = torch.eye(nsum, dtype=dt, device=dev)
            asm.res_soc(plan.rows("tr_w"), np.concatenate([cols, w_cols], 1),
                        J.expand(N, nsum + 1, nsum + 1),
                        torch.zeros(N, nsum + 1, dtype=dt, device=dev))
            # GEOM(w, eta, 1) as the SOC [eta + 1, 2 w, eta - 1]
            Jg = torch.zeros(N, 3, 1, dtype=dt, device=dev)
            Jg[:, 1, 0] = 2.0
            e = eta[:, None].expand(Bn, N)
            v0g = torch.stack([e + 1.0, torch.zeros_like(e), e - 1.0], 2)
            asm.res_soc(plan.rows("tr_geom"), w_cols, Jg, v0g)
        else:
            rows = plan.rows("tr_bound").reshape(N, 1)
            asm.add_A(rows, cols, torch.ones(N, 1, nsum, dtype=dt,
                                             device=dev))
            asm.add_b(rows, eta[:, None, None].expand(Bn, N, 1))

    def _assemble(self, ref_x, ref_u, ref_p, dltv, eta, consts):
        """Batched subproblems (A (B, m, n), b, c, const) around the
        references with the trust-region radii eta (B,)."""
        tmpl, pars = self.tmpl, self.pars
        lay = tmpl.layout
        N = pars.N
        dt, dev = self.dtype, self.device
        asm = Assembler(tmpl.m, tmpl.n, ref_x.shape[0], dt, dev)
        tmpl.assemble_core(asm, ref_x, ref_u, ref_p, dltv, consts)
        self._post_trust_region(asm, ref_x, ref_u, ref_p, eta)

        # lambda-weighted virtual-control penalty (scvx.jl:804-901 lowered)
        w = torch.as_tensor(tmpl.w_trapz, dtype=dt, device=dev)
        lam = pars.lam
        asm.add_c(lay.idx("wvd"), (lam * w[:-1])[:, None].expand(
            N - 1, self.pbm.nx))
        if tmpl.struct.ns:
            asm.add_c(lay.idx("vs"), (lam * w)[:, None].expand(
                N, tmpl.struct.ns))
        for nm in ("vic", "vtc"):
            if lay.has(nm + "_pos"):
                for sfx in ("_pos", "_neg"):
                    idx = lay.idx(nm + sfx)
                    asm.add_c(idx, torch.full(idx.shape, lam, dtype=dt,
                                              device=dev))
        return asm.finish(self._S_full, self._c_full)

    def _nonlinear_penalty(self, x, u, p, defects, consts=None):
        """actual_cost_penalty! (scvx.jl:924-972): the lambda-weighted true
        defects and constraint violations of x (B, N, nx), u (B, N, nu),
        p (B, np) with their defects (B, N - 1, nx) -> (B,)."""
        if consts is None:
            consts = self.consts
        pars, tmpl, pbm = self.pars, self.tmpl, self.pbm
        N, lam = pars.N, pars.lam
        Bn = x.shape[0]
        w = torch.as_tensor(tmpl.w_trapz, dtype=x.dtype, device=x.device)
        P = torch.cat([torch.sum(torch.abs(defects), dim=2),
                       x.new_zeros(Bn, 1)], dim=1)
        if tmpl.struct.ns:
            t_flat, k_flat = tmpl._nodes(Bn)
            sval = torch.func.vmap(bind_consts(pbm.s, consts))(
                t_flat, k_flat, x.reshape(Bn * N, -1), u.reshape(Bn * N, -1),
                p.repeat_interleave(N, dim=0))
            P = P + torch.sum(torch.clamp(sval, min=0.0), dim=1).reshape(
                Bn, N)
        pen = lam * (P @ w)
        if tmpl.struct.n_ic:
            pen = pen + lam * torch.sum(torch.abs(torch.func.vmap(
                bind_consts(pbm.gic, consts))(x[:, 0], p)), dim=1)
        if tmpl.struct.n_tc:
            pen = pen + lam * torch.sum(torch.abs(torch.func.vmap(
                bind_consts(pbm.gtc, consts))(x[:, -1], p)), dim=1)
        return pen

    def _solve_sub(self, A, b, c):
        return ipm.solve_batched(
            A, b, c, self.spec, tol=self.pars.ipm_tol,
            tol_almost=self.pars.ipm_tol_almost,
            max_iter=self.pars.ipm_max_iter,
            **ipm_kkt_kwargs(self._kkt_method, self._kkt_builder))

    def _step_impl(self, ref_x, ref_u, ref_p, dltv, eta, consts=None):
        """One SCvx iteration for a batch of scenarios, eta (B,)."""
        if consts is None:
            consts = self.consts
        A, b, c, const = self._assemble(ref_x, ref_u, ref_p, dltv, eta,
                                        consts)
        sol = self._solve_sub(A, b, c)
        return self._post_solve(sol, const, ref_x, ref_u, ref_p, consts)

    def _post_solve(self, sol, const, ref_x, ref_u, ref_p, consts):
        """Extract, re-discretize and evaluate the nonlinear augmented cost
        (the part of the step after the subproblem solve), per scenario."""
        pars, tmpl = self.pars, self.tmpl
        sc = self.scaling
        d = self._S_full * sol.x + self._c_full
        x, u, p = tmpl.extract(d)
        L_sol = tmpl.original_cost(x, u, p, consts)   # no penalty
        dltv_new = self._discretize(x, u, p, consts)
        defect_norm = torch.amax(torch.abs(dltv_new.defects / sc.Sx),
                                 dim=(1, 2))
        J_aug = L_sol + self._nonlinear_penalty(x, u, p, dltv_new.defects,
                                                consts)
        q = pars.q_exit
        dx = torch.amax(_pnorm((x - ref_x) / sc.Sx, q), dim=1)
        dp = (_pnorm((p - ref_p) / sc.Sp, q) if self.pbm.np > 0
              else torch.zeros_like(dx))
        lay = tmpl.layout
        return dict(
            x=x, u=u, p=p, dltv=dltv_new, L=L_sol, L_aug=sol.obj + const,
            J_aug=J_aug, feas=defect_norm <= pars.feas_tol,
            deviation=dx + dp, defect_norm=defect_norm,
            vd_norm=torch.amax(torch.abs(d[:, lay.sl("wvd")]), dim=1),
            vs_norm=(torch.amax(torch.abs(d[:, lay.sl("vs")]), dim=1)
                     if tmpl.struct.ns else torch.zeros_like(dx)),
            ipm_status=sol.status, ipm_iters=sol.iters)

    def _step_timed(self, ref_x, ref_u, ref_p, dltv, eta, consts):
        """The step split into assemble / IPM / post-solve, each ended by a
        device synchronization: (out, {formulate, solve, discretize, total,
        overhead}), the reference's timing keys (scp.jl:990-995)."""
        sync = ((lambda: torch.cuda.synchronize(self.device))
                if self.device.type == "cuda" else (lambda: None))
        t0 = time.perf_counter()
        A, b, c, const = self._assemble(ref_x, ref_u, ref_p, dltv, eta,
                                        consts)
        sync()
        t1 = time.perf_counter()
        sol = self._solve_sub(A, b, c)
        sync()
        t2 = time.perf_counter()
        out = self._post_solve(sol, const, ref_x, ref_u, ref_p, consts)
        sync()
        t3 = time.perf_counter()
        return out, {"formulate": t1 - t0, "solve": t2 - t1,
                     "discretize": t3 - t2, "total": t3 - t0,
                     "overhead": 0.0}

    def _ref_J_aug_impl(self, x, u, p, consts):
        """(nonlinear augmented cost (B,), DLTV) of reference trajectories."""
        dltv = self._discretize(x, u, p, consts)
        return (self.tmpl.original_cost(x, u, p, consts)
                + self._nonlinear_penalty(x, u, p, dltv.defects, consts)), dltv

    def _update(self, rho, eta):
        """The update rule (scvx.jl:1000-1045): (eta_next, accept, tag)."""
        pars = self.pars
        if rho < pars.rho_0:
            return max(pars.eta_lb, eta / pars.beta_sh), False, "S"
        if rho < pars.rho_1:
            return max(pars.eta_lb, eta / pars.beta_sh), True, "S"
        if rho < pars.rho_2:
            return eta, True, ""
        return min(pars.eta_ub, pars.beta_gr * eta), True, "G"

    def solve(self, warm: Optional[SCPSolution] = None,
              verbose: bool = False) -> SCPSolution:
        """The serial SCvx loop (reference scvx.jl:460-546) from the
        problem's guess (projected onto the convex sets unless
        `project_guess` is off) or a previous solution, whose arrays may be
        numpy: a history record per iteration (rho, eta, the reject flag
        and the trust-region update in `extras`), the problem's callback
        (True vetoes stopping; it may move `self.consts`, which every
        iteration reads), a progress table when verbose, and the
        continuous-time replay of the last accepted iterate at 2 Nsub
        substeps."""
        pars = self.pars
        user_cols = list(self.pbm.table_columns or ())
        table = Table([
            Column("iter", "iter", "{:4d}"),
            Column("L", "J", "{:11.4e}"),
            Column("J_aug", "J_aug", "{:11.4e}"),
            Column("defect", "defect", "{:9.2e}"),
            Column("rho", "rho", "{:8.2f}"),
            Column("eta", "eta", "{:8.1e}"),
            Column("tr", "tr", "{:>3s}"),
            Column("dev", "deviation", "{:9.2e}"),
            Column("ipm", "ipm", "{:4d}"),
        ] + [Column(key, heading, fmt)
             for key, heading, fmt, _ in user_cols]) if verbose else None

        if warm is not None:
            ref = tuple(self._t(a) for a in (warm.xd, warm.ud, warm.p))
        else:
            ref = self._guess
            if pars.project_guess:
                ref = project_convex(self.pbm, self.scaling, *ref,
                                     t_grid=self.t_np, dtype=self.dtype,
                                     device=self.device)
        ref = tuple(a[None] for a in ref)
        J_ref, dltv = self._ref_J_aug_impl(*ref, self.consts)
        J_ref = float(J_ref[0])
        eta = pars.eta_init

        history = []
        status = SCPStatus.FAILED
        out = best = None
        n_iter = 0
        np_ = lambda a: a[0].cpu().numpy()
        for it in range(pars.iter_max):
            t0 = time.perf_counter()
            # self.consts is read at every iteration: the callback may move it
            eta_t = torch.full((1,), eta, dtype=self.dtype,
                               device=self.device)
            if pars.timing_detail:
                out, timing = self._step_timed(*ref, dltv, eta_t,
                                               self.consts)
            else:
                out = self._step_impl(*ref, dltv, eta_t, self.consts)
                timing = None
            n_iter = it + 1
            feas = bool(out["feas"][0])
            deviation = float(out["deviation"][0])
            L_sol = float(out["L"][0])
            J_sol = float(out["J_aug"][0])
            pre_improv = J_ref - L_sol
            act_improv = J_ref - J_sol
            rho = act_improv / pre_improv if pre_improv != 0 else np.inf
            pre_improv_rel = pre_improv / abs(J_ref) if J_ref != 0 else 0.0
            eta_next, accept, tr = self._update(rho, eta)

            rec = IterationRecord(
                iteration=n_iter, x=np_(out["x"]), u=np_(out["u"]),
                p=np_(out["p"]), J_aug=J_sol, J_orig=L_sol, feas=feas,
                deviation=deviation, improv_rel=pre_improv_rel,
                ipm_status=int(out["ipm_status"][0]),
                ipm_iters=int(out["ipm_iters"][0]),
                defect_norm=float(out["defect_norm"][0]),
                vd_norm=float(out["vd_norm"][0]),
                vs_norm=float(out["vs_norm"][0]),
                timing=(dict(timing, overhead=(time.perf_counter() - t0
                                               - timing["total"]))
                        if timing else
                        {"total": time.perf_counter() - t0}),
                extras={"rho": rho, "eta": eta, "reject": not accept,
                        "tr_update": tr})
            history.append(rec)

            stop = (it > 0 and feas
                    and (pre_improv_rel <= pars.eps_rel
                         or deviation <= pars.eps_abs))
            if self.pbm.callback is not None and self.pbm.callback(rec):
                stop = False
            # after the callback, so that user columns see what it set
            if table:
                table.print_row(dict(
                    iter=n_iter, L=L_sol, J_aug=J_sol,
                    defect=rec.defect_norm, rho=rho, eta=eta,
                    tr=tr + ("" if accept else "!"), dev=deviation,
                    ipm=rec.ipm_iters,
                    **{key: fn(rec) for key, _, _, fn in user_cols}))
            if accept:
                ref = (out["x"], out["u"], out["p"])
                dltv = out["dltv"]
                J_ref = J_sol
                best = out
            eta = eta_next
            if stop:
                status = SCPStatus.SOLVED
                break

        if out is None:
            raise SCPError(SCPStatus.FAILED, "SCvx: no iteration ran")
        # the reference's status rule (scp.jl:196-245): SOLVED as long as
        # the last subproblem solved cleanly, even at iter_max
        if status != SCPStatus.SOLVED and int(out["ipm_status"][0]) in (
                int(ipm.IPMStatus.OPTIMAL), int(ipm.IPMStatus.ALMOST_OPTIMAL)):
            status = SCPStatus.SOLVED
        final = best if best is not None else out
        ts, xs = propagate(
            self.pbm.f, final["x"][0, 0], final["u"][0], final["p"][0],
            self._t_grid, nsub=2 * pars.Nsub, method=pars.disc_method,
            impulse=self.pbm.impulse, actions=self.pbm.integration_actions,
            consts=self.consts)
        return SCPSolution(
            status=status, algorithm="scvx", iterations=n_iter,
            xd=np_(final["x"]), ud=np_(final["u"]), p=np_(final["p"]),
            cost=float(final["L"][0]), t_grid=self.t_np.copy(),
            feas=bool(final["feas"][0]), history=history,
            t_cont=ts.cpu().numpy(), x_cont=xs.cpu().numpy())

    def solve_batched(self, bx, bu, bp, n_iters: int):
        """Batched SCvx from references bx (B, N, nx), bu (B, N, nu),
        bp (B, np) (not projected), with at most n_iters iterations. eta,
        J_ref and the reference trajectory with its DLTV are per-scenario
        state under the serial update rule: a rejected step keeps the old
        reference. A stopped (or non-finite) scenario freezes: its state,
        eta included, no longer moves and it leaves the IPM's batch; the
        loop ends when every scenario has stopped.

        Returns per scenario the final x/u/p, J_aug (of the reference kept),
        J_orig (its original cost), feas, defect_norm, status (SCPStatus
        codes), iters, ipm_status (of the last accepted step), and
        per-iteration traces (feas, deviation, rho, eta (the radius the step
        ran with), J_aug, accept, active, ipm_iters; NaN, False or 0 for a
        frozen scenario)."""
        pars = self.pars
        consts = self.consts
        B = bx.shape[0]
        dev, dt = self.device, self.dtype
        x, u, p = bx.clone(), bu.clone(), bp.clone()
        J_ref, dltv = self._ref_J_aug_impl(x, u, p, consts)
        eta = torch.full((B,), pars.eta_init, dtype=dt, device=dev)
        done = torch.zeros(B, dtype=torch.bool, device=dev)
        status = torch.full((B,), int(SCPStatus.FAILED), dtype=torch.int32,
                            device=dev)
        iters = torch.zeros(B, dtype=torch.int32, device=dev)
        ipmst = torch.full((B,), int(ipm.IPMStatus.MAX_ITER),
                           dtype=torch.int32, device=dev)
        traces = []
        for it in range(n_iters):
            if bool(done.all()):
                break
            idx = (~done).nonzero()[:, 0]
            e = eta[idx]
            Jr = J_ref[idx]
            out = self._step_impl(x[idx], u[idx], p[idx], dltv.index(idx), e,
                                  consts)
            finite = torch.isfinite(out["J_aug"]) & torch.isfinite(out["L"])
            pre = Jr - out["L"]
            act = Jr - out["J_aug"]
            rho = torch.where(pre != 0, act / torch.where(pre != 0, pre, 1.0),
                              math.inf)
            pre_rel = torch.where(Jr != 0, pre / torch.abs(
                torch.where(Jr != 0, Jr, 1.0)), 0.0)
            # the update rule's bands (scvx.jl:1000-1045)
            accept = rho >= pars.rho_0
            eta_next = torch.where(
                rho < pars.rho_1, torch.clamp(e / pars.beta_sh,
                                              min=pars.eta_lb),
                torch.where(rho < pars.rho_2, e,
                            torch.clamp(pars.beta_gr * e, max=pars.eta_ub)))
            stop = (out["feas"] & ((pre_rel <= pars.eps_rel)
                                   | (out["deviation"] <= pars.eps_abs))
                    if it > 0 else torch.zeros_like(finite))
            newly = stop | ~finite
            take = accept & finite
            adv = idx[take]
            x[adv] = out["x"][take]
            u[adv] = out["u"][take]
            p[adv] = out["p"][take]
            dltv = type(dltv)(*(
                a.index_copy(0, adv, b_[take])
                for a, b_ in zip(dltv, out["dltv"])))
            J_ref[adv] = out["J_aug"][take]
            ipmst[adv] = out["ipm_status"][take]
            status[idx[newly]] = torch.where(
                stop & finite, int(SCPStatus.SOLVED),
                int(SCPStatus.FAILED)).to(torch.int32)[newly]
            iters[idx] = it + 1
            eta[idx] = eta_next
            done[idx[newly]] = True
            tr = {k: torch.full((B,), math.nan, dtype=dt, device=dev)
                  for k in ("deviation", "rho", "eta", "J_aug")}
            for k, v in (("deviation", out["deviation"]), ("rho", rho),
                         ("eta", e), ("J_aug", out["J_aug"])):
                tr[k][idx] = v
            for k, v in (("feas", out["feas"]), ("accept", accept)):
                tr[k] = torch.zeros(B, dtype=torch.bool, device=dev)
                tr[k][idx] = v
            tr["active"] = torch.zeros(B, dtype=torch.bool, device=dev)
            tr["active"][idx] = True
            tr["ipm_iters"] = torch.zeros(B, dtype=torch.int32, device=dev)
            tr["ipm_iters"][idx] = out["ipm_iters"]
            traces.append(tr)
        ipm_ok = ((ipmst == int(ipm.IPMStatus.OPTIMAL))
                  | (ipmst == int(ipm.IPMStatus.ALMOST_OPTIMAL)))
        status = torch.where(~done & ipm_ok,
                             torch.full_like(status, int(SCPStatus.SOLVED)),
                             status)
        defect = torch.amax(torch.abs(dltv.defects / self.scaling.Sx),
                            dim=(1, 2))
        return dict(x=x, u=u, p=p, J_aug=J_ref,
                    J_orig=self.tmpl.original_cost(x, u, p, consts),
                    feas=defect <= pars.feas_tol, defect_norm=defect,
                    status=status, iters=iters, ipm_status=ipmst,
                    traces=traces)


def solve(pbm: TrajectoryProblem, pars: SCvxParameters,
          warm: Optional[SCPSolution] = None, verbose: bool = False,
          dtype=None, device=None) -> SCPSolution:
    """One-shot serial SCvx solve (reference `SCvx.solve`, scvx.jl:460), on
    the card unless `device` says otherwise."""
    return SCvx(pbm, pars, dtype=dtype, device=device).solve(
        warm=warm, verbose=verbose)
