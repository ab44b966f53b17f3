"""GuSTO: guaranteed sequential trajectory optimization with soft state
penalties, exact dynamics and a soft-penalty-weight ladder, serial and
batched over scenarios.

Counterpart of `scptoolbox_tpu/solvers/gusto.py` (`GuSTOParameters` :63,
`_pnorm` :106, `GuSTO.__init__` :118, `_discretize` :235,
`_post_trust_region` :243, `_assemble` :316, `_h_pen` :401,
`_nonlinear_state_penalty` :408, `_dyn_error` :428, `_step_impl` :447,
`_post_solve` :464, `_step_timed` :522, `_ref_J_aug_impl` :561, the serial
`solve` :568, `solve_batched` :724 / `_solve_batched_impl` :738 and the
module-level `solve` :836; reference src/solvers/gusto.jl).

  * dynamics and boundary conditions exact, no virtual control
    (gusto.jl:452-454);
  * nonconvex path constraints s soft-penalized: pen="quad" gives
    lambda max(0, s_lin)^2 through slacks vs >= max(0, s_lin) and one
    trapz-weighted quadratic epigraph; pen="softplus" gives
    lambda log(1 + e^{hom s_lin}) / hom through two exponential cones per
    penalized scalar (gusto.jl:970-1031);
  * soft one-sided trust region ||dx_k||_q + ||dp||_q <= eta + tr_k with
    tr_k penalized like the constraints (gusto.jl:1060-1190; q = 4 bounds
    the squared 2-norm);
  * the convex state set X relaxed by indicator variables unless the
    problem sets force_hard (problem.jl:686-807);
  * rho = (|J_aug - L_aug| + dyn_error) / (|L_aug| + dynamics norm) with
    the trapz linearization error of the dynamics at the solution
    (gusto.jl:1245-1293);
  * the update rule (gusto.jl:1310-1427): a trust-region violation rejects
    and grows lambda by gamma_fail; rho < rho_0 grows eta, rho < rho_1
    holds it, else shrink and reject; lambda resets to lam_init once the
    constraints hold; the radius decays by kappa = mu^(1 + iter - iter_mu);
  * stop when iter > 1 and ((feasible and (dJ_rel <= eps_rel or deviation
    <= eps_abs)) or lambda > lam_max) (gusto.jl:1203-1230).

Every step is taken on a batch of scenarios (the serial solve is a batch of
one). In `solve_batched` eta, lambda, J_ref and the reference trajectory
with its DLTV are per-scenario state; lambda enters each scenario's cost
vector and eta its right-hand side; a stopped or non-finite scenario
freezes and leaves the IPM's batch.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

import numpy as np
import torch
from torch.func import jacfwd, vmap

from scptoolbox_torch.config import (SCPError, SCPStatus, default_dtype,
                                     resolve_device)
from scptoolbox_torch.ops import ipm
from scptoolbox_torch.ops.discretize import (DiscretizationType, discretize,
                                             propagate)
from scptoolbox_torch.parser.problem import (ConeKind, TrajectoryProblem,
                                             bind_consts,
                                             make_gusto_running_cost)
from scptoolbox_torch.solvers.autoscale import solver_scaling
from scptoolbox_torch.solvers.projection import project_convex
from scptoolbox_torch.solvers.solution import IterationRecord, SCPSolution
from scptoolbox_torch.solvers.structure import (ipm_kkt_kwargs, random_dltv,
                                                resolve_kkt)
from scptoolbox_torch.solvers.subproblem import Assembler
from scptoolbox_torch.solvers.template import (BlockPoster, SCPTemplate,
                                               _perturb_consts)
from scptoolbox_torch.utils.table import Column, Table


@dataclasses.dataclass(frozen=True)
class GuSTOParameters:
    """GuSTO algorithm parameters (reference gusto.jl:58-85; defaults from
    the quadrotor test configuration, quadrotor/tests.jl:89-115)."""

    N: int = 30
    Nsub: int = 15
    iter_max: int = 15
    disc_method: DiscretizationType = DiscretizationType.FOH
    lam_init: float = 1e4
    lam_max: float = 1e9
    rho_0: float = 0.1
    rho_1: float = 0.9
    beta_sh: float = 2.0
    beta_gr: float = 2.0
    gamma_fail: float = 5.0
    eta_init: float = 10.0
    eta_lb: float = 1e-3
    eta_ub: float = 10.0
    mu: float = 0.8
    iter_mu: int = 6
    eps_abs: float = 1e-5
    eps_rel: float = 1e-4
    feas_tol: float = 1e-3
    pen: str = "quad"          # "quad" | "softplus" (exp-cone LSE epigraph)
    structured_kkt: object = None
    kkt_method: object = None
    timing_detail: bool = False   # per-phase timing in the serial history
    hom: float = 100.0
    q_tr: float = math.inf
    q_exit: float = math.inf
    ipm_tol: float = 1e-8
    ipm_max_iter: int = 60
    ipm_tol_almost: float = 1e-5
    project_guess: bool = True
    tr_buffer: float = 1e-3
    c_buffer: float = 1e-3


_Q2KIND = {1.0: ConeKind.L1, 2.0: ConeKind.SOC, 4.0: ConeKind.SOC,
           math.inf: ConeKind.LINF}


def _pnorm(v, q):
    """GuSTO's trust-region norm over the last dim: q = 4 is the squared
    2-norm (the reference's w = 2 branch), not PTR's 4-norm."""
    if q == math.inf:
        return torch.amax(torch.abs(v), dim=-1)
    if q == 4.0:
        return torch.sum(v * v, dim=-1)
    return torch.sum(torch.abs(v) ** q, dim=-1) ** (1.0 / q)


class GuSTO:
    """GuSTO solver bound to one TrajectoryProblem, on one device and dtype
    (the card and float32 unless told otherwise)."""

    def __init__(self, pbm: TrajectoryProblem, pars: GuSTOParameters,
                 dtype=None, device=None):
        assert pars.pen in ("quad", "softplus"), pars.pen
        if pbm.gusto_cost is not None and pbm.running_cost is None:
            # the scalar running cost from the structured triple; its
            # nonconvex terms come back with a zero Hessian, so the
            # template's quadratic expansion linearizes them
            pbm = dataclasses.replace(pbm, running_cost=(
                make_gusto_running_cost(pbm.gusto_cost, pbm.nx, pbm.nu)))
        self.pbm = pbm
        self.pars = pars
        self.device = resolve_device(device)
        self.dtype = dtype or default_dtype(self.device)
        N = pars.N
        nx, nu, npp = pbm.nx, pbm.nu, pbm.np
        quad = pars.pen == "quad"
        self.t_np = np.linspace(0.0, 1.0, N)
        # X relaxed by indicators unless force_hard; U stays hard. Under
        # softplus vs tracks the raw linearized s (no vs >= 0)
        tmpl = SCPTemplate(pbm, N, self.t_np, dtype=self.dtype,
                           device=self.device, relax_dynamics=False,
                           relax_bcs=False, soft_X=not pbm.force_hard,
                           vs_nonneg=quad)
        lay, plan = tmpl.layout, tmpl.plan
        self.n_qX = tmpl.n_qX if tmpl.soft_X else 0
        if self.n_qX:
            # v_qX >= qX (and >= 0 for quad): the slacks the penalty reads
            lay.add("v_qX", N, self.n_qX)
            if quad:
                plan.nonneg("v_qX_nn", N * self.n_qX)
            plan.nonneg("v_qX_ge", N * self.n_qX)

        kind = _Q2KIND[float(pars.q_tr)]
        lay.add("dx_lq", N)
        self._tr_x = BlockPoster("tr_x", kind, 1 + nx, N, lay, plan)
        if npp > 0:
            lay.add("dp_lq")
            self._tr_p = BlockPoster("tr_p", kind, 1 + npp, 1, lay, plan)
        lay.add("tr", N)        # one-sided trust-region slack
        lay.add("v_tr", N)      # v_tr >= tr (and >= 0 for quad)
        if quad:
            plan.nonneg("v_tr_nn", N)
        plan.nonneg("v_tr_ge", N)
        self._nsum = 1 + (1 if npp > 0 else 0)
        if pars.q_tr == 4.0:
            lay.add("w_tr", N)
            plan.soc("tr_w", N, 1 + self._nsum)
            plan.soc("tr_geom", N, 3)
        else:
            plan.nonneg("tr_bound", N)
        n_pen = N + N * tmpl.struct.ns + N * self.n_qX
        self._n_pen = n_pen
        if quad:
            # one quadratic epigraph for the lambda-weighted penalties
            lay.add("t_pen")
            plan.soc("pen_epi", 1, n_pen + 2)
        else:
            # softplus per scalar f: e^{-w} <= u, e^{hom f - w} <= v,
            # u + v <= 1, so w >= log(1 + e^{hom f}); penalty lam w / hom
            lay.add("sp_w", n_pen)
            lay.add("sp_u", n_pen)
            lay.add("sp_v", n_pen)
            plan.exp("sp_e1", n_pen)
            plan.exp("sp_e2", n_pen)
            plan.nonneg("sp_uv", n_pen)
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
            lam = T([1.0 + abs(rng.standard_normal())])
            A = self._assemble(rx, ru, rp, dltv, eta, lam, consts)[0]
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

    def _post_trust_region(self, asm, ref_x, ref_p, eta):
        """The soft one-sided trust region (gusto.jl:1060-1190) around
        ref_x (B, N, nx), ref_p (B, np) with the radii eta (B,)."""
        tmpl, pars = self.tmpl, self.pars
        lay, plan = tmpl.layout, tmpl.plan
        N, nx, npp = pars.N, self.pbm.nx, self.pbm.np
        dt, dev = self.dtype, self.device
        Bn = ref_x.shape[0]
        sc = self.scaling

        def post_eps(poster, z_idx, lq_idx, iS, z_ref, count, nz):
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
        if npp > 0:
            post_eps(self._tr_p, lay.idx("p")[None, :],
                     lay.idx("dp_lq").reshape(1, 1), 1.0 / sc.Sp,
                     ref_p[:, None, :], 1, npp)

        lq_cols = [lay.idx("dx_lq").reshape(N, 1)]
        if npp > 0:
            lq_cols.append(np.broadcast_to(lay.idx("dp_lq").reshape(1, 1),
                                           (N, 1)))
        nsum = len(lq_cols)
        tr_cols = lay.idx("tr").reshape(N, 1)
        if pars.q_tr == 4.0:
            # w >= ||(dx_lq, dp_lq)||_2 ; eta + tr >= w^2 as the SOC
            # [eta + tr + 1, 2 w, eta + tr - 1]
            w_cols = lay.idx("w_tr").reshape(N, 1)
            J = torch.zeros(nsum + 1, nsum + 1, dtype=dt, device=dev)
            J[0, nsum] = 1.0
            J[1:, :nsum] = torch.eye(nsum, dtype=dt, device=dev)
            asm.res_soc(plan.rows("tr_w"),
                        np.concatenate(lq_cols + [w_cols], 1),
                        J.expand(N, nsum + 1, nsum + 1),
                        torch.zeros(N, nsum + 1, dtype=dt, device=dev))
            Jg = torch.zeros(N, 3, 2, dtype=dt, device=dev)
            Jg[:, 0, 1] = 1.0
            Jg[:, 1, 0] = 2.0
            Jg[:, 2, 1] = 1.0
            e = eta[:, None].expand(Bn, N)
            v0g = torch.stack([e + 1.0, torch.zeros_like(e), e - 1.0], 2)
            asm.res_soc(plan.rows("tr_geom"),
                        np.concatenate([w_cols, tr_cols], 1), Jg, v0g)
        else:
            rows = plan.rows("tr_bound").reshape(N, 1)
            J = torch.cat([torch.ones(N, 1, nsum, dtype=dt, device=dev),
                           -torch.ones(N, 1, 1, dtype=dt, device=dev)], 2)
            asm.add_A(rows, np.concatenate(lq_cols + [tr_cols], 1), J)
            asm.add_b(rows, eta[:, None, None].expand(Bn, N, 1))

        # v_tr >= tr (plus v_tr >= 0 for the quad penalty)
        vtr = lay.idx("v_tr").reshape(N, 1)
        if pars.pen == "quad":
            asm.add_A(plan.rows("v_tr_nn").reshape(N, 1), vtr,
                      -torch.ones(N, 1, 1, dtype=dt, device=dev))
        asm.add_A(plan.rows("v_tr_ge").reshape(N, 1),
                  np.concatenate([tr_cols, vtr], 1),
                  torch.tensor([1.0, -1.0], dtype=dt, device=dev).expand(
                      N, 1, 2))

    def _assemble(self, ref_x, ref_u, ref_p, dltv, eta, lam, consts):
        """Batched subproblems (A (B, m, n), b, c, const) around the
        references, with the radii eta (B,) in b and the penalty weights
        lam (B,) in c."""
        tmpl, pars = self.tmpl, self.pars
        lay, plan = tmpl.layout, tmpl.plan
        N, ns = pars.N, tmpl.struct.ns
        dt, dev = self.dtype, self.device
        Bn = ref_x.shape[0]
        asm = Assembler(tmpl.m, tmpl.n, Bn, dt, dev)
        tmpl.assemble_core(asm, ref_x, ref_u, ref_p, dltv, consts)
        self._post_trust_region(asm, ref_x, ref_p, eta)

        # penalized scalars v_tr (N), vs (N ns), v_qX (N n_qX), each with
        # the trapz weight of its node
        w = torch.as_tensor(tmpl.w_trapz, dtype=dt, device=dev)
        pen_cols = [lay.idx("v_tr").reshape(N)]
        pen_w = [w]
        if ns:
            pen_cols.append(lay.idx("vs").reshape(N * ns))
            pen_w.append(torch.repeat_interleave(w, ns))
        if self.n_qX:
            # v_qX >= qX (+ >= 0 for quad): the soft state-set indicators
            nq = self.n_qX
            vq = lay.idx("v_qX").reshape(N * nq)
            qx_cols = np.concatenate(
                [lay.idx(f"qX{i}").reshape(N, -1)
                 for i in range(len(tmpl.struct.X_kinds))], axis=1
            ).reshape(N * nq)
            if pars.pen == "quad":
                asm.add_A(plan.rows("v_qX_nn").reshape(N * nq, 1),
                          vq.reshape(N * nq, 1),
                          -torch.ones(N * nq, 1, 1, dtype=dt, device=dev))
            asm.add_A(plan.rows("v_qX_ge").reshape(N * nq, 1),
                      np.stack([qx_cols, vq], axis=1),
                      torch.tensor([1.0, -1.0], dtype=dt, device=dev).expand(
                          N * nq, 1, 2))
            pen_cols.append(vq)
            pen_w.append(torch.repeat_interleave(w, nq))
        cols = np.concatenate(pen_cols)
        wts = torch.cat(pen_w)
        n_pen = cols.shape[0]
        if pars.pen == "quad":
            # t_pen >= sum_i w_i f_i^2 as SOC [t + 1/2, t - 1/2, sqrt(w) f]
            t_col = lay.idx("t_pen").reshape(1)
            J = torch.zeros(1, n_pen + 2, n_pen + 1, dtype=dt, device=dev)
            J[0, 0, n_pen] = 1.0
            J[0, 1, n_pen] = 1.0
            J[0, 2:, :n_pen] = torch.diag(torch.sqrt(wts))
            v0 = torch.zeros(1, n_pen + 2, dtype=dt, device=dev)
            v0[0, 0], v0[0, 1] = 0.5, -0.5
            asm.res_soc(plan.rows("pen_epi"),
                        np.concatenate([cols, t_col])[None, :], J, v0)
            asm.add_c(t_col, lam[:, None])
        else:
            # EXP(-w, 1, u); EXP(hom f - w, 1, v); u + v <= 1; cost
            # lam sum_i w_i sp_w_i / hom
            hom = pars.hom
            wc = lay.idx("sp_w").reshape(n_pen)
            uc = lay.idx("sp_u").reshape(n_pen)
            vc = lay.idx("sp_v").reshape(n_pen)
            v01 = torch.zeros(n_pen, 3, dtype=dt, device=dev)
            v01[:, 1] = 1.0
            J1 = torch.zeros(n_pen, 3, 2, dtype=dt, device=dev)
            J1[:, 0, 0] = -1.0
            J1[:, 2, 1] = 1.0
            asm.res_exp(plan.rows("sp_e1"), np.stack([wc, uc], axis=1), J1,
                        v01)
            J2 = torch.zeros(n_pen, 3, 3, dtype=dt, device=dev)
            J2[:, 0, 0] = hom
            J2[:, 0, 1] = -1.0
            J2[:, 2, 2] = 1.0
            asm.res_exp(plan.rows("sp_e2"), np.stack([cols, wc, vc], axis=1),
                        J2, v01)
            asm.res_nonpos(plan.rows("sp_uv").reshape(n_pen, 1),
                           np.stack([uc, vc], axis=1),
                           torch.ones(n_pen, 1, 2, dtype=dt, device=dev),
                           -torch.ones(n_pen, 1, dtype=dt, device=dev))
            asm.add_c(wc, lam[:, None] * wts / hom)
        return asm.finish(self._S_full, self._c_full)

    def _h_pen(self, f, lam):
        """The soft penalty of f (B, ...) with the weights lam (B,)
        (gusto.jl:970-1031): quad lam max(0, f)^2, softplus
        lam log(1 + e^{hom f}) / hom."""
        lam = lam.reshape(lam.shape + (1,) * (f.dim() - 1))
        if self.pars.pen == "quad":
            return lam * torch.clamp(f, min=0.0) ** 2
        hom = self.pars.hom
        return lam * torch.logaddexp(torch.zeros_like(f), hom * f) / hom

    def _s_values(self, x, u, p, consts):
        """s at every node: (B, N, ns)."""
        Bn, N = x.shape[0], self.pars.N
        t_flat, k_flat = self.tmpl._nodes(Bn)
        return vmap(bind_consts(self.pbm.s, consts))(
            t_flat, k_flat, x.reshape(Bn * N, -1), u.reshape(Bn * N, -1),
            p.repeat_interleave(N, dim=0)).reshape(Bn, N, -1)

    def _nonlinear_state_penalty(self, x, u, p, lam, consts=None):
        """state_penalty_cost(:nonconvex) (gusto.jl:845-865): (B,)."""
        if consts is None:
            consts = self.consts
        tmpl = self.tmpl
        w = torch.as_tensor(tmpl.w_trapz, dtype=x.dtype, device=x.device)
        pen = x.new_zeros(x.shape[0])
        if tmpl.struct.ns:
            sval = self._s_values(x, u, p, consts)
            pen = pen + torch.sum(self._h_pen(sval, lam), dim=2) @ w
        if self.n_qX:
            qx = tmpl.X_indicators(x, p, consts)
            pen = pen + torch.sum(self._h_pen(qx, lam), dim=2) @ w
        return pen

    def _dyn_error(self, ref_x, ref_u, ref_p, x, u, p):
        """The dynamics' linearization error at the solution and the norm
        of the linearized field, trapz-weighted (gusto.jl:1268-1284): (B,)
        each."""
        Bn, N = x.shape[0], self.pars.N
        f = self.pbm.f
        has_p = self.pbm.np > 0

        def per_node(t, xb, ub, rp, xk, uk, pk):
            f_ref = f(t, xb, ub, rp)
            jac = jacfwd(f, argnums=(1, 2, 3) if has_p else (1, 2))(
                t, xb, ub, rp)
            f_lin = f_ref + jac[0] @ (xk - xb) + jac[1] @ (uk - ub)
            if has_p:
                f_lin = f_lin + jac[2] @ (pk - rp)
            f_nl = f(t, xk, uk, pk)
            return (torch.linalg.vector_norm(f_nl - f_lin),
                    torch.linalg.vector_norm(f_lin))

        flat = lambda a: a.reshape(Bn * N, -1)
        t_flat, _ = self.tmpl._nodes(Bn)
        df, dxdt = vmap(per_node)(
            t_flat, flat(ref_x), flat(ref_u),
            ref_p.repeat_interleave(N, dim=0), flat(x), flat(u),
            p.repeat_interleave(N, dim=0))
        w = torch.as_tensor(self.tmpl.w_trapz, dtype=x.dtype, device=x.device)
        return df.reshape(Bn, N) @ w, dxdt.reshape(Bn, N) @ w

    def _solve_sub(self, A, b, c):
        return ipm.solve_batched(
            A, b, c, self.spec, tol=self.pars.ipm_tol,
            tol_almost=self.pars.ipm_tol_almost,
            max_iter=self.pars.ipm_max_iter,
            **ipm_kkt_kwargs(self._kkt_method, self._kkt_builder))

    def _step_impl(self, ref_x, ref_u, ref_p, dltv, eta, lam, consts=None):
        """One GuSTO iteration for a batch of scenarios, eta and lam (B,)."""
        if consts is None:
            consts = self.consts
        A, b, c, const = self._assemble(ref_x, ref_u, ref_p, dltv, eta, lam,
                                        consts)
        sol = self._solve_sub(A, b, c)
        return self._post_solve(sol, const, ref_x, ref_u, ref_p, eta, lam,
                                consts)

    def _post_solve(self, sol, const, ref_x, ref_u, ref_p, eta, lam, consts):
        """Extract, re-discretize and compute the ratio's ingredients (the
        part of the step after the subproblem solve), per scenario."""
        pars, tmpl = self.pars, self.tmpl
        sc = self.scaling
        d = self._S_full * sol.x + self._c_full
        x, u, p = tmpl.extract(d)
        L = tmpl.original_cost(x, u, p, consts)
        L_aug = sol.obj + const
        w = torch.as_tensor(tmpl.w_trapz, dtype=d.dtype, device=d.device)
        # the convex trust-region penalty at the solution
        J_tr = self._h_pen(d[:, tmpl.layout.sl("v_tr")], lam) @ w
        J_aug = (L + self._nonlinear_state_penalty(x, u, p, lam, consts)
                 + J_tr)

        dltv_new = self._discretize(x, u, p, consts)
        defect_norm = torch.amax(torch.abs(dltv_new.defects / sc.Sx),
                                 dim=(1, 2))
        has_p = self.pbm.np > 0
        dev_x = (x - ref_x) / sc.Sx
        dev_p = (p - ref_p) / sc.Sp if has_p else None
        q = pars.q_exit
        dx = torch.amax(_pnorm(dev_x, q), dim=1)
        dp = _pnorm(dev_p, q) if has_p else torch.zeros_like(dx)

        # rho (gusto.jl:1245-1293)
        dyn_err, dyn_nrml = self._dyn_error(ref_x, ref_u, ref_p, x, u, p)
        rho = (torch.abs(J_aug - L_aug) + dyn_err) / (torch.abs(L_aug)
                                                      + dyn_nrml)

        # the trust region's left-hand side at the solution (gusto.jl:1358)
        qq = pars.q_tr
        dxs = _pnorm(dev_x, qq)
        dps = _pnorm(dev_p, qq) if has_p else torch.zeros_like(dx)
        tr_lhs_max = torch.amax(dxs + dps[:, None], dim=1) - eta

        # constraint satisfaction, for the lambda ladder (gusto.jl:1365-1395)
        viol = torch.zeros_like(dx)
        if tmpl.struct.ns:
            viol = torch.amax(self._s_values(x, u, p, consts), dim=(1, 2))
        if self.n_qX:
            viol = torch.maximum(viol, torch.amax(
                tmpl.X_indicators(x, p, consts), dim=(1, 2)))
        return dict(
            x=x, u=u, p=p, dltv=dltv_new, L=L, L_aug=L_aug, J_aug=J_aug,
            feas=defect_norm <= pars.feas_tol, deviation=dx + dp,
            defect_norm=defect_norm, rho=rho, tr_lhs_max=tr_lhs_max,
            viol=viol, dyn_err=dyn_err, dyn_nrml=dyn_nrml,
            ipm_status=sol.status, ipm_iters=sol.iters)

    def _step_timed(self, ref_x, ref_u, ref_p, dltv, eta, lam, consts):
        """The step split into assemble / IPM / post-solve, each ended by a
        device synchronization: (out, {formulate, solve, discretize, total,
        overhead}), the reference's timing keys (scp.jl:990-995)."""
        sync = ((lambda: torch.cuda.synchronize(self.device))
                if self.device.type == "cuda" else (lambda: None))
        t0 = time.perf_counter()
        A, b, c, const = self._assemble(ref_x, ref_u, ref_p, dltv, eta, lam,
                                        consts)
        sync()
        t1 = time.perf_counter()
        sol = self._solve_sub(A, b, c)
        sync()
        t2 = time.perf_counter()
        out = self._post_solve(sol, const, ref_x, ref_u, ref_p, eta, lam,
                               consts)
        sync()
        t3 = time.perf_counter()
        return out, {"formulate": t1 - t0, "solve": t2 - t1,
                     "discretize": t3 - t2, "total": t3 - t0,
                     "overhead": 0.0}

    def _ref_J_aug_impl(self, x, u, p, lam, consts):
        """(nonlinear augmented cost (B,), DLTV) of reference trajectories
        at the penalty weights lam (B,)."""
        dltv = self._discretize(x, u, p, consts)
        return (self.tmpl.original_cost(x, u, p, consts)
                + self._nonlinear_state_penalty(x, u, p, lam, consts)), dltv

    def _update(self, rho, eta, lam, trust_viol, constr_ok):
        """The update rule (gusto.jl:1310-1427) before the forced decay:
        (eta_next, lam_next, accept, tag)."""
        pars = self.pars
        relax = pars.lam_init if constr_ok else pars.gamma_fail * lam
        lag = "" if constr_ok else "lG"
        if trust_viol:
            return eta, pars.gamma_fail * lam, False, "lG"
        if rho < pars.rho_0:
            return (min(pars.eta_ub, pars.beta_gr * eta), relax, True,
                    "G" + ("" if constr_ok else " lG"))
        if rho < pars.rho_1:
            return eta, relax, True, lag
        return max(pars.eta_lb, eta / pars.beta_sh), lam, False, "S"

    def _kappa(self, it):
        """The forced trust-region decay of iteration it + 1."""
        pars = self.pars
        return (1.0 if (it + 1) < pars.iter_mu
                else pars.mu ** (1 + (it + 1) - pars.iter_mu))

    def solve(self, warm: Optional[SCPSolution] = None,
              verbose: bool = False) -> SCPSolution:
        """The serial GuSTO loop (reference gusto.jl:425-502) from the
        problem's guess (projected onto the convex sets unless
        `project_guess` is off) or a previous solution, whose arrays may be
        numpy: a history record per iteration (rho, eta, lambda and the
        reject flag in `extras`), the problem's callback (True vetoes
        stopping; it may move `self.consts`, which every iteration reads),
        a progress table when verbose, and the continuous-time replay of
        the last accepted iterate at 2 Nsub substeps. SOLVED also at
        iter_max when the returned iterate's subproblem solved cleanly and
        lambda stayed within lam_max (scp.jl:196-245)."""
        pars = self.pars
        user_cols = list(self.pbm.table_columns or ())
        table = Table([
            Column("iter", "iter", "{:4d}"),
            Column("L", "J", "{:11.4e}"),
            Column("J_aug", "J_aug", "{:11.4e}"),
            Column("defect", "defect", "{:9.2e}"),
            Column("rho", "rho", "{:8.2e}"),
            Column("eta", "eta", "{:8.1e}"),
            Column("lam", "lambda", "{:8.1e}"),
            Column("upd", "upd", "{:>4s}"),
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
        lam = pars.lam_init
        eta = pars.eta_init
        T1 = lambda v: torch.full((1,), v, dtype=self.dtype,
                                  device=self.device)
        J_ref, dltv = self._ref_J_aug_impl(*ref, T1(lam), self.consts)
        J_ref = float(J_ref[0])

        history = []
        status = SCPStatus.FAILED
        out = best = None
        n_iter = 0
        np_ = lambda a: a[0].cpu().numpy()
        for it in range(pars.iter_max):
            t0 = time.perf_counter()
            # self.consts is read at every iteration: the callback may move it
            if pars.timing_detail:
                out, timing = self._step_timed(*ref, dltv, T1(eta), T1(lam),
                                               self.consts)
            else:
                out = self._step_impl(*ref, dltv, T1(eta), T1(lam),
                                      self.consts)
                timing = None
            n_iter = it + 1
            feas = bool(out["feas"][0])
            deviation = float(out["deviation"][0])
            J_sol = float(out["J_aug"][0])
            rho = float(out["rho"][0])
            trust_viol = float(out["tr_lhs_max"][0]) > pars.tr_buffer
            constr_ok = float(out["viol"][0]) <= pars.c_buffer
            dJ_rel = abs(J_ref - J_sol) / abs(J_ref) if J_ref != 0 else 0.0
            eta_next, lam_next, accept, upd = self._update(
                rho, eta, lam, trust_viol, constr_ok)
            eta_next *= self._kappa(it)

            rec = IterationRecord(
                iteration=n_iter, x=np_(out["x"]), u=np_(out["u"]),
                p=np_(out["p"]), J_aug=J_sol, J_orig=float(out["L"][0]),
                feas=feas, deviation=deviation, improv_rel=dJ_rel,
                ipm_status=int(out["ipm_status"][0]),
                ipm_iters=int(out["ipm_iters"][0]),
                defect_norm=float(out["defect_norm"][0]),
                timing=(dict(timing, overhead=(time.perf_counter() - t0
                                               - timing["total"]))
                        if timing else
                        {"total": time.perf_counter() - t0}),
                extras={"rho": rho, "eta": eta, "lam": lam,
                        "reject": not accept})
            history.append(rec)

            infeasible = lam > pars.lam_max
            stop = (it > 0 and ((feas and (dJ_rel <= pars.eps_rel
                                           or deviation <= pars.eps_abs))
                                or infeasible))
            if self.pbm.callback is not None and self.pbm.callback(rec):
                stop = False
            # after the callback, so that user columns see what it set
            if table:
                table.print_row(dict(
                    iter=n_iter, L=rec.J_orig, J_aug=J_sol,
                    defect=rec.defect_norm, rho=rho, eta=eta, lam=lam,
                    upd=upd + ("" if accept else "!"), ipm=rec.ipm_iters,
                    **{key: fn(rec) for key, _, _, fn in user_cols}))
            if accept:
                ref = (out["x"], out["u"], out["p"])
                dltv = out["dltv"]
                J_ref = J_sol
                best = out
            eta, lam = eta_next, lam_next
            if stop:
                status = (SCPStatus.SOLVED if not infeasible
                          else SCPStatus.FAILED)
                break

        if out is None:
            raise SCPError(SCPStatus.FAILED, "GuSTO: no iteration ran")
        final = best if best is not None else out
        # the reference's status rule (scp.jl:196-245), on the ipm_status
        # of the iterate returned (the best accepted one)
        if (status != SCPStatus.SOLVED and not lam > pars.lam_max
                and int(final["ipm_status"][0]) in (
                    int(ipm.IPMStatus.OPTIMAL),
                    int(ipm.IPMStatus.ALMOST_OPTIMAL))):
            status = SCPStatus.SOLVED
        ts, xs = propagate(
            self.pbm.f, final["x"][0, 0], final["u"][0], final["p"][0],
            self._t_grid, nsub=2 * pars.Nsub, method=pars.disc_method,
            impulse=self.pbm.impulse, actions=self.pbm.integration_actions,
            consts=self.consts)
        return SCPSolution(
            status=status, algorithm="gusto", iterations=n_iter,
            xd=np_(final["x"]), ud=np_(final["u"]), p=np_(final["p"]),
            cost=float(final["L"][0]), t_grid=self.t_np.copy(),
            feas=bool(final["feas"][0]), history=history,
            t_cont=ts.cpu().numpy(), x_cont=xs.cpu().numpy())

    def solve_batched(self, bx, bu, bp, n_iters: int):
        """Batched GuSTO from references bx (B, N, nx), bu (B, N, nu),
        bp (B, np) (not projected), with at most n_iters iterations. eta,
        lambda, J_ref and the reference trajectory with its DLTV are
        per-scenario state under the serial update rule (its bands, the
        lambda ladder and the kappa decay): a rejected step keeps the old
        reference. A stopped (or non-finite) scenario freezes: its state no
        longer moves and it leaves the IPM's batch; the loop ends when
        every scenario has stopped.

        Returns per scenario the final x/u/p, J_aug (of the reference kept),
        J_orig (its original cost), feas, defect_norm, status (SCPStatus
        codes), iters, ipm_status (of the last accepted step), and
        per-iteration traces (feas, deviation, rho, eta and lam (the values
        the step ran with), J_aug, accept, active, ipm_iters; NaN, False or
        0 for a frozen scenario)."""
        pars = self.pars
        consts = self.consts
        B = bx.shape[0]
        dev, dt = self.device, self.dtype
        x, u, p = bx.clone(), bu.clone(), bp.clone()
        lam = torch.full((B,), pars.lam_init, dtype=dt, device=dev)
        J_ref, dltv = self._ref_J_aug_impl(x, u, p, lam, consts)
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
            e, lm, Jr = eta[idx], lam[idx], J_ref[idx]
            out = self._step_impl(x[idx], u[idx], p[idx], dltv.index(idx), e,
                                  lm, consts)
            finite = torch.isfinite(out["J_aug"]) & torch.isfinite(out["L"])
            rho = out["rho"]
            trust_viol = out["tr_lhs_max"] > pars.tr_buffer
            constr_ok = out["viol"] <= pars.c_buffer
            dJ_rel = torch.where(Jr != 0, torch.abs(Jr - out["J_aug"])
                                 / torch.abs(torch.where(Jr != 0, Jr, 1.0)),
                                 0.0)
            # the update rule's bands (gusto.jl:1310-1427)
            accept = ~trust_viol & (rho < pars.rho_1)
            grow = ~trust_viol & (rho < pars.rho_0)
            shrink = ~trust_viol & (rho >= pars.rho_1)
            eta_next = torch.where(
                grow, torch.clamp(pars.beta_gr * e, max=pars.eta_ub),
                torch.where(shrink, torch.clamp(e / pars.beta_sh,
                                                min=pars.eta_lb), e)
            ) * self._kappa(it)
            lam_next = torch.where(
                trust_viol | (accept & ~constr_ok), pars.gamma_fail * lm,
                torch.where(accept, torch.full_like(lm, pars.lam_init), lm))
            infeasible = lm > pars.lam_max      # the lambda of this step
            stop = ((out["feas"] & ((dJ_rel <= pars.eps_rel)
                                    | (out["deviation"] <= pars.eps_abs)))
                    | infeasible) if it > 0 else torch.zeros_like(finite)
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
                stop & finite & ~infeasible, int(SCPStatus.SOLVED),
                int(SCPStatus.FAILED)).to(torch.int32)[newly]
            iters[idx] = it + 1
            eta[idx] = eta_next
            lam[idx] = lam_next
            done[idx[newly]] = True
            tr = {k: torch.full((B,), math.nan, dtype=dt, device=dev)
                  for k in ("deviation", "rho", "eta", "lam", "J_aug")}
            for k, v in (("deviation", out["deviation"]), ("rho", rho),
                         ("eta", e), ("lam", lm), ("J_aug", out["J_aug"])):
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
        status = torch.where(~done & ipm_ok & (lam <= pars.lam_max),
                             torch.full_like(status, int(SCPStatus.SOLVED)),
                             status)
        defect = torch.amax(torch.abs(dltv.defects / self.scaling.Sx),
                            dim=(1, 2))
        return dict(x=x, u=u, p=p, J_aug=J_ref,
                    J_orig=self.tmpl.original_cost(x, u, p, consts),
                    feas=defect <= pars.feas_tol, defect_norm=defect,
                    status=status, iters=iters, ipm_status=ipmst,
                    traces=traces)


def solve(pbm: TrajectoryProblem, pars: GuSTOParameters,
          warm: Optional[SCPSolution] = None, verbose: bool = False,
          dtype=None, device=None) -> SCPSolution:
    """One-shot serial GuSTO solve (reference `GuSTO.solve`, gusto.jl:425),
    on the card unless `device` says otherwise."""
    return GuSTO(pbm, pars, dtype=dtype, device=device).solve(
        warm=warm, verbose=verbose)
