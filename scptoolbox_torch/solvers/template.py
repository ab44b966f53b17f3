"""SCP subproblem template: static structure + batched assembly shared by
the outer SCP loops.

Counterpart of `scptoolbox_tpu/solvers/template.py` (`_perturb_consts` :49,
`BlockPoster` :81 with its EXP kind :149-153 / :172-173 and the GEOM
lowering :115-145 / :198-240,
`post_quadratic_epigraphs` :245, `SCPTemplate` :313 with GuSTO's soft state
set (`soft_X`, the indicator layout :401-450) and `vs_nonneg` (:322-332,
:399-401), `assemble_core` :572 with `post_sets_soft` :650-688 and the
`vs_nn` rows :719-722, and `X_indicators` :835-877). The structure
(variable blocks, row counts, cone spec) is probed once from the problem
functions; `assemble_core` then posts the rows of a whole batch of
scenarios at once: every per-node callback is mapped over (scenario x node)
with `torch.func.vmap`, and its Jacobians come from `torch.func.jacfwd`.

Decision variables live in physical units during assembly; the diagonal
scaling d = S d_hat + c is applied by `Assembler.finish`.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch
from torch.func import grad, hessian, jacfwd, vmap

from scptoolbox_torch.ops.cones import ConeSpec
from scptoolbox_torch.parser.problem import (ConeKind, TrajectoryProblem,
                                             bind_consts)
from scptoolbox_torch.solvers.scaling import Scaling
from scptoolbox_torch.solvers.subproblem import Assembler, RowPlan, VarLayout


def _perturb_consts(consts, rng: np.random.Generator):
    """A consts tree with every float leaf pushed strictly away from zero
    (probes structure at consts values other than the construction ones)."""
    if consts is None:
        return None
    if isinstance(consts, dict):
        return {k: _perturb_consts(v, rng) for k, v in consts.items()}
    if isinstance(consts, (list, tuple)):
        return type(consts)(_perturb_consts(v, rng) for v in consts)
    if isinstance(consts, torch.Tensor):
        if not consts.is_floating_point():
            return consts
        off = 0.37 + 0.23 * np.abs(rng.standard_normal(tuple(consts.shape)))
        off = torch.as_tensor(off, dtype=consts.dtype, device=consts.device)
        return consts * (1.0 + 0.1 * off) + off
    a = np.asarray(consts)
    if not np.issubdtype(a.dtype, np.floating):
        return consts
    off = 0.37 + 0.23 * np.abs(rng.standard_normal(a.shape))
    return a * (1.0 + 0.1 * off) + off


def trapezoid_weights(t_grid: np.ndarray) -> np.ndarray:
    """trapz(v, t) == w @ v."""
    t = np.asarray(t_grid)
    dt = np.diff(t)
    w = np.zeros(t.shape[0])
    w[:-1] += dt / 2
    w[1:] += dt / 2
    return w


class BlockPoster:
    """Plans rows (and auxiliary variables) for `count` copies of one affine
    cone block `v in K` of dimension `dim`, then posts the coefficients.
    Lowerings: L1 v[0] >= ||v[1:]||_1 via aux w with +-v[1:] <= w,
    sum(w) <= v[0]; LINF v[0] >= max|v[1:]| via +-v[1:] <= v[0]; GEOM
    geomean(v[1:]) >= v[0] (n = dim - 1 terms) via a balanced binary tree
    of sqrt nodes w >= sqrt(a b) <=> [a + b, 2 w, a - b] in SOC(3), the
    leaves padded with v[0] to the next power of two m and the root pinned
    to v[0]: m - 1 SOC(3) blocks and m - 2 aux variables a copy, one
    nonneg row for n = 1. EXP blocks (3-dim) post native
    exponential-cone rows."""

    def __init__(self, name: str, kind: ConeKind, dim: int, count: int,
                 layout: VarLayout, plan: RowPlan):
        self.name = name
        self.kind = kind
        self.dim = int(dim)
        self.count = int(count)
        if kind == ConeKind.ZERO:
            plan.zero(name, count * dim)
        elif kind == ConeKind.NONPOS:
            plan.nonneg(name, count * dim)
        elif kind == ConeKind.SOC:
            plan.soc(name, count, dim)
        elif kind == ConeKind.L1:
            layout.add(name + "_aux", count, dim - 1)
            plan.nonneg(name + "_lo", count * (dim - 1))
            plan.nonneg(name + "_hi", count * (dim - 1))
            plan.nonneg(name + "_sum", count)
        elif kind == ConeKind.LINF:
            plan.nonneg(name + "_lo", count * (dim - 1))
            plan.nonneg(name + "_hi", count * (dim - 1))
        elif kind == ConeKind.GEOM:
            n_leaf = dim - 1
            assert n_leaf >= 1
            self._geom_tree = None
            if n_leaf == 1:
                plan.nonneg(name, count)              # t <= x_1
            else:
                m_leaf = 1 << (n_leaf - 1).bit_length()
                level = ([("res", i + 1) for i in range(n_leaf)]
                         + [("res", 0)] * (m_leaf - n_leaf))
                aux = 0
                pairs = []
                while len(level) > 2:
                    nxt = []
                    for a, b in zip(level[0::2], level[1::2]):
                        pairs.append((a, b, ("aux", aux)))
                        nxt.append(("aux", aux))
                        aux += 1
                    level = nxt
                pairs.append((level[0], level[1], ("res", 0)))
                self._geom_tree = pairs
                self._geom_naux = aux
                if aux:
                    layout.add(name + "_aux", count, aux)
                plan.soc(name, count * len(pairs), 3)
        elif kind == ConeKind.EXP:
            assert dim == 3, f"EXP cone blocks are 3-dim, got {dim}"
            plan.exp(name, count)
        else:
            raise NotImplementedError(f"cone kind {kind}")

    def post(self, asm: Assembler, plan: RowPlan, layout: VarLayout,
             cols: np.ndarray, J, v0) -> None:
        """cols (count, nc) static; J (B, count, dim, nc) and v0
        (B, count, dim) (the scenario dim optional) of v = J d[cols] + v0."""
        name, count, dim = self.name, self.count, self.dim
        kind = self.kind
        if kind in (ConeKind.ZERO, ConeKind.NONPOS):
            rows = plan.rows(name).reshape(count, dim)
            asm.add_A(rows, cols, J)
            asm.add_b(rows, -v0)
        elif kind == ConeKind.SOC:
            asm.res_soc(plan.rows(name), cols, J, v0)
        elif kind == ConeKind.EXP:
            asm.res_exp(plan.rows(name), cols, J, v0)
        elif kind == ConeKind.L1:
            aux = layout.idx(name + "_aux")
            d1 = dim - 1
            eye = torch.eye(d1, dtype=J.dtype, device=J.device).expand(
                count, d1, d1)
            lo = plan.rows(name + "_lo").reshape(count, d1)
            asm.add_A(lo, cols, J[..., 1:, :])
            asm.add_A(lo, aux, -eye)
            asm.add_b(lo, -v0[..., 1:])
            hi = plan.rows(name + "_hi").reshape(count, d1)
            asm.add_A(hi, cols, -J[..., 1:, :])
            asm.add_A(hi, aux, -eye)
            asm.add_b(hi, v0[..., 1:])
            sm = plan.rows(name + "_sum").reshape(count, 1)
            asm.add_A(sm, cols, -J[..., 0:1, :])
            asm.add_A(sm, aux, torch.ones(count, 1, d1, dtype=J.dtype,
                                          device=J.device))
            asm.add_b(sm, v0[..., 0:1])
        elif kind == ConeKind.LINF:
            d1 = dim - 1
            lo = plan.rows(name + "_lo").reshape(count, d1)
            asm.add_A(lo, cols, J[..., 1:, :] - J[..., 0:1, :])
            asm.add_b(lo, -(v0[..., 1:] - v0[..., 0:1]))
            hi = plan.rows(name + "_hi").reshape(count, d1)
            asm.add_A(hi, cols, -J[..., 1:, :] - J[..., 0:1, :])
            asm.add_b(hi, v0[..., 1:] + v0[..., 0:1])
        elif kind == ConeKind.GEOM:
            self._post_geom(asm, plan, layout, cols, J, v0)

    def _post_geom(self, asm, plan, layout, cols, J, v0) -> None:
        name, count = self.name, self.count
        if self._geom_tree is None:
            # n = 1: x_1 - t >= 0, a nonneg row
            rows = plan.rows(name).reshape(count, 1)
            asm.add_A(rows, cols, J[..., 0:1, :] - J[..., 1:2, :])
            asm.add_b(rows, v0[..., 1:2] - v0[..., 0:1])
            return
        # node (a, b, w) posts [val(a) + val(b), 2 val(w), val(a) - val(b)]
        naux = self._geom_naux
        nc = cols.shape[1]
        aux_cols = (layout.idx(name + "_aux").reshape(count, naux) if naux
                    else np.zeros((count, 0), np.int64))
        all_cols = np.concatenate([np.asarray(cols), aux_cols], axis=1)
        Jx = torch.cat([J, J.new_zeros(J.shape[:-1] + (naux,))], dim=-1)

        def val(entry):
            """(J row (..., count, nc + naux), v0 (..., count)) of a node."""
            tag, i = entry
            if tag == "res":
                return Jx[..., i, :], v0[..., i]
            row = Jx.new_zeros(Jx.shape[:-2] + (nc + naux,))
            row[..., nc + i] = 1.0
            return row, v0.new_zeros(v0.shape[:-1])

        Jrows, v0rows = [], []
        for a, b, w in self._geom_tree:
            (Ja, va), (Jb, vb), (Jw, vw) = val(a), val(b), val(w)
            Jrows.append(torch.stack([Ja + Jb, 2.0 * Jw, Ja - Jb], dim=-2))
            v0rows.append(torch.stack([va + vb, 2.0 * vw, va - vb], dim=-1))
        n_pairs = len(self._geom_tree)
        Jt = torch.stack(Jrows, dim=-3)
        Jt = Jt.reshape(Jt.shape[:-4] + (count * n_pairs, 3, Jt.shape[-1]))
        v0t = torch.stack(v0rows, dim=-2)
        v0t = v0t.reshape(v0t.shape[:-3] + (count * n_pairs, 3))
        colt = np.broadcast_to(all_cols[:, None, :],
                               (count, n_pairs, all_cols.shape[1])
                               ).reshape(count * n_pairs, -1)
        asm.res_soc(plan.rows(name).reshape(count * n_pairs, 3), colt, Jt,
                    v0t)


def post_quadratic_epigraphs(asm: Assembler, rows: np.ndarray,
                             d_cols: np.ndarray, t_cols: np.ndarray,
                             H, g, c0, d0) -> None:
    """Epigraphs t_i >= 0.5 (d-d0)'H(d-d0) + g'(d-d0) + c0 as SOC blocks of
    dim dv+2: rows (count, dv+2); d_cols (count, dv); t_cols (count,);
    H (B, count, dv, dv) psd; g, d0 (B, count, dv); c0 (B, count)."""
    count, dv = np.asarray(d_cols).shape
    if dv == 1:
        # the eigendecomposition of a 1x1 block is the block itself
        Lt = torch.sqrt(torch.clamp(H, min=0.0))
    else:
        w, V = torch.linalg.eigh(H)
        Lt = torch.sqrt(torch.clamp(w, min=0.0))[..., :, None] * V.transpose(
            -1, -2)
    lin_g = g - torch.einsum("...kij,...kj->...ki", H, d0)
    lin_c = (c0 + 0.5 * torch.einsum("...ki,...kij,...kj->...k", d0, H, d0)
             - torch.einsum("...ki,...ki->...k", g, d0))
    one = torch.ones_like(lin_c)[..., None]
    J = torch.cat([
        torch.cat([-lin_g, one], -1)[..., None, :],
        torch.cat([-lin_g, one], -1)[..., None, :],
        torch.cat([Lt, torch.zeros_like(Lt[..., :1])], -1)], -2)
    v0 = torch.cat([(-lin_c + 0.5)[..., None], (-lin_c - 0.5)[..., None],
                    torch.zeros_like(lin_g)], -1)
    cols = np.concatenate([np.asarray(d_cols),
                           np.asarray(t_cols).reshape(count, 1)], axis=1)
    asm.res_soc(rows, cols, J, v0)


class CoreStructure(NamedTuple):
    X_kinds: Tuple[ConeKind, ...]
    X_dims: Tuple[int, ...]
    U_kinds: Tuple[ConeKind, ...]
    U_dims: Tuple[int, ...]
    ns: int
    n_ic: int
    n_tc: int
    has_term: bool
    has_run: bool


def _cone_structure(cons):
    return (tuple(c.kind for c in cons),
            tuple(int(np.prod(c.v.shape)) for c in cons))


def _stack_residuals(fn, *args):
    return torch.cat([c.v.reshape(-1) for c in fn(*args)])


class SCPTemplate:
    """Static subproblem structure + batched core assembly for one
    TrajectoryProblem at grid size N, in one dtype on one device.
    soft_X (GuSTO) relaxes the state set X with indicator variables;
    vs_nonneg=False drops the vs >= 0 rows, so that vs tracks the raw
    linearized s (GuSTO's softplus penalty)."""

    def __init__(self, pbm: TrajectoryProblem, N: int, t_grid: np.ndarray, *,
                 dtype, device, relax_dynamics: bool = True,
                 relax_bcs: bool = True, soft_X: bool = False,
                 vs_nonneg: bool = True):
        self.pbm = pbm
        self.soft_X = bool(soft_X) and pbm.X is not None
        self.vs_nonneg = bool(vs_nonneg)
        self.N = int(N)
        self.t_np = np.asarray(t_grid, dtype=np.float64)
        self.w_trapz = trapezoid_weights(self.t_np)
        self.relax_dynamics = relax_dynamics
        self.relax_bcs = relax_bcs
        self.dtype = dtype
        self.device = torch.device(device)
        nx, nu, npp = pbm.nx, pbm.nu, pbm.np
        self.nv = nx
        T = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype,
                                      device=self.device)
        self.ts = T(self.t_np)

        xg, ug, pg = bind_consts(pbm.guess, pbm.consts)(N)
        xg, ug, pg = T(xg), T(ug), T(pg)
        t0 = self.ts[0]
        k0 = torch.zeros((), dtype=torch.int64, device=self.device)
        c0_ = pbm.consts
        X0, U0, s0 = (bind_consts(pbm.X, c0_), bind_consts(pbm.U, c0_),
                      bind_consts(pbm.s, c0_))
        gic0, gtc0 = bind_consts(pbm.gic, c0_), bind_consts(pbm.gtc, c0_)
        Xk, Xd = _cone_structure(X0(t0, k0, xg[0], pg)) if pbm.X else ((), ())
        Uk, Ud = _cone_structure(U0(t0, k0, ug[0], pg)) if pbm.U else ((), ())
        ns = int(s0(t0, k0, xg[0], ug[0], pg).shape[0]) if pbm.s else 0
        n_ic = int(gic0(xg[0], pg).shape[0]) if pbm.gic else 0
        n_tc = int(gtc0(xg[-1], pg).shape[0]) if pbm.gtc else 0
        self.struct = CoreStructure(
            X_kinds=Xk, X_dims=Xd, U_kinds=Uk, U_dims=Ud, ns=ns, n_ic=n_ic,
            n_tc=n_tc, has_term=pbm.terminal_cost is not None,
            has_run=pbm.running_cost is not None)

        lay = VarLayout()
        plan = RowPlan()
        lay.add("x", N, nx)
        lay.add("u", N, nu)
        if npp > 0:
            lay.add("p", npp)
        plan.zero("dyn", (N - 1) * nx)
        if relax_dynamics:
            lay.add("vd", N - 1, self.nv)
            lay.add("wvd", N - 1, nx)
            plan.nonneg("wvd_lo", (N - 1) * nx)
            plan.nonneg("wvd_hi", (N - 1) * nx)
        if n_ic:
            plan.zero("ic", n_ic)
            if relax_bcs:
                lay.add("vic_pos", n_ic)
                lay.add("vic_neg", n_ic)
                plan.nonneg("vic_pos_nn", n_ic)
                plan.nonneg("vic_neg_nn", n_ic)
        if n_tc:
            plan.zero("tc", n_tc)
            if relax_bcs:
                lay.add("vtc_pos", n_tc)
                lay.add("vtc_neg", n_tc)
                plan.nonneg("vtc_pos_nn", n_tc)
                plan.nonneg("vtc_neg_nn", n_tc)
        if ns:
            lay.add("vs", N, ns)
            plan.nonneg("ncvx", N * ns)
            if self.vs_nonneg:
                plan.nonneg("vs_nn", N * ns)
        if not self.soft_X:
            self._X_posters = [BlockPoster(f"X{i}", k, d, N, lay, plan)
                               for i, (k, d) in enumerate(zip(Xk, Xd))]
        else:
            # per-cone indicator variables q, q <= 0 iff the residual is in
            # its cone (reference problem.jl:686-807): ZERO / NONPOS get a
            # vector q (z - q <= 0, plus -z - q <= 0 for ZERO); the norm
            # cones a scalar q shifting the epigraph head ((t + q, x) in K);
            # EXP a scalar on the third entry ((x, y, w + q) in K_exp)
            self._X_posters = []
            self.n_qX = 0   # indicator slots per node
            for i, (k, d) in enumerate(zip(Xk, Xd)):
                if k == ConeKind.NONPOS:
                    lay.add(f"qX{i}", N, d)
                    posters = (BlockPoster(f"X{i}", ConeKind.NONPOS, d, N,
                                           lay, plan),)
                    self.n_qX += d
                elif k == ConeKind.ZERO:
                    lay.add(f"qX{i}", N, d)
                    posters = tuple(BlockPoster(f"X{i}{h}", ConeKind.NONPOS,
                                                d, N, lay, plan)
                                    for h in "ab")
                    self.n_qX += d
                elif k in (ConeKind.SOC, ConeKind.L1, ConeKind.LINF,
                           ConeKind.EXP):
                    lay.add(f"qX{i}", N)
                    posters = (BlockPoster(f"X{i}", k, d, N, lay, plan),)
                    self.n_qX += 1
                else:
                    raise NotImplementedError(
                        f"soft state-set relaxation for cone {k}")
                self._X_posters.append(posters)
        self._U_posters = [BlockPoster(f"U{i}", k, d, N, lay, plan)
                           for i, (k, d) in enumerate(zip(Uk, Ud))]

        # structurally-linear costs go straight into c; quadratic ones get
        # an epigraph SOC sliced to the static support of (g, H), probed at
        # the construction consts and at perturbed ones
        self.run_linear = False
        self.term_linear = False
        rng = np.random.default_rng(0)
        consts_variants = [c0_, _perturb_consts(c0_, rng)]
        if self.struct.has_run:
            nd_run = nx + nu + npp
            sup = np.zeros(nd_run, bool)
            h_any = False
            d_base = np.concatenate(
                [np.asarray(xg.cpu()), np.asarray(ug.cpu())]
                + ([np.broadcast_to(np.asarray(pg.cpu()), (N, npp))]
                   if npp > 0 else []), axis=1)
            ks = torch.arange(N, device=self.device)
            for cv in consts_variants:
                run0 = bind_consts(pbm.running_cost, cv)

                def scl(vec, t, k, run0=run0):
                    pp = vec[nx + nu:] if npp > 0 else pg
                    return run0(t, k, vec[:nx], vec[nx:nx + nu], pp)

                gh = vmap(lambda t, k, d0: (grad(scl)(d0, t, k),
                                            hessian(scl)(d0, t, k)))
                for trial in range(3):
                    pert = (0.0 if trial == 0
                            else 0.3 * rng.standard_normal(d_base.shape))
                    gs, Hs = gh(self.ts, ks, T(d_base + pert))
                    gs = gs.cpu().numpy()
                    Hs = Hs.cpu().numpy()
                    h_any = h_any or np.max(np.abs(Hs)) != 0.0
                    sup |= np.any(gs != 0.0, axis=0)
                    sup |= np.any(Hs != 0.0, axis=(0, 1))
                    sup |= np.any(Hs != 0.0, axis=(0, 2))
            self.run_linear = not h_any
            self.run_support = np.flatnonzero(sup)
        if self.struct.has_term:
            nd_term = nx + npp
            sup = np.zeros(nd_term, bool)
            h_any = False
            d_base = np.concatenate([np.asarray(xg[-1].cpu())]
                                    + ([np.asarray(pg.cpu())]
                                       if npp > 0 else []))
            for cv in consts_variants:
                term0 = bind_consts(pbm.terminal_cost, cv)

                def sclt(vec, term0=term0):
                    return term0(vec[:nx], vec[nx:] if npp > 0 else pg)

                for trial in range(3):
                    pert = (0.0 if trial == 0
                            else 0.3 * rng.standard_normal(nd_term))
                    d = T(d_base + pert)
                    gt = grad(sclt)(d).cpu().numpy()
                    Ht = hessian(sclt)(d).cpu().numpy()
                    h_any = h_any or np.max(np.abs(Ht)) != 0.0
                    sup |= gt != 0.0
                    sup |= np.any(Ht != 0.0, axis=0)
                    sup |= np.any(Ht != 0.0, axis=1)
            self.term_linear = not h_any
            self.term_support = np.flatnonzero(sup)

        if self.struct.has_run and not self.run_linear:
            lay.add("t_run", N)
            plan.soc("run_epi", N, len(self.run_support) + 2)
        if self.struct.has_term and not self.term_linear:
            lay.add("t_term")
            plan.soc("term_epi", 1, len(self.term_support) + 2)
        self.layout = lay
        self.plan = plan

    def freeze(self) -> ConeSpec:
        """Freeze the row plan (after the algorithm added its rows)."""
        self.spec = self.plan.freeze()
        self.m = self.plan.m
        self.n = self.layout.n
        return self.spec

    def scaling_vectors(self, sc: Scaling):
        """(S_full, c_full) (n,): physical d = S_full * d_hat + c_full."""
        S = torch.ones(self.n, dtype=self.dtype, device=self.device)
        c = torch.zeros(self.n, dtype=self.dtype, device=self.device)
        lay = self.layout
        N = self.N
        S[lay.sl("x")] = sc.Sx.repeat(N)
        c[lay.sl("x")] = sc.cx.repeat(N)
        S[lay.sl("u")] = sc.Su.repeat(N)
        c[lay.sl("u")] = sc.cu.repeat(N)
        if self.pbm.np > 0:
            S[lay.sl("p")] = sc.Sp
            c[lay.sl("p")] = sc.cp
        return S, c

    def extract(self, d):
        """(x (B, N, nx), u (B, N, nu), p (B, np)) from physical d (B, n)."""
        lay = self.layout
        Bn = d.shape[0]
        x = d[:, lay.sl("x")].reshape(Bn, self.N, self.pbm.nx)
        u = d[:, lay.sl("u")].reshape(Bn, self.N, self.pbm.nu)
        p = d[:, lay.sl("p")] if self.pbm.np > 0 else d[:, :0]
        return x, u, p

    def _nodes(self, Bn):
        """(t, k) for every (scenario, node), flattened (B*N,)."""
        ks = torch.arange(self.N, device=self.device)
        return self.ts.repeat(Bn), ks.repeat(Bn)

    def assemble_core(self, asm: Assembler, ref_x, ref_u, ref_p, dltv,
                      consts=None) -> None:
        """Post dynamics, convex X/U, linearized nonconvex s, BC rows,
        slack nonnegativity and the original-cost terms for a batch of
        references ref_x (B, N, nx), ref_u (B, N, nu), ref_p (B, np) and
        their DLTV."""
        pbm, lay, plan = self.pbm, self.layout, self.plan
        if consts is None:
            consts = pbm.consts
        X_fn = bind_consts(pbm.X, consts)
        U_fn = bind_consts(pbm.U, consts)
        s_fn = bind_consts(pbm.s, consts)
        gic_fn = bind_consts(pbm.gic, consts)
        gtc_fn = bind_consts(pbm.gtc, consts)
        run_fn = bind_consts(pbm.running_cost, consts)
        term_fn = bind_consts(pbm.terminal_cost, consts)
        N, nx, nu, npp = self.N, pbm.nx, pbm.nu, pbm.np
        Bn = ref_x.shape[0]
        dt, dev = self.dtype, self.device
        t_flat, k_flat = self._nodes(Bn)
        p_flat = ref_p.repeat_interleave(N, dim=0)
        nodes = lambda v: v.reshape((Bn, N) + v.shape[1:])
        x_idx = lay.idx("x")
        u_idx = lay.idx("u")
        p_idx = lay.idx("p").reshape(-1) if npp > 0 else np.zeros(0, np.int64)
        eye_nx = torch.eye(nx, dtype=dt, device=dev)

        # ---- dynamics: x_{k+1} = A x_k + Bm u_k + Bp u_{k+1} + F p + r + E vd
        rows = plan.rows("dyn").reshape(N - 1, nx)
        asm.add_A(rows, x_idx[1:], eye_nx.expand(N - 1, nx, nx))
        asm.add_A(rows, x_idx[:-1], -dltv.A)
        asm.add_A(rows, u_idx[:-1], -dltv.Bm)
        asm.add_A(rows, u_idx[1:], -dltv.Bp)
        if npp > 0:
            asm.add_A(rows, np.broadcast_to(p_idx, (N - 1, npp)), -dltv.F)
        if self.relax_dynamics:
            asm.add_A(rows, lay.idx("vd"), -dltv.E)
            wvd_idx = lay.idx("wvd")
            neg_eye = (-eye_nx).expand(N - 1, nx, nx)
            lo = plan.rows("wvd_lo").reshape(N - 1, nx)
            asm.add_A(lo, lay.idx("vd"), dltv.E)
            asm.add_A(lo, wvd_idx, neg_eye)
            hi = plan.rows("wvd_hi").reshape(N - 1, nx)
            asm.add_A(hi, lay.idx("vd"), -dltv.E)
            asm.add_A(hi, wvd_idx, neg_eye)
        asm.add_b(rows, dltv.r)

        # ---- convex state/input sets ----
        def affine_sets(fn, z_ref, z_idx):
            nzz = z_ref.shape[2]
            z_flat = z_ref.reshape(Bn * N, nzz)

            def stacked(t, k, z, p):
                return _stack_residuals(fn, t, k, z, p)

            vals = vmap(stacked)(t_flat, k_flat, z_flat, p_flat)
            Jz, Jp = (j.to(dt) for j in vmap(jacfwd(stacked, argnums=(2, 3)))(
                t_flat, k_flat, z_flat, p_flat))
            J = torch.cat([Jz, Jp], dim=2) if npp > 0 else Jz
            cat = torch.cat([z_flat, p_flat], 1) if npp > 0 else z_flat
            v0 = vals - (J @ cat[:, :, None])[..., 0]
            J, v0 = nodes(J), nodes(v0)
            cols = (np.concatenate([z_idx, np.broadcast_to(p_idx, (N, npp))],
                                   axis=1) if npp > 0 else z_idx)
            return cols, J, v0

        def post_sets(fn, posters, z_ref, z_idx):
            if not posters:
                return
            cols, J, v0 = affine_sets(fn, z_ref, z_idx)
            off = 0
            for po in posters:
                po.post(asm, plan, lay, cols, J[..., off:off + po.dim, :],
                        v0[..., off:off + po.dim])
                off += po.dim

        def post_sets_soft(fn, z_ref, z_idx):
            """The state set with its indicator columns (reference
            problem.jl:706-807)."""
            cols, J, v0 = affine_sets(fn, z_ref, z_idx)
            off = 0
            for i, (kind, d) in enumerate(zip(self.struct.X_kinds,
                                              self.struct.X_dims)):
                cols_q = np.concatenate(
                    [cols, lay.idx(f"qX{i}").reshape(N, -1)], axis=1)
                Ji = J[..., off:off + d, :]
                v0i = v0[..., off:off + d]
                if kind in (ConeKind.NONPOS, ConeKind.ZERO):
                    eye = (-torch.eye(d, dtype=dt, device=dev)).expand(
                        Bn, N, d, d)
                    po = self._X_posters[i]
                    po[0].post(asm, plan, lay, cols_q,
                               torch.cat([Ji, eye], -1), v0i)
                    if kind == ConeKind.ZERO:
                        po[1].post(asm, plan, lay, cols_q,
                                   torch.cat([-Ji, eye], -1), -v0i)
                else:
                    # the indicator shifts the head (SOC / L1 / LINF) or
                    # the third entry (EXP)
                    e = torch.zeros(Bn, N, d, 1, dtype=dt, device=dev)
                    e[:, :, 2 if kind == ConeKind.EXP else 0, 0] = 1.0
                    self._X_posters[i][0].post(
                        asm, plan, lay, cols_q, torch.cat([Ji, e], -1), v0i)
                off += d

        if pbm.X:
            if self.soft_X:
                post_sets_soft(X_fn, ref_x, x_idx)
            else:
                post_sets(X_fn, self._X_posters, ref_x, x_idx)
        if pbm.U:
            post_sets(U_fn, self._U_posters, ref_u, u_idx)

        # ---- nonconvex path constraints: s_lin <= vs, vs >= 0 ----
        if self.struct.ns:
            ns = self.struct.ns
            xf = ref_x.reshape(Bn * N, nx)
            uf = ref_u.reshape(Bn * N, nu)
            sval = vmap(s_fn)(t_flat, k_flat, xf, uf, p_flat)
            C, D, G = (j.to(dt) for j in vmap(jacfwd(
                s_fn, argnums=(2, 3, 4)))(t_flat, k_flat, xf, uf, p_flat))
            rows = plan.rows("ncvx").reshape(N, ns)
            asm.add_A(rows, x_idx, nodes(C))
            asm.add_A(rows, u_idx, nodes(D))
            if npp > 0:
                asm.add_A(rows, np.broadcast_to(p_idx, (N, npp)), nodes(G))
            vs_idx = lay.idx("vs")
            asm.add_A(rows, vs_idx, (-torch.eye(ns, dtype=dt, device=dev)
                                     ).expand(N, ns, ns))
            v0 = (sval - (C @ xf[:, :, None])[..., 0]
                  - (D @ uf[:, :, None])[..., 0])
            if npp > 0:
                v0 = v0 - (G @ p_flat[:, :, None])[..., 0]
            asm.add_b(rows, -nodes(v0))
            if self.vs_nonneg:
                asm.add_A(plan.rows("vs_nn"), vs_idx.reshape(-1),
                          -torch.eye(N * ns, dtype=dt, device=dev))

        # ---- boundary conditions (linearized, relaxed) ----
        def post_bc(g_fn, x_node, x_cols, name, vname):
            n_g = self.struct.n_ic if name == "ic" else self.struct.n_tc
            g_ref = vmap(g_fn)(x_node, ref_p)
            Hj, Kj = (j.to(dt) for j in vmap(jacfwd(g_fn, argnums=(0, 1)))(
                x_node, ref_p))
            rows = plan.rows(name)
            asm.add_A(rows, x_cols, Hj)
            if npp > 0:
                asm.add_A(rows, p_idx, Kj)
            v0 = g_ref - (Hj @ x_node[:, :, None])[..., 0]
            if npp > 0:
                v0 = v0 - (Kj @ ref_p[:, :, None])[..., 0]
            if self.relax_bcs:
                eye = torch.eye(n_g, dtype=dt, device=dev)
                asm.add_A(rows, lay.idx(vname + "_pos").reshape(-1), eye)
                asm.add_A(rows, lay.idx(vname + "_neg").reshape(-1), -eye)
                for sfx in ("_pos", "_neg"):
                    asm.add_A(plan.rows(vname + sfx + "_nn"),
                              lay.idx(vname + sfx).reshape(-1), -eye)
            asm.add_b(rows, -v0)

        if self.struct.n_ic:
            post_bc(gic_fn, ref_x[:, 0], x_idx[0], "ic", "vic")
        if self.struct.n_tc:
            post_bc(gtc_fn, ref_x[:, -1], x_idx[-1], "tc", "vtc")

        # ---- original cost ----
        if self.struct.has_run:
            w = torch.as_tensor(self.w_trapz, dtype=dt, device=dev)
            d_cols = (np.concatenate(
                [x_idx, u_idx, np.broadcast_to(p_idx, (N, npp))], axis=1)
                if npp > 0 else np.concatenate([x_idx, u_idx], axis=1))
            d_flat = torch.cat([ref_x.reshape(Bn * N, nx),
                                ref_u.reshape(Bn * N, nu)]
                               + ([p_flat] if npp > 0 else []), dim=1)

            def run_of(vec, t, k, p):
                pp = vec[nx + nu:] if npp > 0 else p
                return run_fn(t, k, vec[:nx], vec[nx:nx + nu], pp)

            if self.run_linear:
                c0 = vmap(run_of)(d_flat, t_flat, k_flat, p_flat)
                g = vmap(grad(run_of))(d_flat, t_flat, k_flat,
                                       p_flat).to(dt)
                asm.add_c(d_cols, w[:, None] * nodes(g))
                asm.add_const(torch.sum(
                    w * nodes(c0 - torch.sum(g * d_flat, dim=1)), dim=1))
            else:
                sup = self.run_support
                nsup = len(sup)
                sel = torch.zeros(d_flat.shape[1], nsup, dtype=dt,
                                  device=dev)
                sel[torch.as_tensor(sup, device=dev),
                    torch.arange(nsup, device=dev)] = 1.0
                keep = 1.0 - sel.sum(dim=1)

                def run_s(vec_s, d_full, t, k, p):
                    return run_of(d_full * keep + sel @ vec_s, t, k, p)

                d0s = d_flat[:, torch.as_tensor(sup, device=dev)]
                args = (d0s, d_flat, t_flat, k_flat, p_flat)
                c0 = vmap(run_s)(*args)
                g = vmap(grad(run_s))(*args).to(dt)
                H = vmap(hessian(run_s))(*args).to(dt)
                post_quadratic_epigraphs(
                    asm, plan.rows("run_epi"), d_cols[:, sup],
                    lay.idx("t_run").reshape(-1), nodes(H), nodes(g),
                    nodes(c0), nodes(d0s))
                asm.add_c(lay.idx("t_run"), w)
        if self.struct.has_term:
            d_cols = (np.concatenate([x_idx[-1], p_idx]) if npp > 0
                      else x_idx[-1])
            d_full = torch.cat([ref_x[:, -1]] + ([ref_p] if npp > 0 else []),
                               dim=1)

            def term_of(vec, p):
                return term_fn(vec[:nx], vec[nx:] if npp > 0 else p)

            if self.term_linear:
                c0 = vmap(term_of)(d_full, ref_p)
                g = vmap(grad(term_of))(d_full, ref_p).to(dt)
                asm.add_c(d_cols, g)
                asm.add_const(c0 - torch.sum(g * d_full, dim=1))
            else:
                sup = self.term_support
                nsup = len(sup)
                sel = torch.zeros(d_full.shape[1], nsup, dtype=dt,
                                  device=dev)
                sel[torch.as_tensor(sup, device=dev),
                    torch.arange(nsup, device=dev)] = 1.0
                keep = 1.0 - sel.sum(dim=1)

                def term_s(vec_s, df, p):
                    return term_of(df * keep + sel @ vec_s, p)

                d0 = d_full[:, torch.as_tensor(sup, device=dev)]
                c0 = vmap(term_s)(d0, d_full, ref_p)
                g = vmap(grad(term_s))(d0, d_full, ref_p).to(dt)
                H = vmap(hessian(term_s))(d0, d_full, ref_p).to(dt)
                post_quadratic_epigraphs(
                    asm, plan.rows("term_epi"), d_cols[sup][None, :],
                    lay.idx("t_term").reshape(1), H[:, None], g[:, None],
                    c0[:, None], d0[:, None])
                asm.add_c(lay.idx("t_term").reshape(1),
                          torch.ones(1, dtype=dt, device=dev))

    def X_indicators(self, x, p, consts=None):
        """Numerical indicator values of the soft state set at the nodes of
        x (B, N, nx), p (B, np) -> (B, N, n_qX), one per indicator variable;
        q <= 0 iff the residual lies in its cone (reference cone.jl:275-292:
        v for NONPOS, |v| for ZERO, ||v[1:]|| - v[0] for the norm cones,
        y e^{x/y} - w for EXP, guarded for y <= 0)."""
        assert self.soft_X
        pbm = self.pbm
        X_fn = bind_consts(pbm.X, pbm.consts if consts is None else consts)
        Bn = x.shape[0]
        t_flat, k_flat = self._nodes(Bn)

        def per_node(t, k, xx, pp):
            parts = []
            for c in X_fn(t, k, xx, pp):
                v = c.v.reshape(-1)
                if c.kind == ConeKind.NONPOS:
                    parts.append(v)
                elif c.kind == ConeKind.ZERO:
                    parts.append(torch.abs(v))
                elif c.kind == ConeKind.SOC:
                    parts.append((torch.linalg.vector_norm(v[1:])
                                  - v[0])[None])
                elif c.kind == ConeKind.L1:
                    parts.append((torch.sum(torch.abs(v[1:])) - v[0])[None])
                elif c.kind == ConeKind.LINF:
                    parts.append((torch.amax(torch.abs(v[1:])) - v[0])[None])
                elif c.kind == ConeKind.EXP:
                    xw, yw, ww = v[0], v[1], v[2]
                    ysafe = torch.where(yw > 0, yw, torch.ones_like(yw))
                    parts.append(torch.where(
                        yw > 0, yw * torch.exp(xw / ysafe) - ww,
                        torch.maximum(-ww, -yw))[None])
                else:
                    raise NotImplementedError(c.kind)
            return torch.cat(parts)

        q = vmap(per_node)(t_flat, k_flat, x.reshape(Bn * self.N, -1),
                           p.repeat_interleave(self.N, dim=0))
        return q.reshape(Bn, self.N, -1)

    def original_cost(self, x, u, p, consts=None):
        """J_orig = phi(xf, p) + trapz(Gamma) for x (B, N, nx), u (B, N, nu),
        p (B, np) -> (B,)."""
        pbm = self.pbm
        if consts is None:
            consts = pbm.consts
        run_fn = bind_consts(pbm.running_cost, consts)
        term_fn = bind_consts(pbm.terminal_cost, consts)
        Bn = x.shape[0]
        J = torch.zeros(Bn, dtype=x.dtype, device=x.device)
        if self.struct.has_term:
            J = J + vmap(term_fn)(x[:, -1], p)
        if self.struct.has_run:
            t_flat, k_flat = self._nodes(Bn)
            N = self.N
            vals = vmap(run_fn)(
                t_flat, k_flat, x.reshape(Bn * N, -1), u.reshape(Bn * N, -1),
                p.repeat_interleave(N, dim=0))
            w = torch.as_tensor(self.w_trapz, dtype=x.dtype, device=x.device)
            J = J + vals.reshape(Bn, N) @ w
        return J
