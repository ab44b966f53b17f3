"""Stage-structured augmented KKT factorizations: the stage sweeps and
cyclic reduction.

Counterpart of `scptoolbox_tpu/ops/aug_kkt.py`: `AugStageStructure` (:58,
exp blocks as 3-row units :100-103), `_flat_w2_vectors` (:147), `StagedLU`
(:173-487: the shared block assembly and gather/scatter, the forward stage
sweep and the guarded refinement), `StagedQR` (:490-597), `StagedCR`
(:600-907), `StagedCRPL` (:910-942), `StagedCRQD` (:945-1191),
`probe_aug_structure` (:1208) and the builders (:1194-1269). The
quasidefinite system

    [ eps*I      A'          ] [dx]   [rhs_x]
    [ A       -(W^2 + eps*I) ] [dz] = [rhs_z]

is permuted into stage super-blocks t_k = [x_k; r_k] (block-tridiagonal
with corner couplings C_k plus a dense arrow border) and factored one of
four ways:

* `StagedLU`: the forward stage sweep, one pivoted LU a stage (a Schur
  chain), the raw system, two guarded refinement rounds;
* `StagedQR`: one QR a stage of the (2s, s) band stack, the arrow by a dense
  Schur complement, in NT-scaled duals (the cone block becomes -I), five
  guarded rounds;
* `StagedCR` / `StagedCRPL`: cyclic reduction of the NT-scaled,
  Jacobi-equilibrated system, ceil(log2 N) levels of one batched
  small-block LU over the odd blocks, as the right preconditioner of
  FGMRES(k) with a plain factored solve as guard (per RHS column, the
  smaller residual wins);
* `StagedCRQD`: the same reduction with explicit quasidefinite block
  inverses from two Cholesky factors a block (preconditioner-grade only,
  as in the JAX package).

Every array here carries the scenario batch as its leading dimension
(JAX vmaps the whole class instead), and the JAX `lax.scan` over stages is
a Python loop over batched tensors. The small dense factors run on the
hand-written kernels (plain PyTorch versions on a CPU tensor): the stage
and border LUs of `StagedLU`, the arrow LUs of `StagedQR` / `StagedCRQD`
and the whole of `StagedCRPL` on `ops/lu_kernels.py`; `StagedQR`'s
back-substitution with R_k on `chol_kernels.solve_lower_t(R_k')` and
`StagedCRQD`'s ridge ladder on `chol_kernels.cholesky` / `solve_lower`.
`StagedQR`'s stage QR is `torch.linalg.qr` (XLA's QR in the JAX package,
no kernel of its own), and `StagedCR` keeps the library LU (`ops/linalg.py`,
`torch.linalg.lu_solve`), as the JAX package's keeps XLA's.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from scptoolbox_torch.ops import chol_kernels
from scptoolbox_torch.ops import cones as cn
from scptoolbox_torch.ops import linalg, lu_kernels
from scptoolbox_torch.ops.cones import ConeSpec


class AugStageStructure:
    """Static stage permutation and row classification over all rows of
    one subproblem template (pure numpy; built once per solver)."""

    def __init__(self, layout, N: int, spec: ConeSpec,
                 A_probe: np.ndarray, global_blocks=()):
        self.N = int(N)
        n = layout.n
        self.n = n
        Am = np.asarray(A_probe) != 0.0
        m = Am.shape[0]
        self.m = m

        # column stages: blocks with leading dim N / N-1 are per-node
        col_stage = np.full(n, -1, np.int64)
        for name, (off, shape) in layout._blocks.items():
            if (shape and shape[0] in (N, N - 1)
                    and name not in global_blocks):
                d = int(np.prod(shape[1:])) if len(shape) > 1 else 1
                for k in range(shape[0]):
                    col_stage[off + k * d: off + (k + 1) * d] = k
        stage_cols = [np.flatnonzero(col_stage == k) for k in range(N)]
        g_cols = np.flatnonzero(col_stage < 0)
        self.ns = max(len(s) for s in stage_cols)
        self.ng = len(g_cols)
        self.g_cols = g_cols
        scols = np.full((N, self.ns), n, np.int64)     # phantom col n
        for k, s in enumerate(stage_cols):
            scols[k, : len(s)] = s
        self.scols = scols
        self.scols_next = np.concatenate(
            [scols[1:], np.full((1, self.ns), n, np.int64)], axis=0)
        self.col_pad = (scols == n)

        # row units: zero and nonneg rows singly, SOC and exp blocks whole
        # (cone units never straddle stages)
        units = [np.asarray([i]) for i in range(spec.nz + spec.nl)]
        off = spec.nz + spec.nl
        for d in spec.socs:
            units.append(np.arange(off, off + d))
            off += d
        for _ in range(spec.nexp):
            units.append(np.arange(off, off + 3))
            off += 3
        assert off == m, (off, m)

        stage_rows = [[] for _ in range(N)]
        global_rows = []
        for u in units:
            cols = np.flatnonzero(Am[u].any(axis=0))
            stages = np.unique(col_stage[cols])
            stages = stages[stages >= 0]
            if len(stages) == 0:
                global_rows.extend(u.tolist())
            elif len(stages) == 1:
                stage_rows[int(stages[0])].extend(u.tolist())
            elif len(stages) == 2 and stages[1] == stages[0] + 1:
                stage_rows[int(stages[0])].extend(u.tolist())
            else:
                raise ValueError(
                    f"row unit spans non-adjacent stages {stages}; "
                    "dense KKT required")
        self.rmax = max(max((len(r) for r in stage_rows), default=0), 1)
        rows_pad = np.full((N, self.rmax), m, np.int64)  # phantom row m
        for k, r in enumerate(stage_rows):
            rows_pad[k, : len(r)] = r
        self.rows_pad = rows_pad
        self.row_pad = (rows_pad == m)
        self.global_rows = np.asarray(global_rows, np.int64)
        self.mg = len(global_rows)

        # W^2 metadata: W^2[i,j] = u_i u_j [same cone block] + d_i delta_ij;
        # exp rows keep -2 (only the NT-scaled sweeps take exp blocks, and
        # there the whole cone block is -I)
        blk = np.full(m + 1, -2, np.int64)
        blk[: spec.nz] = -1
        nid = 0
        for i in range(spec.nz, spec.nz + spec.nl):
            blk[i] = nid
            nid += 1
        off = spec.nz + spec.nl
        for d in spec.socs:
            blk[off: off + d] = nid
            nid += 1
            off += d
        self.blk_stage = blk[rows_pad]
        self.blk_global = blk[self.global_rows]
        self._dev = {}

    def on(self, device):
        """The index arrays as tensors on `device` (cached)."""
        device = torch.device(device)
        t = self._dev.get(device)
        if t is None:
            T = lambda a: torch.as_tensor(np.asarray(a), device=device)
            bid = self.blk_stage
            same = (bid[:, :, None] == bid[:, None, :]) & (bid[:, :, None]
                                                          >= 0)
            bg = self.blk_global
            same_g = (bg[:, None] == bg[None, :]) & (bg[:, None] >= 0)
            t = dict(scols=T(self.scols), scols_next=T(self.scols_next),
                     rows=T(self.rows_pad), g_cols=T(self.g_cols),
                     global_rows=T(self.global_rows),
                     col_pad=T(self.col_pad), row_pad=T(self.row_pad),
                     same=T(same), same_g=T(same_g))
            self._dev[device] = t
        return t


def _flat_w2_vectors(spec: ConeSpec, W, m: int, Bn: int, dtype, device,
                     cone_mask):
    """Flat (u, d) (B, m) with W^2 = u u' (within cone blocks) + diag(d);
    zero on zero-cone rows. W=None gives W^2 = diag(cone_mask).

    Exp blocks have a dense 3x3 W^2 (BFGS scaling), which is not rank-1 +
    diag: only the NT-scaled sweeps (scale_rows=True, which call this with
    W=None) take exp cones; the raw StagedLU does not."""
    if W is None:
        return (torch.zeros(Bn, m, dtype=dtype, device=device),
                cone_mask.expand(Bn, m).to(dtype))
    assert spec.nexp == 0, (
        "exp cones require the NT-scaled sweep (StagedQR/StagedCR)")
    u = torch.zeros(Bn, m, dtype=dtype, device=device)
    d = torch.zeros(Bn, m, dtype=dtype, device=device)
    if spec.nl > 0:
        d[:, spec.lin_slice] = W.w_l ** 2
    groups = dict(cn.soc_idx(spec, device))
    for (eta, wbar), dim in zip(W.socs, W.soc_dims):
        idx = groups[dim]
        eta2 = eta ** 2
        u[:, idx] = torch.sqrt(2.0 * eta2) * wbar
        J = torch.cat([torch.ones(1, dtype=dtype, device=device),
                       -torch.ones(dim - 1, dtype=dtype, device=device)])
        d[:, idx] = -eta2 * J
    return u, d


def _pad1(v, dim):
    """Append one zero entry (the phantom row/column) along `dim`."""
    shape = list(v.shape)
    shape[dim] = 1
    return torch.cat([v, v.new_zeros(shape)], dim=dim)


def _cone_map(spec, W, M, inverse):
    """W (or W^-1) applied to the cone rows of the columns of M
    (B, m, K)."""
    return cn.scale(spec, W, M.transpose(1, 2),
                    inverse=inverse).transpose(1, 2)


class StagedLU:
    """KKT backend for ops.ipm.solve (the dense KKTs' factor/solve contract:
    A (B, m, n), rhs [rhs_x (n); rhs_z (m)] (B, n+m, K)), factoring the
    augmented system by the forward stage sweep: one pivoted LU a stage on
    the hand-written kernels, the arrow border accumulated into one dense
    LU; the solve refines against the unregularized operator."""

    refine_rounds = 2
    # pose the system in NT-scaled duals (dz~ = W dz: the cone rows
    # pre-scaled, A~ = W^-1 A, the cone block exactly -I); the raw LU sweep
    # keeps the unscaled system (the JAX package measured the scaled one
    # worse there)
    scale_rows = False

    def __init__(self, spec: ConeSpec, A, reg_eps, cone_mask,
                 structure: AugStageStructure):
        self.spec, self.A, self.reg_eps = spec, A, reg_eps
        self.cone_mask = cone_mask
        self.st = structure
        self.n, self.m = A.shape[2], A.shape[1]
        assert self.n == structure.n and self.m == structure.m

    # -- shared block assembly --------------------------------------------

    def _effective_system(self, W):
        """(A_eff, W_eff): in NT-scaled mode the cone rows are pre-scaled,
        A~ = W^-1 A, and the cone block collapses to -I (W_eff = None)."""
        if self.scale_rows and W is not None:
            return _cone_map(self.spec, W, self.A, True), None
        return self.A, W

    def _build_blocks(self, A, W):
        """The stage super-blocks of the augmented system at the static
        regularization, as _build_blocks_core gives them."""
        Bn = A.shape[0]
        dt, dev = A.dtype, A.device
        u, d = _flat_w2_vectors(self.spec, W, self.m, Bn, dt, dev,
                                self.cone_mask)
        reg_x = torch.full((Bn, self.n), self.reg_eps, dtype=dt, device=dev)
        reg_z = torch.full((Bn, self.m), self.reg_eps, dtype=dt, device=dev)
        return self._build_blocks_core(A, u, d, reg_x, reg_z)

    def _build_blocks_core(self, A, u, d, reg_x_vec, reg_z_vec):
        """Stage super-blocks T (B, N, s, s), corner couplings
        C (B, N, rmax, ns) (O_k = [[0, 0], [C_k, 0]]), thin arrow columns
        Vt (B, N, s, ng) (V_k = [Vt_k, 0]) and the border block
        D_g (B, nb, nb), from the flat (u, d) W^2 form and per-index
        diagonal regularization (reg_x_vec (B, n) on the x-x block,
        reg_z_vec (B, m) added to the cone block)."""
        st = self.st
        ix = st.on(A.device)
        Bn = A.shape[0]
        dt = A.dtype
        N, ns, rmax, ng, mg = st.N, st.ns, st.rmax, st.ng, st.mg
        nb = ng + mg
        Ap = _pad1(_pad1(A, 1), 2)                     # phantom row/col
        rows = ix["rows"]
        flat = Ap.reshape(Bn, -1)
        width = Ap.shape[2]

        def gather(r, c):
            return flat[:, (r * width + c).reshape(-1)].reshape(
                (Bn,) + tuple(torch.broadcast_shapes(r.shape, c.shape)))

        Bk = gather(rows[:, :, None], ix["scols"][:, None, :])
        C = gather(rows[:, :, None], ix["scols_next"][:, None, :])
        up = _pad1(u, 1)
        dp = _pad1(d, 1)
        ur = up[:, rows]
        dr = dp[:, rows]
        W2blk = (ur[..., :, None] * ur[..., None, :] * ix["same"]
                 + torch.diag_embed(dr))
        one = torch.ones((), dtype=dt, device=A.device)
        reg_x = torch.where(ix["col_pad"], one,
                            _pad1(reg_x_vec, 1)[:, ix["scols"]])
        reg_z = torch.where(ix["row_pad"], one, _pad1(reg_z_vec, 1)[:, rows])
        T = torch.cat([
            torch.cat([torch.diag_embed(reg_x), Bk.transpose(-1, -2)], -1),
            torch.cat([Bk, -(W2blk + torch.diag_embed(reg_z))], -1)], -2)
        if ng:
            Gg = gather(rows[:, :, None], ix["g_cols"][None, None, :])
            Vt = torch.cat([A.new_zeros(Bn, N, ns, ng), Gg], dim=2)
        else:
            Vt = A.new_zeros(Bn, N, ns + rmax, 0)
        D_g = A.new_zeros(Bn, nb, nb)
        if nb:
            if ng:
                gi = torch.arange(ng, device=A.device)
                D_g[:, gi, gi] = reg_x_vec[:, ix["g_cols"]]
            if mg:
                grows = ix["global_rows"]
                ug = u[:, grows]
                W2g = (ug[:, :, None] * ug[:, None, :] * ix["same_g"]
                       + torch.diag_embed(d[:, grows]))
                if ng:
                    Ag = A[:, grows[:, None], ix["g_cols"][None, :]]
                    D_g[:, :ng, ng:] = Ag.transpose(1, 2)
                    D_g[:, ng:, :ng] = Ag
                D_g[:, ng:, ng:] = -(W2g + torch.diag_embed(
                    reg_z_vec[:, grows]))
        return T, C, Vt, D_g

    def _full_couplings(self, C, Vt):
        """The full off-diagonal blocks O (B, N, s, s) and arrow columns
        V (B, N, s, nb) from their thin forms."""
        st = self.st
        ns = st.ns
        Bn, N, s = Vt.shape[0], st.N, ns + st.rmax
        O = C.new_zeros(Bn, N, s, s)
        O[:, :, ns:, :ns] = C
        V = torch.cat([Vt, Vt.new_zeros(Bn, N, s, st.mg)], dim=-1)
        return O, V

    def _gather_rhs(self, rhs):
        """[rhs_x (n); rhs_z (m)] (B, n+m, K) -> stage blocks (B, N, s, K)
        and border (B, nb, K)."""
        st = self.st
        ix = st.on(rhs.device)
        n = self.n
        rx = _pad1(rhs[:, :n], 1)
        rz = _pad1(rhs[:, n:], 1)
        t = torch.cat([rx[:, ix["scols"]], rz[:, ix["rows"]]], dim=2)
        t_g = torch.cat([rhs[:, :n][:, ix["g_cols"]],
                         rhs[:, n:][:, ix["global_rows"]]], dim=1)
        return t, t_g

    def _scatter_sol(self, x, x_g):
        """Inverse of _gather_rhs."""
        st = self.st
        ix = st.on(x.device)
        N, ns, rmax, ng = st.N, st.ns, st.rmax, st.ng
        Bn, K = x.shape[0], x.shape[-1]
        n, m = self.n, self.m
        out_x = x.new_zeros(Bn, n + 1, K)
        out_x[:, ix["scols"].reshape(-1)] = x[:, :, :ns].reshape(
            Bn, N * ns, K)
        out_z = x.new_zeros(Bn, m + 1, K)
        out_z[:, ix["rows"].reshape(-1)] = x[:, :, ns:].reshape(
            Bn, N * rmax, K)
        if ng:
            out_x[:, ix["g_cols"]] = x_g[:, :ng]
        if st.mg:
            out_z[:, ix["global_rows"]] = x_g[:, ng:]
        return torch.cat([out_x[:, :n], out_z[:, :m]], dim=1)

    def _pre_rhs(self, W, rhs):
        """Into the NT-scaled metric: rhs_z -> W^-1 rhs_z on cone rows."""
        if not self.scale_rows or W is None:
            return rhs
        n = self.n
        return torch.cat([rhs[:, :n], _cone_map(self.spec, W, rhs[:, n:],
                                                True)], dim=1)

    # dz = W^-1 dz~ on the way out: same transform as _pre_rhs
    _post_sol = _pre_rhs

    # -- factorization: the forward stage sweep ----------------------------

    def factor(self, W):
        st = self.st
        Bn = self.A.shape[0]
        dt, dev = self.A.dtype, self.A.device
        N, ns, rmax = st.N, st.ns, st.rmax
        s = ns + rmax
        nb = st.ng + st.mg
        A_eff, W_eff = self._effective_system(W)
        T, C, Vt, D_g = self._build_blocks(A_eff, W_eff)
        O, V = self._full_couplings(C, Vt)

        # M_k = T_k - O_{k-1}' E_{k-1} (the Schur chain), Vp_k the arrow
        # columns it carries, Sg the border's accumulated update
        M, Vp = T[:, 0], V[:, 0]
        Sg = D_g.new_zeros(Bn, nb, nb)
        lus, E, F = [], [], []
        for k in range(N):
            O_k = O[:, k]
            lu_k = lu_kernels.lu_factor(M)
            EF = lu_kernels.lu_solve(lu_k, torch.cat([O_k, Vp], dim=-1))
            E_k, F_k = EF[..., :s], EF[..., s:]
            lus.append(lu_k)
            E.append(E_k)
            F.append(F_k)
            if nb:
                Sg = Sg + Vp.transpose(-1, -2) @ F_k
            if k + 1 < N:
                Ot = O_k.transpose(-1, -2)
                M = T[:, k + 1] - Ot @ E_k
                Vp = V[:, k + 1] - Ot @ F_k if nb else V[:, k + 1]
        lu_g = lu_kernels.lu_factor(D_g - Sg) if nb else None
        return (lus, E, F, lu_g, O, A_eff, W_eff, W)

    # -- solves -------------------------------------------------------------

    def _solve_once(self, fac, rhs):
        """One factored solve in the (possibly NT-scaled) system's own
        variables; `solve` handles the metric transforms."""
        lus, E, F, lu_g, O, A_eff, W_eff, W = fac
        st = self.st
        nb = st.ng + st.mg
        t, t_g = self._gather_rhs(rhs)
        N = st.N
        # forward: u_k = t_k - O_{k-1}' y_{k-1}; y_k = M_k^-1 u_k; the
        # border accumulates F_k' u_k (= Vp_k' y_k, M_k symmetric)
        ys = []
        acc = t_g.new_zeros(t_g.shape)
        for k in range(N):
            u_k = t[:, k]
            if k:
                u_k = u_k - O[:, k - 1].transpose(-1, -2) @ ys[-1]
            ys.append(lu_kernels.lu_solve(lus[k], u_k))
            if nb:
                acc = acc + F[k].transpose(-1, -2) @ u_k
        x_g = lu_kernels.lu_solve(lu_g, t_g - acc) if nb else t_g
        # backward: x_k = y_k - E_k x_{k+1} - F_k x_g
        xs = [None] * N
        x_next = None
        for k in range(N - 1, -1, -1):
            x_k = ys[k]
            if x_next is not None:
                x_k = x_k - E[k] @ x_next
            if nb:
                x_k = x_k - F[k] @ x_g
            xs[k] = x_next = x_k
        return self._scatter_sol(torch.stack(xs, dim=1), x_g)

    def _w2z(self, W_eff, z):
        """The cone block's W^2 (or its mask, in NT-scaled mode) applied to
        z (B, m, K)."""
        mask = self.cone_mask[:, None]
        if W_eff is None:
            return z * mask
        return _cone_map(self.spec, W_eff,
                         _cone_map(self.spec, W_eff, z, False), False) * mask

    def solve(self, fac, rhs):
        """Guarded refinement against the unregularized operator, in the
        metric the factor uses: every round keeps, per RHS column, the
        iterate of smaller residual (a sweep's contraction can exceed one
        along worst-case modes at extreme late-IPM scalings)."""
        A_eff, W_eff, W = fac[-3], fac[-2], fac[-1]
        n = self.n
        rhs = self._pre_rhs(W, rhs)
        At = A_eff.transpose(1, 2)

        def residual(sol):
            return rhs - torch.cat(
                [At @ sol[:, n:], A_eff @ sol[:, :n]
                 - self._w2z(W_eff, sol[:, n:])], dim=1)

        best = self._solve_once(fac, rhs)
        best_res = residual(best)
        best_nrm = torch.linalg.vector_norm(best_res, dim=1)
        for _ in range(self.refine_rounds):
            cand = best + self._solve_once(fac, best_res)
            cand_res = residual(cand)
            cand_nrm = torch.linalg.vector_norm(cand_res, dim=1)
            pick = (cand_nrm < best_nrm)[:, None, :]
            best = torch.where(pick, cand, best)
            best_res = torch.where(pick, cand_res, best_res)
            best_nrm = torch.minimum(cand_nrm, best_nrm)
        return self._post_sol(W, best)


class StagedQR(StagedLU):
    """Square-root variant of the stage sweep: a block-banded QR of the
    stage-interior part Kb (one QR a stage of the (2s, s) stack [P_k; O_k'],
    R gaining a second super-diagonal S2 of fill-in) plus a dense Schur
    complement S = D_g - V' Kb^-1 V for the arrow border, in NT-scaled
    duals. Orthogonal transforms never amplify, so the band factor is
    backward-stable where the LU sweep's Schur chain loses digits."""

    refine_rounds = 5
    scale_rows = True

    def factor(self, W):
        st = self.st
        dt, dev = self.A.dtype, self.A.device
        N, ns, rmax = st.N, st.ns, st.rmax
        s = ns + rmax
        nb = st.ng + st.mg
        A_eff, W_eff = self._effective_system(W)
        T, C, Vt, D_g = self._build_blocks(A_eff, W_eff)
        O, V = self._full_couplings(C, Vt)
        Bn = T.shape[0]

        P, C1 = T[:, 0], O[:, 0]
        zero = T.new_zeros(Bn, s, s)
        Qs, Rts, S1, S2 = [], [], [], []
        for k in range(N):
            Qk, Rfull = torch.linalg.qr(
                torch.cat([P, O[:, k].transpose(-1, -2)], dim=-2),
                mode="complete")
            Qt = Qk.transpose(-1, -2)
            T_next = (T[:, k + 1] if k + 1 < N
                      else torch.eye(s, dtype=dt, device=dev).expand(Bn, s, s))
            O_next = O[:, k + 1] if k + 1 < N else zero
            U1 = Qt @ torch.cat([C1, T_next], dim=-2)
            U2 = Qt @ torch.cat([zero, O_next], dim=-2)
            Qs.append(Qk)
            # R_k = L' with L = R_k' lower triangular: the back-substitution
            # is solve_lower_t(R_k', .)
            Rts.append(Rfull[:, :s].transpose(-1, -2).contiguous())
            S1.append(U1[:, :s])
            S2.append(U2[:, :s])
            P, C1 = U1[:, s:], U2[:, s:]
        band = (Qs, Rts, S1, S2)
        if nb:
            Y = self._band_solve(band, V)                   # (B, N, s, nb)
            S = D_g - torch.einsum("bksi,bksj->bij", V, Y)
            lu_S = lu_kernels.lu_factor(S)
        else:
            Y, lu_S = V, None
        return (band, Y, lu_S, V, A_eff, W_eff, W)

    def _band_solve(self, band, t):
        """Solve Kb x = t for stage-blocked t (B, N, s, K) by the band QR:
        Q_k' forward, then R_k backward."""
        Qs, Rts, S1, S2 = band
        N, s = t.shape[1], t.shape[2]
        g = []
        rho = t[:, 0]
        for k in range(N):
            t_next = t[:, k + 1] if k + 1 < N else torch.zeros_like(rho)
            U = Qs[k].transpose(-1, -2) @ torch.cat([rho, t_next], dim=-2)
            g.append(U[:, :s])
            rho = U[:, s:]
        xs = [None] * N
        x1 = x2 = None
        for k in range(N - 1, -1, -1):
            r = g[k]
            if x1 is not None:
                r = r - S1[k] @ x1
            if x2 is not None:
                r = r - S2[k] @ x2
            xs[k] = chol_kernels.solve_lower_t(Rts[k], r)
            x1, x2 = xs[k], x1
        return torch.stack(xs, dim=1)

    def _solve_once(self, fac, rhs):
        band, Y, lu_S, V, A_eff, W_eff, W = fac
        t, t_g = self._gather_rhs(rhs)
        yb = self._band_solve(band, t)
        if lu_S is not None:
            x_g = lu_kernels.lu_solve(
                lu_S, t_g - torch.einsum("bksi,bksK->biK", V, yb))
            x = yb - torch.einsum("bksi,biK->bksK", Y, x_g)
        else:
            x_g, x = t_g, yb
        return self._scatter_sol(x, x_g)


class StagedCR(StagedLU):
    """Cyclic-reduction KKT backend: the NT-scaled, Jacobi-equilibrated
    augmented system factored by odd/even block elimination of its stage
    block-tridiagonal part, as the right preconditioner of FGMRES(k)."""

    scale_rows = True
    # FGMRES(k) around the CR-factored solve, by working precision. The JAX
    # package's k=8 holds in float64; in float32 it leaves the Starship
    # subproblems' IPM stalled short of OPTIMAL, in the JAX package as here,
    # where k=16 certifies most of them on the H100 (PERF.md, "FGMRES depth").
    GMRES_ITERS = {torch.float32: 16, torch.float64: 8}
    # symmetric Jacobi equilibration rounds of the augmented system
    jacobi_rounds = 3

    def __init__(self, spec: ConeSpec, A, reg_eps, cone_mask,
                 structure: AugStageStructure):
        super().__init__(spec, A, reg_eps, cone_mask, structure)
        self.gmres_iters = self.GMRES_ITERS[A.dtype]
        N = structure.N
        self._Npad = 1 << max(N - 1, 0).bit_length() if N > 1 else 1

    # -- pluggable small-block LU engine ---------------------------------

    def _blk_lu(self, D):
        return linalg.lu_factor(D)

    def _blk_solve(self, fac, R):
        return torch.linalg.lu_solve(fac[0], fac[1], R)

    # -- factorization -----------------------------------------------------

    def _jacobi(self, A_eff, u, d):
        """(s_x (B, n), s_z (B, m)) equalizing the inf-norms of S K S."""
        absA = torch.abs(A_eff)
        w2diag = torch.abs(d) + u * u
        s_x = torch.ones(A_eff.shape[0], self.n, dtype=A_eff.dtype,
                         device=A_eff.device)
        s_z = torch.ones(A_eff.shape[0], self.m, dtype=A_eff.dtype,
                         device=A_eff.device)
        for _ in range(self.jacobi_rounds):
            rnx = torch.maximum(
                self.reg_eps * s_x * s_x,
                torch.amax(absA * s_z[:, :, None], dim=1) * s_x)
            rnz = torch.maximum(
                w2diag * s_z * s_z,
                torch.amax(absA * s_x[:, None, :], dim=2) * s_z)
            s_x = s_x / torch.sqrt(torch.where(rnx > 0, rnx,
                                               torch.ones_like(rnx)))
            s_z = s_z / torch.sqrt(torch.where(rnz > 0, rnz,
                                               torch.ones_like(rnz)))
        return s_x, s_z

    def _equilibrated_blocks(self, W):
        """(A_eff, W_eff, s_full, T, C, Vt, D_g): the NT-scaled system's
        stage blocks after the symmetric Jacobi scaling K~ = S K S."""
        Bn = self.A.shape[0]
        dt, dev = self.A.dtype, self.A.device
        A_eff, W_eff = self._effective_system(W)
        u, d = _flat_w2_vectors(self.spec, W_eff, self.m, Bn, dt, dev,
                                self.cone_mask)
        s_x, s_z = self._jacobi(A_eff, u, d)
        A_b = s_z[:, :, None] * A_eff * s_x[:, None, :]
        T, C, Vt, D_g = self._build_blocks_core(
            A_b, u * s_z, d * s_z * s_z,
            self.reg_eps * s_x * s_x, self.reg_eps * s_z * s_z)
        return A_eff, W_eff, torch.cat([s_x, s_z], dim=1), T, C, Vt, D_g

    def _pad_stages(self, X, fill):
        """X (B, N, ...) padded to Npad stages with `fill` (... shaped)."""
        Bn, N = X.shape[0], X.shape[1]
        if self._Npad == N:
            return X
        return torch.cat([X, fill.expand(Bn, self._Npad - N,
                                         *fill.shape)], dim=1)

    def _arrow(self, levels, root, Vt, D_g):
        """(Yt = Kb^-1 Vt, the arrow Schur complement's factor)."""
        st = self.st
        ng = st.ng
        if not st.ng + st.mg:
            return Vt, None
        Vtp = self._pad_stages(Vt, Vt.new_zeros(Vt.shape[2:]))
        Yt = self._cr_solve(levels, root, Vtp)[:, :st.N]
        S = D_g.clone()
        S[:, :ng, :ng] -= torch.einsum("bksi,bksj->bij", Vt, Yt)
        return Yt, self._blk_lu(S)

    def factor(self, W):
        st = self.st
        dt, dev = self.A.dtype, self.A.device
        ns, rmax = st.ns, st.rmax
        s = ns + rmax
        A_eff, W_eff, s_full, T, C, Vt, D_g = self._equilibrated_blocks(W)
        Bn = T.shape[0]

        # pad the stage count to a power of two with decoupled identity
        # blocks; the coupling keeps its (rmax, ns) corner form through
        # every level, so each level's solves see s RHS columns
        D = self._pad_stages(T, torch.eye(s, dtype=dt, device=dev))
        C = self._pad_stages(C, C.new_zeros(rmax, ns))

        levels = []
        M = self._Npad
        while M > 1:
            D_odd = D[:, 1::2]
            C_e = C[:, 0::2]
            C_o = C[:, 1::2]
            lu = self._blk_lu(D_odd)
            nblk = D_odd.shape[1]
            rhs = D.new_zeros(Bn, nblk, s, s)
            rhs[:, :, :ns, :rmax] = C_e.transpose(-1, -2)
            rhs[:, :, ns:, rmax:] = C_o
            PQ = self._blk_solve(lu, rhs)
            Pc = PQ[..., :rmax]
            Qc = PQ[..., rmax:]
            Sxx = torch.einsum("baki,bakj->baij", C_o, Qc[:, :, ns:, :])
            left = torch.cat([Sxx.new_zeros(Bn, 1, ns, ns), Sxx[:, :-1]],
                             dim=1)
            D_new = D[:, 0::2].clone()
            D_new[:, :, :ns, :ns] -= left
            D_new[:, :, ns:, ns:] -= C_e @ Pc[:, :, :ns, :]
            D = D_new
            C = -(C_e @ Qc[:, :, :ns, :])
            levels.append((lu, Pc, Qc, C_e, C_o))
            M //= 2
        lu_root = self._blk_lu(D[:, 0])
        Yt, lu_S = self._arrow(levels, lu_root, Vt, D_g)
        return (tuple(levels), lu_root, Yt, lu_S, s_full, Vt,
                A_eff, W_eff, W)

    def _cr_solve(self, levels, lu_root, t):
        """Solve the block-tridiagonal interior for stage-blocked t
        (B, Npad, s, K) through the stored reduction levels."""
        ns = self.st.ns
        Bn, _, s, K = t.shape
        ys = []
        for (lu, Pc, Qc, C_e, C_o) in levels:
            y = self._blk_solve(lu, t[:, 1::2].contiguous())
            zx = torch.einsum("baki,bakK->baiK", C_o, y[:, :, ns:])
            left = torch.cat([zx.new_zeros(Bn, 1, ns, K), zx[:, :-1]], dim=1)
            t_new = t[:, 0::2].clone()
            t_new[:, :, :ns] -= left
            t_new[:, :, ns:] -= C_e @ y[:, :, :ns]
            t = t_new
            ys.append(y)
        x = self._blk_solve(lu_root, t[:, 0])[:, None]
        for (lu, Pc, Qc, C_e, C_o), y in zip(reversed(levels),
                                             reversed(ys)):
            x_next = torch.cat([x[:, 1:], x.new_zeros(Bn, 1, s, K)], dim=1)
            x_odd = y - Pc @ x[:, :, ns:] - Qc @ x_next[:, :, :ns]
            M2 = x.shape[1]
            x = torch.stack([x, x_odd], dim=2).reshape(Bn, 2 * M2, s, K)
        return x

    def _solve_once(self, fac, rhs):
        levels, lu_root, Yt, lu_S, s_full, Vt, A_eff, W_eff, W = fac
        st = self.st
        N = st.N
        rhs = rhs * s_full[:, :, None]
        t, t_g = self._gather_rhs(rhs)
        tp = self._pad_stages(t, t.new_zeros(t.shape[2:]))
        yb = self._cr_solve(levels, lu_root, tp)[:, :N]
        if lu_S is not None:
            ng = st.ng
            t_g = t_g.clone()
            t_g[:, :ng] -= torch.einsum("bksi,bksK->biK", Vt, yb)
            x_g = self._blk_solve(lu_S, t_g)
            x = yb - torch.einsum("bksi,biK->bksK", Yt, x_g[:, :ng])
        else:
            x_g = t_g
            x = yb
        return self._scatter_sol(x, x_g) * s_full[:, :, None]

    def solve(self, fac, rhs):
        """FGMRES(gmres_iters) on the unregularized NT-scaled operator,
        right-preconditioned by the CR factor and run on all RHS columns at
        once (per-column Gram-Schmidt and least squares), with a plain
        factored solve as guard: per column, the smaller residual wins."""
        A_eff, W_eff, W = fac[-3], fac[-2], fac[-1]
        n = self.n
        rhs = self._pre_rhs(W, rhs)
        mask = self.cone_mask[:, None]
        At = A_eff.transpose(1, 2)

        def matvec(v):
            return torch.cat([At @ v[:, n:], A_eff @ v[:, :n]
                              - v[:, n:] * mask], dim=1)

        k = self.gmres_iters
        beta = torch.linalg.vector_norm(rhs, dim=1)            # (B, K)
        bsafe = torch.where(beta > 0, beta, torch.ones_like(beta))
        V = [rhs / bsafe[:, None, :]]
        Z = []
        H = rhs.new_zeros(rhs.shape[0], rhs.shape[2], k + 1, k)
        for j in range(k):
            z = self._solve_once(fac, V[j])
            Z.append(z)
            w = matvec(z)
            for i in range(j + 1):          # modified Gram-Schmidt
                hij = torch.sum(V[i] * w, dim=1)
                w = w - hij[:, None, :] * V[i]
                H[:, :, i, j] = hij
            hn = torch.linalg.vector_norm(w, dim=1)
            H[:, :, j + 1, j] = hn
            V.append(w / torch.where(hn > 0, hn, torch.ones_like(hn))[
                :, None, :])
        y = _hessenberg_lstsq(H, beta)                          # (B, K, k)
        sol = sum(y[:, None, :, j] * Z[j] for j in range(k))
        plain = self._solve_once(fac, rhs)
        rn = lambda v: torch.linalg.vector_norm(rhs - matvec(v), dim=1)
        pick_g = rn(sol) < rn(plain)
        best = torch.where(pick_g[:, None, :], sol, plain)
        return self._post_sol(W, best)


def _hessenberg_lstsq(H, beta):
    """min_y ||beta e1 - H y|| for upper-Hessenberg H (..., k+1, k) by
    Givens rotations (the small least squares of FGMRES), elementwise over
    the leading dims. A zero column leaves a zero on R's diagonal, and the
    back substitution then yields inf/NaN, as a QR-based solve would."""
    k = H.shape[-1]
    R = H.clone()
    g = torch.zeros(H.shape[:-2] + (k + 1,), dtype=H.dtype, device=H.device)
    g[..., 0] = beta
    for j in range(k):
        a = R[..., j, j]
        b = R[..., j + 1, j]
        r = torch.hypot(a, b)
        rs = torch.where(r > 0, r, torch.ones_like(r))
        c = torch.where(r > 0, a / rs, torch.ones_like(r))
        s = torch.where(r > 0, b / rs, torch.zeros_like(r))
        rj = R[..., j, j:].clone()
        rj1 = R[..., j + 1, j:].clone()
        R[..., j, j:] = c[..., None] * rj + s[..., None] * rj1
        R[..., j + 1, j:] = -s[..., None] * rj + c[..., None] * rj1
        gj, gj1 = g[..., j].clone(), g[..., j + 1].clone()
        g[..., j] = c * gj + s * gj1
        g[..., j + 1] = -s * gj + c * gj1
    y = torch.zeros(H.shape[:-2] + (k,), dtype=H.dtype, device=H.device)
    for j in range(k - 1, -1, -1):
        acc = g[..., j] - torch.sum(R[..., j, j + 1:k] * y[..., j + 1:],
                                    dim=-1)
        y[..., j] = acc / R[..., j, j]
    return y


class StagedCRPL(StagedCR):
    """StagedCR with its small-block LU engine on the hand-written Hopper
    kernels `ops.lu_kernels.lu_factor` / `lu_solve` (plain PyTorch versions
    on a CPU tensor). Same algebra and pivot rule as StagedCR."""

    def _blk_lu(self, D):
        return lu_kernels.lu_factor(D)

    def _blk_solve(self, fac, R):
        return lu_kernels.lu_solve(fac, R)


class StagedCRQD(StagedCR):
    """Cyclic reduction with quasidefinite 2-Cholesky block algebra and
    explicit block inverses (the JAX package's record of an experiment:
    preconditioner-grade only, its IPM stalling near a 1.6e-3 gap on the
    float32 Starship subproblem, where StagedCR reaches 3.6e-6).

    Every level's blocks keep the form D = [[X, B'], [B, -Z]] with X and Z
    SPD and the coupling U = [[0, 0], [C, 0]]; each odd block is inverted
    from two Cholesky factors (Z, and S = X + B' Z^-1 B) in a projector
    form, so every CR solve phase is one batched product a level. The z-z
    diagonal is floored at `pc_floor` so S stays factorable; the FGMRES
    wrapper absorbs that bias. The Cholesky factors and the inverse
    triangular factors run on the hand-written Cholesky-ladder kernels, the
    arrow's Schur complement on the LU kernels."""

    pc_floor = 3e-2
    # the floored preconditioner needs a deeper Krylov space than the
    # exact-LU CR factor (the JAX package measured 8 -> 5e-3, 16 -> ~1e-6)
    GMRES_ITERS = {torch.float32: 16, torch.float64: 16}

    def _blk_lu(self, D):
        return lu_kernels.lu_factor(D)

    def _blk_solve(self, fac, R):
        return lu_kernels.lu_solve(fac, R)

    @staticmethod
    def _chol_inv_robust(M):
        """Li (..., n, n) with M^-1 = Li' Li up to a ridge bias, for
        near-SPD M: Jacobi normalization Mh = D^-1/2 M D^-1/2, then the
        Cholesky of Mh + r I at the smallest rung r in {10 sqrt(eps),
        1e-3, 3e-1} whose factor is finite, per matrix (the identity where
        even the last is not), and Lh^-1 by a triangular solve. The three
        rungs go to the kernel in one launch; a failing factor comes out
        non-finite (the kernel raises nothing), as JAX's cholesky gives NaN.
        Mh is symmetrized first, as jnp.linalg.cholesky does."""
        dt = M.dtype
        n = M.shape[-1]
        dg = torch.diagonal(M, dim1=-2, dim2=-1)
        sc = torch.where(dg > 0, 1.0 / torch.sqrt(torch.abs(dg) + 1e-30),
                         torch.ones_like(dg))
        Mh = M * sc[..., :, None] * sc[..., None, :]
        Mh = 0.5 * (Mh + Mh.transpose(-1, -2))
        eye = torch.eye(n, dtype=dt, device=M.device)
        base = 10.0 * float(np.sqrt(torch.finfo(dt).eps))
        rungs = torch.tensor([base, 1e-3, 3e-1], dtype=dt, device=M.device)
        L = chol_kernels.cholesky(
            Mh[None] + rungs.reshape((3,) + (1,) * M.dim()) * eye)
        ok = torch.isfinite(L).all(dim=-1).all(dim=-1)[..., None, None]
        Lpick = torch.where(ok[0], L[0], torch.where(
            ok[1], L[1], torch.where(ok[2], L[2], eye)))
        Lh_inv = chol_kernels.solve_lower(Lpick,
                                          eye.expand(M.shape).contiguous())
        # M = (D^1/2 Lh)(D^1/2 Lh)'  =>  Lm^-1 = Lh^-1 D^-1/2
        return Lh_inv * sc[..., None, :]

    def _qd_inverse(self, X, B, Z):
        """Explicit inverse of [[X, B'], [B, -Z]] (batched) in the
        projector form: with Lz Lz' = Z, Ls Ls' = S = X + B' Z^-1 B,
        Bt = Lz^-1 B and U1 = Bt Ls^-T,
          (D^-1)_xx = Ls^-T Ls^-1,  (D^-1)_xz = Ls^-T U1' Lz^-1,
          (D^-1)_zz = Lz^-T (U1 U1' - I) Lz^-1,
        where U1 U1' - I is formed at O(1) scale."""
        tr = lambda a: a.transpose(-1, -2)
        Lzi = self._chol_inv_robust(Z)
        Bt = Lzi @ B
        S = X + tr(Bt) @ Bt
        Lsi = self._chol_inv_robust(S)
        LsiT = tr(Lsi)
        Sinv = LsiT @ Lsi
        U1 = Bt @ LsiT
        ixz = LsiT @ (tr(U1) @ Lzi)
        eye_z = torch.eye(Z.shape[-1], dtype=Z.dtype, device=Z.device)
        izz = tr(Lzi) @ ((U1 @ tr(U1)) - eye_z) @ Lzi
        return torch.cat([torch.cat([Sinv, ixz], dim=-1),
                          torch.cat([tr(ixz), izz], dim=-1)], dim=-2)

    def factor(self, W):
        st = self.st
        dt, dev = self.A.dtype, self.A.device
        ns, rmax = st.ns, st.rmax
        A_eff, W_eff, s_full, T, C, Vt, D_g = self._equilibrated_blocks(W)
        assert W_eff is None, "StagedCRQD requires the NT-scaled system"

        # the canonical quasidefinite pieces, the z-z diagonal floored
        X = T[..., :ns, :ns]
        Bb = T[..., ns:, :ns]
        Z = -T[..., ns:, ns:]
        torch.diagonal(Z, dim1=-2, dim2=-1).clamp_(min=self.pc_floor)
        X = self._pad_stages(X, torch.eye(ns, dtype=dt, device=dev))
        Z = self._pad_stages(Z, torch.eye(rmax, dtype=dt, device=dev))
        Bb = self._pad_stages(Bb, Bb.new_zeros(rmax, ns))
        Cc = self._pad_stages(C, C.new_zeros(rmax, ns))

        levels = []
        M = self._Npad
        while M > 1:
            C_o, C_e = Cc[:, 1::2], Cc[:, 0::2]
            Minv = self._qd_inverse(X[:, 1::2], Bb[:, 1::2], Z[:, 1::2])
            C_eT = C_e.transpose(-1, -2)
            a_Q = Minv[..., :ns, ns:] @ C_o
            b_Q = Minv[..., ns:, ns:] @ C_o
            a_P = Minv[..., :ns, :ns] @ C_eT
            b_P = Minv[..., ns:, :ns] @ C_eT
            levels.append((Minv, a_Q, b_Q, a_P, b_P, C_e, C_o))
            term = torch.einsum("baki,bakj->baij", C_o, b_Q)
            left = torch.cat([term.new_zeros(term.shape[0], 1, ns, ns),
                              term[:, :-1]], dim=1)
            X = X[:, 0::2] - left
            Z = Z[:, 0::2] + C_e @ a_P
            Cc = -(C_e @ a_Q)
            Bb = Bb[:, 0::2]
            M //= 2
        root_inv = self._qd_inverse(X[:, 0], Bb[:, 0], Z[:, 0])
        Yt, lu_S = self._arrow(levels, root_inv, Vt, D_g)
        return (tuple(levels), root_inv, Yt, lu_S, s_full, Vt,
                A_eff, W_eff, W)

    def _cr_solve(self, levels, root_inv, t):
        ns = self.st.ns
        Bn, _, s, K = t.shape
        ys = []
        for (Minv, a_Q, b_Q, a_P, b_P, C_e, C_o) in levels:
            y = Minv @ t[:, 1::2]
            lx = torch.einsum("baki,bakK->baiK", C_o, y[:, :, ns:])
            lx = torch.cat([lx.new_zeros(Bn, 1, ns, K), lx[:, :-1]], dim=1)
            t_new = t[:, 0::2].clone()
            t_new[:, :, :ns] -= lx
            t_new[:, :, ns:] -= C_e @ y[:, :, :ns]
            t = t_new
            ys.append(y)
        x = (root_inv @ t[:, 0])[:, None]
        for (Minv, a_Q, b_Q, a_P, b_P, C_e, C_o), y in zip(
                reversed(levels), reversed(ys)):
            x_next = torch.cat([x[:, 1:], x.new_zeros(Bn, 1, s, K)], dim=1)
            xe_z = x[:, :, ns:]
            xn_x = x_next[:, :, :ns]
            x_odd = y - torch.cat([a_P @ xe_z + a_Q @ xn_x,
                                   b_P @ xe_z + b_Q @ xn_x], dim=2)
            M2 = x.shape[1]
            x = torch.stack([x, x_odd], dim=2).reshape(Bn, 2 * M2, s, K)
        return x


def probe_aug_structure(layout, N: int, spec: ConeSpec, assemble_fn,
                        global_blocks=()) -> Optional[AugStageStructure]:
    """AugStageStructure from the union of three random-input sparsity
    probes (`assemble_fn(seed)` -> dense A). None when the row structure
    does not fit the stage pattern."""
    probe = np.asarray(assemble_fn(0)) != 0.0
    for seed in (1, 2):
        probe |= np.asarray(assemble_fn(seed)) != 0.0
    try:
        return AugStageStructure(layout, N, spec, probe.astype(np.float64),
                                 global_blocks=global_blocks)
    except ValueError:
        return None


def _builder(cls, structure, gmres_iters=None):
    def build(spec, A, reg_eps, cone_mask):
        kkt = cls(spec, A, reg_eps, cone_mask, structure)
        if gmres_iters is not None:
            kkt.gmres_iters = gmres_iters
        return kkt

    build.structure = structure
    return build


def make_staged_lu_builder(structure: AugStageStructure):
    """ipm.solve(kkt_builder=...) adapter: the forward LU stage sweep."""
    return _builder(StagedLU, structure)


def make_staged_qr_builder(structure: AugStageStructure):
    """ipm.solve(kkt_builder=...) adapter: the band-QR (square-root) stage
    sweep."""
    return _builder(StagedQR, structure)


def make_staged_cr_builder(structure: AugStageStructure,
                           gmres_iters: Optional[int] = None):
    """ipm.solve(kkt_builder=...) adapter: cyclic reduction on the library
    LU (torch.linalg)."""
    return _builder(StagedCR, structure, gmres_iters)


def make_staged_crpl_builder(structure: AugStageStructure,
                             gmres_iters: Optional[int] = None):
    """ipm.solve(kkt_builder=...) adapter: cyclic reduction on the
    hand-written LU kernels."""
    return _builder(StagedCRPL, structure, gmres_iters)


def make_staged_crqd_builder(structure: AugStageStructure,
                             gmres_iters: Optional[int] = None):
    """ipm.solve(kkt_builder=...) adapter: cyclic reduction with
    quasidefinite 2-Cholesky block inverses."""
    return _builder(StagedCRQD, structure, gmres_iters)
