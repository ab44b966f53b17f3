"""Stage-structured augmented KKT factorization by cyclic reduction.

Counterpart of `scptoolbox_tpu/ops/aug_kkt.py`: `AugStageStructure` (:58),
`_flat_w2_vectors` (:147), the block assembly and gather/scatter that
`StagedCR` inherits from `StagedLU` (:196-398), `StagedCR` (:600-907),
`StagedCRPL` (:910-942), `probe_aug_structure` (:1208) and the builders
(:1243-1269). The quasidefinite system

    [ eps*I      A'          ] [dx]   [rhs_x]
    [ A       -(W^2 + eps*I) ] [dz] = [rhs_z]

is posed in NT-scaled duals (the cone block becomes -I), equilibrated by a
symmetric Jacobi scaling, permuted into stage super-blocks t_k = [x_k; r_k]
(block-tridiagonal with corner couplings C_k plus a dense arrow border), and
factored by cyclic reduction: ceil(log2 N) levels, each one batched
small-block LU over the odd blocks of every scenario. The CR factor is the
right preconditioner of FGMRES(k); a plain factored solve is kept as a guard
(per RHS column, the smaller residual wins).

Every array here carries the scenario batch as its leading dimension
(JAX vmaps the whole class instead). `StagedCR` runs its block LU on
the library's (`ops/linalg.py`, `torch.linalg.lu_solve`; the JAX package's
XLA/scipy LU);
`StagedCRPL` runs it on the hand-written kernels of `ops/lu_kernels.py`.
Both pivot (partial pivoting per block): unpivoted elimination breaks down
on the ~1e-7 regularization pivots of these blocks.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

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

        # row units: zero and nonneg rows singly, SOC blocks whole
        units = [np.asarray([i]) for i in range(spec.nz + spec.nl)]
        off = spec.nz + spec.nl
        for d in spec.socs:
            units.append(np.arange(off, off + d))
            off += d
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

        # W^2 metadata: W^2[i,j] = u_i u_j [same cone block] + d_i delta_ij
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
    zero on zero-cone rows. W=None gives W^2 = diag(cone_mask)."""
    if W is None:
        return (torch.zeros(Bn, m, dtype=dtype, device=device),
                cone_mask.expand(Bn, m).to(dtype))
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


class StagedCR:
    """Cyclic-reduction KKT backend for ops.ipm.solve: the same factor/solve
    contract as the dense KKTs (rhs layout [rhs_x (n); rhs_z (m)], columns
    last), factoring the NT-scaled, Jacobi-equilibrated augmented system by
    odd/even block elimination of its stage block-tridiagonal part."""

    # FGMRES(k) around the CR-factored solve, by working precision. The JAX
    # package's k=8 holds in float64; in float32 it leaves the Starship
    # subproblems' IPM stalled short of OPTIMAL, in the JAX package as here,
    # where k=16 certifies most of them on the H100 (PERF.md, "FGMRES depth").
    GMRES_ITERS = {torch.float32: 16, torch.float64: 8}
    # symmetric Jacobi equilibration rounds of the augmented system
    jacobi_rounds = 3

    def __init__(self, spec: ConeSpec, A, reg_eps, cone_mask,
                 structure: AugStageStructure):
        self.spec, self.A, self.reg_eps = spec, A, reg_eps
        self.cone_mask = cone_mask
        self.st = structure
        self.gmres_iters = self.GMRES_ITERS[A.dtype]
        self.n, self.m = A.shape[2], A.shape[1]
        assert self.n == structure.n and self.m == structure.m
        N = structure.N
        self._Npad = 1 << max(N - 1, 0).bit_length() if N > 1 else 1

    # -- shared block assembly --------------------------------------------

    def _effective_system(self, W):
        """(A_eff, W_eff): in NT-scaled duals the cone rows are pre-scaled,
        A~ = W^-1 A, and the cone block collapses to -I (W_eff = None)."""
        if W is not None:
            A_eff = cn.scale(self.spec, W, self.A.transpose(1, 2),
                             inverse=True).transpose(1, 2)
            return A_eff, None
        return self.A, W

    def _build_blocks_core(self, A, u, d, reg_x_vec, reg_z_vec):
        """Stage super-blocks T (B, N, s, s), corner couplings
        C (B, N, rmax, ns), thin arrow columns Vt (B, N, s, ng) and the
        border block D_g (B, nb, nb), from the flat (u, d) W^2 form and
        per-index diagonal regularization (reg_x_vec (B, n) on the x-x
        block, reg_z_vec (B, m) added to the cone block)."""
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
        if W is None:
            return rhs
        n = self.n
        sc = cn.scale(self.spec, W, rhs[:, n:].transpose(1, 2),
                      inverse=True).transpose(1, 2)
        return torch.cat([rhs[:, :n], sc], dim=1)

    # dz = W^-1 dz~ on the way out: same transform as _pre_rhs
    _post_sol = _pre_rhs

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

    def factor(self, W):
        st = self.st
        Bn = self.A.shape[0]
        dt, dev = self.A.dtype, self.A.device
        N, ns, rmax, ng, mg = st.N, st.ns, st.rmax, st.ng, st.mg
        s = ns + rmax
        nb = ng + mg
        A_eff, W_eff = self._effective_system(W)
        u, d = _flat_w2_vectors(self.spec, W_eff, self.m, Bn, dt, dev,
                                self.cone_mask)
        s_x, s_z = self._jacobi(A_eff, u, d)
        A_b = s_z[:, :, None] * A_eff * s_x[:, None, :]
        T, C, Vt, D_g = self._build_blocks_core(
            A_b, u * s_z, d * s_z * s_z,
            self.reg_eps * s_x * s_x, self.reg_eps * s_z * s_z)
        s_full = torch.cat([s_x, s_z], dim=1)

        # pad the stage count to a power of two with decoupled identity
        # blocks; the coupling keeps its (rmax, ns) corner form through
        # every level, so each level's solves see s RHS columns
        Npad = self._Npad
        if Npad > N:
            eye = torch.eye(s, dtype=dt, device=dev)
            D = torch.cat([T, eye.expand(Bn, Npad - N, s, s)], dim=1)
            C = torch.cat([C, C.new_zeros(Bn, Npad - N, rmax, ns)], dim=1)
        else:
            D = T

        levels = []
        M = Npad
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

        if nb:
            Vtp = (torch.cat([Vt, Vt.new_zeros(Bn, Npad - N, s, ng)], dim=1)
                   if Npad > N else Vt)
            Yt = self._cr_solve(levels, lu_root, Vtp)[:, :N]
            S = D_g.clone()
            S[:, :ng, :ng] -= torch.einsum("bksi,bksj->bij", Vt, Yt)
            lu_S = self._blk_lu(S)
        else:
            Yt = Vt
            lu_S = None
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
        nb = st.ng + st.mg
        rhs = rhs * s_full[:, :, None]
        t, t_g = self._gather_rhs(rhs)
        Bn, _, s, K = t.shape
        Npad = self._Npad
        tp = (torch.cat([t, t.new_zeros(Bn, Npad - N, s, K)], dim=1)
              if Npad > N else t)
        yb = self._cr_solve(levels, lu_root, tp)[:, :N]
        if nb:
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


def _builder(cls, structure, gmres_iters):
    def build(spec, A, reg_eps, cone_mask):
        kkt = cls(spec, A, reg_eps, cone_mask, structure)
        if gmres_iters is not None:
            kkt.gmres_iters = gmres_iters
        return kkt

    build.structure = structure
    return build


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
