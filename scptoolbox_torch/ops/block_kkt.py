"""Stage-structured KKT factorization: the block-tridiagonal + arrow sweep
over the normal equations of an SCP subproblem.

Counterpart of `scptoolbox_tpu/ops/block_kkt.py` (`StageStructure` :51,
`_gather` :141, `StructuredKKT` :147, `probe_structure` :376,
`make_kkt_builder` :397). The reduced KKT factors

    H = A_C' W^-2 A_C + reg,

which under the stage permutation of the decision vector (per-node blocks
x_k, u_k, virtual controls, slacks, radii ... plus a small global block) is

    [ D_0  U_0                 V_0 ]
    [ U_0' D_1  U_1            V_1 ]
    [      ...  ...            ... ]
    [           U'   D_{N-1}   V_  ]
    [ V_0' V_1' ...             Wg ]

block-tridiagonal with a dense arrow border. One block-Cholesky sweep over
the N stages factors it, and the equality rows are eliminated by a second
Schur complement S = A_E H^-1 A_E' as in the dense Schur KKT.

Where JAX vmaps the class and runs the sweep as a `lax.scan`, every array
here carries the scenario batch as its leading dimension and the sweep is a
Python loop over the stages. Each stage's Cholesky factor and triangular
solves run on the hand-written kernels of ops/chol_kernels.py (their plain
PyTorch versions on a CPU tensor); the products between blocks are `@`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from scptoolbox_torch.ops import chol_kernels
from scptoolbox_torch.ops import cones as cn
from scptoolbox_torch.ops.aug_kkt import _pad1
from scptoolbox_torch.ops.cones import ConeSpec
from scptoolbox_torch.ops.ipm import _apply_cols, _w2_matvec


class StageStructure:
    """Static stage permutation and cone-row classification of one
    subproblem template (pure numpy; built once per solver)."""

    def __init__(self, layout, N: int, spec: ConeSpec,
                 A_probe: np.ndarray, global_blocks=()):
        self.N = int(N)
        n = layout.n
        self.n = n
        nz = spec.nz
        AC = np.asarray(A_probe)[nz:] != 0.0    # (m_C, n) sparsity
        m_C = AC.shape[0]
        self.m_C = m_C

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
        # padded per-stage columns; the phantom index n selects a zero column
        scols = np.full((N, self.ns), n, np.int64)
        for k, s in enumerate(stage_cols):
            scols[k, : len(s)] = s
        self.scols = scols
        self.scols_next = np.concatenate(
            [scols[1:], np.full((1, self.ns), n, np.int64)], axis=0)
        self.col_pad = (scols == n)             # padded coords: unit pivots

        # cone-row units: nonneg rows singly, SOC blocks whole (the NT
        # scaling mixes the rows of a SOC block)
        units = [np.asarray([i]) for i in range(spec.nl)]
        off = spec.nl
        for d in spec.socs:
            units.append(np.arange(off, off + d))
            off += d
        assert off == m_C, (off, m_C)

        stage_rows = [[] for _ in range(N)]
        global_rows = []
        for u in units:
            cols = np.flatnonzero(AC[u].any(axis=0))
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
                    f"cone row unit spans non-adjacent stages {stages}; "
                    "dense KKT required")
        self.rmax = max(max((len(r) for r in stage_rows), default=0), 1)
        rows_pad = np.full((N, self.rmax), m_C, np.int64)  # phantom row m_C
        for k, r in enumerate(stage_rows):
            rows_pad[k, : len(r)] = r
        self.rows_pad = rows_pad
        self.global_rows = np.asarray(global_rows, np.int64)

        # per-stage footprints in the global columns (positions in g_cols;
        # the phantom position ng collects the padding)
        g_pos = np.full(n, self.ng, np.int64)
        g_pos[g_cols] = np.arange(self.ng)
        gf = []
        for k in range(N):
            rows = stage_rows[k]
            cols = (np.flatnonzero(AC[rows].any(axis=0)) if rows
                    else np.zeros(0, np.int64))
            gf.append(g_pos[cols[col_stage[cols] < 0]])
        self.gmax = max(max((len(f) for f in gf), default=0), 1)
        gf_pad = np.full((N, self.gmax), self.ng, np.int64)
        for k, f in enumerate(gf):
            gf_pad[k, : len(f)] = f
        self.gf_pad = gf_pad
        # original column of each footprint entry (phantom -> n)
        self.gf_cols = np.concatenate([g_cols, [n]])[gf_pad]
        self._dev = {}

    def on(self, device):
        """The index arrays as tensors on `device` (cached)."""
        device = torch.device(device)
        t = self._dev.get(device)
        if t is None:
            T = lambda a: torch.as_tensor(np.asarray(a), device=device)
            t = dict(scols=T(self.scols), scols_next=T(self.scols_next),
                     scols_flat=T(self.scols.reshape(-1)),
                     col_pad=T(self.col_pad), rows=T(self.rows_pad),
                     g_cols=T(self.g_cols), global_rows=T(self.global_rows),
                     gf_pad=T(self.gf_pad), gf_cols=T(self.gf_cols))
            self._dev[device] = t
        return t


def _gather(Gp, rows, cols):
    """Gp (B, m+1, n+1) padded matrix; rows (N, r), cols (N, c) ->
    (B, N, r, c)."""
    return Gp[:, rows[:, :, None], cols[:, None, :]]


class StructuredKKT:
    """The stage-structured normal-equations KKT backend for ops.ipm.solve:
    the contract of ops.ipm._SchurKKT (factor(W) / solve(fac, rhs), rhs
    (B, n + m[, K]) laid out [rhs_x; rhs_E (nz); rhs_C (m_C)], W None for
    the initialization solve), factored by the block sweep."""

    # one refinement round suffices: the block solve is exact up to the
    # tiny static regularization
    refine_rounds = 1

    def __init__(self, spec: ConeSpec, A, reg_eps, cone_mask,
                 structure: StageStructure):
        self.spec, self.A, self.reg_eps = spec, A, reg_eps
        self.cone_mask = cone_mask
        self.st = structure
        self.n, self.m = A.shape[2], A.shape[1]
        self.nz = spec.nz
        self.A_E = A[:, : self.nz]
        self.A_C = A[:, self.nz:]
        assert self.n == structure.n and self.A_C.shape[1] == structure.m_C

    # -- W applications on the cone rows -------------------------------------

    def _winv(self, W, M, power=1):
        """W^-power applied to the columns of M (B, m_C, k)."""
        if W is None:
            return M
        full = M.new_zeros(M.shape[0], self.m, M.shape[2])
        full[:, self.nz:] = M

        def inv(v):
            for _ in range(power):
                v = cn.scale(self.spec, W, v, inverse=True)
            return v

        return _apply_cols(inv, full)[:, self.nz:]

    # -- factorization --------------------------------------------------------

    def factor(self, W):
        st = self.st
        ix = st.on(self.A.device)
        dt = self.A.dtype
        Bn = self.A.shape[0]
        N, ns, ng = st.N, st.ns, st.ng
        G = self._winv(W, self.A_C)                         # (B, m_C, n)
        Gp = _pad1(_pad1(G, 1), 2)                          # phantom row/col
        rows = ix["rows"]
        Bk = _gather(Gp, rows, ix["scols"])                 # (B, N, r, ns)
        C = _gather(Gp, rows, ix["scols_next"])             # (B, N, r, ns)
        Gg = _gather(Gp, rows, ix["gf_cols"])               # (B, N, r, gmax)
        eps_rel = 100.0 * torch.finfo(dt).eps

        # diagonal blocks D_k = B_k'B_k + C_{k-1}'C_{k-1} (+ reg, unit pad)
        D = Bk.mT @ Bk
        D[:, 1:] += (C.mT @ C)[:, :-1]
        reg = self.reg_eps + eps_rel * torch.abs(
            torch.diagonal(D, dim1=-2, dim2=-1))
        reg = torch.where(ix["col_pad"], torch.ones_like(reg), reg)
        D = D + torch.diag_embed(reg)
        U = Bk.mT @ C                                       # stage k <-> k+1

        # arrow blocks V_k (ns, ng): B_k'Gg_k at the footprint plus
        # C_{k-1}'Gg_{k-1}; the phantom column ng repeats, so the scatters
        # accumulate and drop it
        bi = torch.arange(Bn, device=G.device)[:, None, None, None]
        ki = torch.arange(N, device=G.device)[None, :, None, None]
        gf = ix["gf_pad"]

        def scatter_cols(mat):                              # (B, N, ns, gmax)
            out = mat.new_zeros(Bn, N, ns, ng + 1)
            ii = torch.arange(ns, device=G.device)[None, None, :, None]
            out.index_put_((bi, ki, ii, gf[None, :, None, :]), mat,
                           accumulate=True)
            return out[..., :ng]

        V = scatter_cols(Bk.mT @ Gg)
        V[:, 1:] += scatter_cols(C.mT @ Gg)[:, :-1]

        # global block W_g = sum_k Gg_k'Gg_k (scattered) + global rows
        GtG = Gg.mT @ Gg                                    # (B, N, gm, gm)
        Wk = GtG.new_zeros(Bn, N, ng + 1, ng + 1)
        Wk.index_put_((bi, ki, gf[None, :, :, None], gf[None, :, None, :]),
                      GtG, accumulate=True)
        Wg = torch.sum(Wk, dim=1)[:, :ng, :ng]
        if len(st.global_rows):
            Grow = G[:, ix["global_rows"]][:, :, ix["g_cols"]]
            Wg = Wg + Grow.mT @ Grow
        if ng:
            reg_g = self.reg_eps + eps_rel * torch.abs(
                torch.diagonal(Wg, dim1=-2, dim2=-1))
            Wg = Wg + torch.diag_embed(reg_g)

        # ---- the block-Cholesky sweep over the stages ----
        L, E, F = [], [], []
        M, Vp = D[:, 0], V[:, 0]
        Sg = Wg.new_zeros(Bn, ng, ng)
        for k in range(N):
            L_k = chol_kernels.cholesky(M)
            E_k = chol_kernels.solve_lower(L_k, U[:, k])
            F_k = chol_kernels.solve_lower(L_k, Vp) if ng else Vp
            if k + 1 < N:
                M = D[:, k + 1] - E_k.mT @ E_k
                if ng:
                    Vp = V[:, k + 1] - E_k.mT @ F_k
            if ng:
                Sg = Sg + F_k.mT @ F_k
            L.append(L_k)
            E.append(E_k)
            F.append(F_k)
        L_g = chol_kernels.cholesky(Wg - Sg) if ng else Wg
        fac_H = (L, E, F, L_g)

        # ---- second level: the equality rows' Schur complement ----
        if self.nz:
            HiAE = self._solve_H(fac_H, self.A_E.mT)        # (B, n, nz)
            S = self.A_E @ HiAE
            reg_s = self.reg_eps + eps_rel * torch.abs(
                torch.diagonal(S, dim1=-2, dim2=-1))
            L_S = chol_kernels.cholesky(S + torch.diag_embed(reg_s))
        else:
            HiAE = L_S = None
        return (fac_H, HiAE, L_S, W)

    # -- the structured H solve ------------------------------------------------

    def _solve_H(self, fac_H, R):
        """X with H X = R for R (B, n, K), by the block factor."""
        st = self.st
        ix = st.on(R.device)
        L, E, F, L_g = fac_H
        N, ng = st.N, st.ng
        Bn, K = R.shape[0], R.shape[2]
        r_st = _pad1(R, 1)[:, ix["scols"]]                  # (B, N, ns, K)

        # forward: y_k = L_k^-1 (r_k - E_{k-1}' y_{k-1}); the global rows'
        # right-hand side collects F_k' y_k
        y = []
        acc = R.new_zeros(Bn, ng, K)
        for k in range(N):
            rhs = r_st[:, k] if k == 0 else r_st[:, k] - E[k - 1].mT @ y[-1]
            y.append(chol_kernels.solve_lower(L[k], rhs))
            if ng:
                acc = acc + F[k].mT @ y[-1]
        if ng:
            y_g = chol_kernels.solve_lower(L_g, R[:, ix["g_cols"]] - acc)
            x_g = chol_kernels.solve_lower_t(L_g, y_g)

        # backward: x_k = L_k'^-1 (y_k - E_k x_{k+1} - F_k x_g)
        x = [None] * N
        for k in range(N - 1, -1, -1):
            rhs = y[k] if k == N - 1 else y[k] - E[k] @ x[k + 1]
            if ng:
                rhs = rhs - F[k] @ x_g
            x[k] = chol_kernels.solve_lower_t(L[k], rhs)

        # scatter the stages and the global block back to the flat layout
        # (the phantom row n repeats and is dropped)
        X = R.new_zeros(Bn, st.n + 1, K)
        X[:, ix["scols_flat"]] = torch.stack(x, dim=1).reshape(Bn, -1, K)
        if ng:
            X[:, ix["g_cols"]] = x_g
        return X[:, : st.n]

    # -- the full KKT solve ---------------------------------------------------

    def _solve_once(self, fac, rhs):
        fac_H, HiAE, L_S, W = fac
        n, nz = self.n, self.nz
        rx = rhs[:, :n]
        rE = rhs[:, n: n + nz]
        rC = rhs[:, n + nz:]
        r1 = rx + self.A_C.mT @ self._winv(W, rC, 2)
        y = self._solve_H(fac_H, r1)
        if nz:
            dzE = chol_kernels.cho_solve(L_S, self.A_E @ y - rE)
            dx = y - HiAE @ dzE
        else:
            dzE, dx = rE, y
        dzC = self._winv(W, self.A_C @ dx - rC, 2)
        return torch.cat([dx, dzE, dzC], dim=1)

    def solve(self, fac, rhs):
        vec = rhs.dim() == 2
        if vec:
            rhs = rhs[:, :, None]
        W = fac[3]
        n = self.n
        sol = self._solve_once(fac, rhs)
        for _ in range(self.refine_rounds):
            w2z = _w2_matvec(self.spec, W, sol[:, n:], self.cone_mask)
            resid = rhs - torch.cat(
                [self.A.mT @ sol[:, n:], self.A @ sol[:, :n] - w2z], dim=1)
            sol = sol + self._solve_once(fac, resid)
        return sol[..., 0] if vec else sol


def probe_structure(layout, N: int, spec: ConeSpec, assemble_fn,
                    global_blocks=()) -> Optional[StageStructure]:
    """StageStructure from the union of three random-input sparsity probes
    (`assemble_fn(seed)` -> dense A; the solvers perturb the problem consts
    at seed 2, so the footprints also cover homotopy ladders). None when a
    cone row spans non-adjacent stages (dense fallback)."""
    probe = np.asarray(assemble_fn(0)) != 0.0
    for seed in (1, 2):
        probe |= np.asarray(assemble_fn(seed)) != 0.0
    try:
        return StageStructure(layout, N, spec, probe.astype(np.float64),
                              global_blocks=global_blocks)
    except ValueError:
        return None


def make_kkt_builder(structure: StageStructure):
    """ipm.solve(kkt_builder=...) adapter: the block sweep on the Cholesky
    kernels."""

    def build(spec, A, reg_eps, cone_mask):
        return StructuredKKT(spec, A, reg_eps, cone_mask, structure)

    build.structure = structure
    return build
