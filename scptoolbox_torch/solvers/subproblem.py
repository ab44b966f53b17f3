"""Subproblem assembly: variable layout, cone row planning, and dense
(A, b, c) assembly for the IPM, batched over scenarios.

Counterpart of `scptoolbox_tpu/solvers/subproblem.py` (`VarLayout` with
`extract` :65, `RowPlan` with its exp groups :95 and their place in
`freeze` :119-127, `Assembler` with `res_nonpos` :177 and `res_exp` :186,
`soc_epigraph_quadratic` :198). The structure (row/column indices) is
static numpy; the values are tensors with a leading scenario dimension B.

Sign/lowering conventions (residual v affine in the decision d):
    ZERO    v  = 0   ->  A = J,  b = -v0,  zero-cone rows
    NONPOS  v <= 0   ->  A = J,  b = -v0,  nonneg slack rows (s = -v)
    SOC     v in SOC ->  A = -J, b =  v0,  SOC slack block  (s =  v)
    EXP     v in EXP ->  A = -J, b =  v0,  exp slack block  (s =  v)
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from scptoolbox_torch.ops.cones import ConeSpec


class VarLayout:
    """Named blocks of the flat decision vector (static bookkeeping)."""

    def __init__(self):
        self._blocks: Dict[str, Tuple[int, Tuple[int, ...]]] = {}
        self.n = 0

    def add(self, name: str, *shape: int) -> None:
        assert name not in self._blocks, f"duplicate block {name}"
        size = int(np.prod(shape)) if shape else 1
        self._blocks[name] = (self.n, tuple(shape))
        self.n += size

    def has(self, name: str) -> bool:
        return name in self._blocks

    def idx(self, name: str) -> np.ndarray:
        """Index array with the block's shape (scalars: shape ())."""
        off, shape = self._blocks[name]
        size = int(np.prod(shape)) if shape else 1
        return (off + np.arange(size)).reshape(shape)

    def sl(self, name: str) -> slice:
        off, shape = self._blocks[name]
        size = int(np.prod(shape)) if shape else 1
        return slice(off, off + size)

    def extract(self, d: torch.Tensor, name: str) -> torch.Tensor:
        """The block `name` of d (..., n), with the block's shape after
        d's leading dims."""
        off, shape = self._blocks[name]
        size = int(np.prod(shape)) if shape else 1
        return d[..., off:off + size].reshape(d.shape[:-1] + shape)


class RowPlan:
    """Reserve constraint rows grouped by cone kind; freeze() orders them
    [zero | nonneg | soc... | exp...] to match the ConeSpec layout."""

    def __init__(self):
        self._zero: List[Tuple[str, int]] = []
        self._nonneg: List[Tuple[str, int]] = []
        self._soc: List[Tuple[str, int, int]] = []
        self._exp: List[Tuple[str, int]] = []
        self._frozen = False
        self._rows: Dict[str, np.ndarray] = {}

    def zero(self, name: str, nrows: int) -> None:
        assert not self._frozen
        self._zero.append((name, int(nrows)))

    def nonneg(self, name: str, nrows: int) -> None:
        assert not self._frozen
        self._nonneg.append((name, int(nrows)))

    def soc(self, name: str, count: int, dim: int) -> None:
        assert not self._frozen
        self._soc.append((name, int(count), int(dim)))

    def exp(self, name: str, count: int) -> None:
        """`count` exponential-cone blocks (x, y, z): y e^{x/y} <= z."""
        assert not self._frozen
        self._exp.append((name, int(count)))

    def freeze(self) -> ConeSpec:
        assert not self._frozen
        self._frozen = True
        off = 0
        for name, nr in self._zero:
            self._rows[name] = off + np.arange(nr)
            off += nr
        nz = off
        for name, nr in self._nonneg:
            self._rows[name] = off + np.arange(nr)
            off += nr
        nl = off - nz
        socs: List[int] = []
        for name, count, dim in self._soc:
            self._rows[name] = (off + np.arange(count)[:, None] * dim
                                + np.arange(dim)[None, :])
            off += count * dim
            socs.extend([dim] * count)
        nexp = 0
        for name, count in self._exp:
            self._rows[name] = (off + np.arange(count)[:, None] * 3
                                + np.arange(3)[None, :])
            off += count * 3
            nexp += count
        self.m = off
        return ConeSpec(nz=nz, nl=nl, socs=tuple(socs), nexp=nexp)

    def rows(self, name: str) -> np.ndarray:
        """(nrows,) for zero/nonneg groups; (count, dim) for SOC/EXP
        groups."""
        return self._rows[name]


class Assembler:
    """Accumulates a batch of dense subproblems (A (B, m, n), b (B, m),
    c (B, n), const (B,)). Values given without the batch dim are shared by
    every scenario; additions accumulate (repeated indices add up)."""

    def __init__(self, m: int, n: int, B: int, dtype, device):
        self.m, self.n, self.B = m, n, B
        self.device = torch.device(device)
        z = lambda *s: torch.zeros(*s, dtype=dtype, device=device)
        self.A = z(B, m, n)
        self.b = z(B, m)
        self.c = z(B, n)
        self.const = z(B)

    def _vals(self, vals, shape):
        v = torch.as_tensor(vals, dtype=self.A.dtype, device=self.device)
        return torch.broadcast_to(v, (self.B,) + tuple(shape)).reshape(
            self.B, -1)

    def add_A(self, rows, cols, blk) -> None:
        """A[rows x cols] += blk. rows (r,), cols (c,), blk (r, c); or
        batched rows (k, r), cols (k, c), blk (k, r, c) — each with an
        optional leading scenario dim on blk."""
        rows = np.asarray(rows)
        cols = np.asarray(cols)
        flat = rows[..., :, None] * self.n + cols[..., None, :]
        idx = torch.as_tensor(flat.reshape(-1), device=self.device)
        self.A.view(self.B, -1).index_add_(1, idx,
                                           self._vals(blk, flat.shape))

    def add_b(self, rows, vals) -> None:
        """b[rows] += vals; vals has rows' shape, optionally with the
        scenario dim in front."""
        rows = np.asarray(rows)
        idx = torch.as_tensor(rows.reshape(-1), device=self.device)
        self.b.index_add_(1, idx, self._vals(vals, rows.shape))

    def add_c(self, cols, vals) -> None:
        """c[cols] += vals, shaped as in add_b."""
        cols = np.asarray(cols)
        idx = torch.as_tensor(cols.reshape(-1), device=self.device)
        self.c.index_add_(1, idx, self._vals(vals, cols.shape))

    def add_const(self, v) -> None:
        self.const = self.const + v

    def res_zero(self, rows, cols, J, v0) -> None:
        self.add_A(rows, cols, J)
        self.add_b(rows, -v0)

    def res_nonpos(self, rows, cols, J, v0) -> None:
        self.add_A(rows, cols, J)
        self.add_b(rows, -v0)

    def res_soc(self, rows, cols, J, v0) -> None:
        self.add_A(rows, cols, -J)
        self.add_b(rows, v0)

    # membership s = v in K_exp: the SOC's sign convention
    res_exp = res_soc

    def finish(self, S_full, c_full):
        """Apply the diagonal decision scaling d = S d_hat + c and return
        (A_hat, b_hat, c_hat, const_hat), each with the scenario dim."""
        A_hat = self.A * S_full
        b_hat = self.b - self.A @ c_full
        c_hat = self.c * S_full
        const = self.const + self.c @ c_full
        return A_hat, b_hat, c_hat, const


def soc_epigraph_quadratic(asm: Assembler, rows, d_cols, t_col: int, H, g,
                           c0, d0) -> None:
    """Post rows for  t >= 0.5 (d-d0)'H(d-d0) + g'(d-d0) + c0  as one SOC.

    With H = L L' (eigh, negative eigenvalues clipped to 0): tau := t -
    lin(d) and the block [(2 tau + 1)/2, (2 tau - 1)/2, L'd] in
    SOC(dim + 2). `rows` is a (1, dim + 2) SOC group reservation; H (dim,
    dim), g (dim,), c0 () and d0 (dim,) may carry a leading scenario dim.
    This is the bridging JuMP/MOI performs for quadratic objectives over
    ECOS (the reference's QuadraticCost, src/parser/cost.jl:68-107)."""
    dim = len(np.asarray(d_cols).reshape(-1))
    w, V = torch.linalg.eigh(H)
    Lt = torch.sqrt(torch.clamp(w, min=0.0))[..., :, None] * V.mT  # L'
    # lin(d) = (g - H d0)'d + (c0 + 0.5 d0'H d0 - g'd0)
    Hd0 = (H @ d0[..., None])[..., 0]
    lin_g = g - Hd0
    lin_c = c0 + 0.5 * (d0 * Hd0).sum(-1) - (g * d0).sum(-1)
    # v[0] = tau + 0.5, v[1] = tau - 0.5, v[2:] = L'd; cols [d..., t]
    J = torch.zeros(H.shape[:-2] + (dim + 2, dim + 1), dtype=H.dtype,
                    device=H.device)
    J[..., 0, :dim] = -lin_g
    J[..., 1, :dim] = -lin_g
    J[..., :2, dim] = 1.0
    J[..., 2:, :dim] = Lt
    v0 = torch.cat([torch.stack([-lin_c + 0.5, -lin_c - 0.5], -1),
                    torch.zeros(H.shape[:-2] + (dim,), dtype=H.dtype,
                                device=H.device)], -1)
    cols = np.concatenate([np.asarray(d_cols).reshape(-1), [t_col]])
    asm.res_soc(np.asarray(rows).reshape(-1), cols, J, v0)
