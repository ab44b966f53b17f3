"""Subproblem assembly: variable layout, cone row planning, and dense
(A, b, c) assembly for the IPM, batched over scenarios.

Counterpart of `scptoolbox_tpu/solvers/subproblem.py:33-197` (`VarLayout`,
`RowPlan` with its exp groups :95 and their place in `freeze` :119-127,
`Assembler` with `res_exp` :186). The structure (row/column indices) is
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

    res_nonpos = res_zero

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
