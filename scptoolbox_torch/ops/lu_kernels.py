"""Batched pivoted small-block LU: the Hopper kernels and their plain
PyTorch versions.

`lu_factor` / `lu_solve` replace the TPU kernels `lu_factor_lanes` /
`lu_solve_lanes` (scptoolbox_tpu/ops/pallas_kernels.py:373 `_lu_factor_kernel`
and :449 `_lu_solve_kernel`). Contract (scipy's lu_factor / lu_solve, per
matrix): the factor is a tableau with unit-L below the diagonal and U on and
above it, plus the per-step pivot-row record (int32); the pivot of step j is
the first row index of max |a_ij| over i >= j; a pivot below 1e-30 in
magnitude is floored with its sign kept when it is inverted. The solve
replays every recorded swap first (LAPACK laswp order), then runs the unit-L
forward and the U backward substitution.

On a CUDA tensor a wrapper launches its CUDA C++ kernel
(scptoolbox_torch/csrc/lu_kernels.cu, built with nvcc for sm_90a at first use
into scptoolbox_torch/_build/ and loaded with ctypes) or raises; on a CPU
tensor it runs the plain version. Each wrapper counts its kernel launches in
`<wrapper>.launches`.

What bounds the kernels on the H100, and what the designs do about it, is
noted at the top of the CUDA source: both are latency-bound chains of s
(factor) or 2s (solve) dependent steps. The factor takes a warp per matrix
up to s = 32 (rows in the lanes' registers, no block barrier), above it a
block per matrix in 32-column panels (one named barrier a column inside a
panel, three block barriers a panel, virtual row swaps), and where a matrix
does not fit in a block's shared memory (float64 above s = 168, float32
above 239) a cooperative grid over the SMs, the matrix in device memory,
in 32-column panels: one block factors a panel, then every SM updates
tiles of the trailing block, two grid-wide barriers a panel (a panel's
rows past what the block's registers and shared memory hold, float64
above s ~ 1300 and float32 above 2048, take their steps in device memory;
s up to ~22000 in float64, ~25000 in float32). The solve goes in 32-row panels
(csrc/panel_solve.cuh), three barriers a panel, the factor's panels staged
in shared memory ahead of their use; where two panels do not fit (float64
above s = 427, float32 above 842), a few matrices take thread-block
clusters (csrc/cluster_solve.cuh: the panels dealt over 8 or 16 blocks, one
cluster barrier a panel), and past those (more matrices than the card
holds clusters, or float64 above s ~ 6100) the same panels read the factor
from device memory on one block a matrix.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import torch

from scptoolbox_torch.ops import cuda_lib
from scptoolbox_torch.ops.cuda_lib import I, L, P

LIB = cuda_lib.CudaLibrary("lu_kernels", {
    "lu_factor_f32": (P, P, P, L, I, P), "lu_factor_f64": (P, P, P, L, I, P),
    "lu_solve_f32": (P, P, P, P, L, I, I, P),
    "lu_solve_f64": (P, P, P, P, L, I, I, P),
    "lu_factor_grid_f32": (P, P, P, P, P, L, I, P),
    "lu_factor_grid_f64": (P, P, P, P, P, L, I, P),
    "lu_factor_grid_words": (I,), "lu_factor_grid_max_s": (I,),
    "lu_design": (I, L, I, I, I),
    "lu_factor_shared_bytes": (I, I), "lu_max_shared_bytes": ()})

_TINY = 1e-30


# --------------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and the card's reference)
# --------------------------------------------------------------------------


def _pivot_recip(p: torch.Tensor) -> torch.Tensor:
    """sign(p) / max(|p|, 1e-30), NaN-propagating."""
    a = torch.abs(p)
    mag = torch.where(a < _TINY, torch.full_like(a, _TINY), a)
    return torch.where(p < 0, -1.0, 1.0).to(p.dtype) / mag


def lu_factor_plain(M: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched column loop with the kernel's pivot rule and floor:
    (..., s, s) -> (tableau (..., s, s), pivot record (..., s) int32)."""
    s = M.shape[-1]
    lead = M.shape[:-2]
    W = M.reshape(-1, s, s).clone()
    nb = W.shape[0]
    perm = torch.empty(nb, s, dtype=torch.int32, device=M.device)
    ar = torch.arange(nb, device=M.device)
    inf = torch.tensor(math.inf, dtype=M.dtype, device=M.device)
    for j in range(s):
        col = W[:, j:, j]
        cand = torch.where(torch.isnan(col), inf, torch.abs(col))
        r = torch.argmax(cand, dim=1) + j          # first maximum
        perm[:, j] = r.to(torch.int32)
        rowj = W[:, j, :].clone()
        W[:, j, :] = W[ar, r, :]
        W[ar, r, :] = rowj
        lcol = W[:, j + 1:, j] * _pivot_recip(W[:, j, j])[:, None]
        W[:, j + 1:, j + 1:].sub_(lcol[:, :, None]
                                  * W[:, j, None, j + 1:])
        W[:, j + 1:, j] = lcol
    return W.reshape(*lead, s, s), perm.reshape(*lead, s)


def lu_solve_plain(fac, B: torch.Tensor) -> torch.Tensor:
    """Solve (P L U) X = B for X: swaps, unit-L forward, U backward with the
    sign-kept 1e-30 floor. fac = (tableau (..., s, s), record (..., s)),
    B (..., s, K) with the same leading dims."""
    F, perm = fac
    s, K = B.shape[-2], B.shape[-1]
    lead = B.shape[:-2]
    Fm = F.reshape(-1, s, s)
    nb = Fm.shape[0]
    # the recorded swaps, composed in order (LAPACK's 1-based ipiv), as the
    # row each solution row is taken from: X = P' B for A = P L U
    Pm = torch.lu_unpack(Fm, perm.reshape(-1, s) + 1, unpack_data=False)[0]
    P = Pm.argmax(dim=-2)
    X = torch.gather(B.reshape(-1, s, K), 1, P[:, :, None].expand(nb, s, K))
    # views, made once: column j of the factor (nb, s, 1), row j of X
    # (nb, 1, K), the pivot reciprocals (nb, 1, 1)
    col = Fm.unsqueeze(-1).unbind(2)
    row = X.unsqueeze(1).unbind(2)
    for j in range(s - 1):
        n = s - j - 1
        X.narrow(1, j + 1, n).sub_(col[j].narrow(1, j + 1, n) * row[j])
    d = _pivot_recip(torch.diagonal(Fm, dim1=-2, dim2=-1))
    dj = d[:, :, None, None].unbind(1)
    for j in range(s - 1, 0, -1):
        X.narrow(1, 0, j).sub_(col[j].narrow(1, 0, j) * (row[j] * dj[j]))
    X = X * d[:, :, None]
    return X.reshape(*lead, s, K)


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _factor_shared_bytes(s: int, esize: int) -> int:
    """Shared memory one lu_factor launch at s x s needs."""
    return int(LIB.load().lu_factor_shared_bytes(s, esize))


@functools.lru_cache(maxsize=None)
def _max_shared_bytes(index: int) -> int:
    """Shared memory a block may use on card `index` (asked once)."""
    with torch.cuda.device(index):
        return int(LIB.load().lu_max_shared_bytes())


@functools.lru_cache(maxsize=None)
def _grid_words(index: int, s: int) -> int:
    """64-bit words of the grid design's position maps at s on card
    `index` (asked once)."""
    with torch.cuda.device(index):
        return int(LIB.load().lu_factor_grid_words(s))


@functools.lru_cache(maxsize=None)
def _grid_max_s(index: int, esize: int) -> int:
    """The largest s the grid design takes on card `index` (asked once)."""
    with torch.cuda.device(index):
        return int(LIB.load().lu_factor_grid_max_s(esize))


def lu_factor(M: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched pivoted LU of (..., s, s): the CUDA kernel on the card, the
    plain version on the CPU."""
    if M.device.type == "cpu":
        return lu_factor_plain(M)
    cuda_lib.check_cuda(M, "lu_factor")
    s = M.shape[-1]
    if M.shape[-2] != s:
        raise ValueError(f"lu_factor: square blocks expected, got {M.shape}")
    Mc = M.contiguous()
    out = torch.empty_like(Mc)
    perm = torch.empty(M.shape[:-1], dtype=torch.int32, device=M.device)
    nb = Mc.numel() // max(s * s, 1)
    if nb == 0 or s == 0:
        return out, perm
    need = _factor_shared_bytes(s, Mc.element_size())
    if need <= _max_shared_bytes(M.device.index):
        cuda_lib.launch(LIB, "lu_factor", M.dtype, M.device, Mc.data_ptr(),
                        out.data_ptr(), perm.data_ptr(), nb, s)
    else:       # the grid design: the matrices stay in device memory
        most = _grid_max_s(M.device.index, Mc.element_size())
        if s > most:
            raise ValueError(f"lu_factor: s={s} {M.dtype} is past a block's "
                             f"shared memory and past the grid design's "
                             f"s <= {most}")
        work = torch.empty_like(Mc)
        maps = torch.empty(_grid_words(M.device.index, s), dtype=torch.int64,
                           device=M.device)
        cuda_lib.launch(LIB, "lu_factor_grid", M.dtype, M.device,
                        Mc.data_ptr(), out.data_ptr(), perm.data_ptr(),
                        work.data_ptr(), maps.data_ptr(), nb, s)
    lu_factor.launches += 1
    cuda_lib.record("lu_factor", M.dtype, nb, s, s)
    return out, perm


lu_factor.launches = 0


def lu_solve(fac, B: torch.Tensor) -> torch.Tensor:
    """Solve the factored systems for B (..., s, K): the CUDA kernel on the
    card (one shared factor per matrix, any number of RHS columns), the
    plain version on the CPU."""
    F, perm = fac
    if B.device.type == "cpu":
        return lu_solve_plain(fac, B)
    cuda_lib.check_cuda(B, "lu_solve")
    s, K = B.shape[-2], B.shape[-1]
    if (F.shape[:-2] != B.shape[:-2] or F.shape[-2:] != (s, s)
            or perm.shape != F.shape[:-1] or F.dtype != B.dtype
            or perm.dtype != torch.int32 or F.device != B.device):
        raise ValueError(f"lu_solve: factor {tuple(F.shape)} {F.dtype}, "
                         f"record {tuple(perm.shape)} {perm.dtype} and RHS "
                         f"{tuple(B.shape)} {B.dtype} do not match")
    Fc, Pc, Bc = F.contiguous(), perm.contiguous(), B.contiguous()
    X = torch.empty_like(Bc)
    nb = Bc.numel() // max(s * K, 1)
    if nb == 0 or s == 0 or K == 0:
        return X
    cuda_lib.launch(LIB, "lu_solve", B.dtype, B.device, Fc.data_ptr(),
                    Pc.data_ptr(), Bc.data_ptr(), X.data_ptr(), nb, s, K)
    lu_solve.launches += 1
    cuda_lib.record("lu_solve", B.dtype, nb, s, K)
    return X


lu_solve.launches = 0


def reset_launch_counts() -> None:
    lu_factor.launches = 0
    lu_solve.launches = 0


def launch_counts() -> dict:
    return {"lu_factor": lu_factor.launches, "lu_solve": lu_solve.launches}
