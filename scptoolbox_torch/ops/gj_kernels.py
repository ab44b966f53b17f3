"""Batched Gauss-Jordan inverse of small blocks: the Hopper kernel and its
plain PyTorch version.

`gj_inverse` replaces the TPU kernel `gj_inverse`
(scptoolbox_tpu/ops/pallas_kernels.py:308, `_gj_kernel` :252). Contract, per
(s, s) block: the in-place Jordan exchange with the pivots taken in order on
the diagonal and no search; step j takes d = sign(p) / max(|p|, 1e-30) of
the pivot p = M[j, j] (NaN kept), scales row j by d, sets the pivot entry to
d and column j to -M[i, j] * d, and updates every other entry to
M[i, k] - M[i, j] * (M[j, k] * d). After s steps the block holds its inverse.
It is meant for blocks whose leading pivots all exist (Jacobi-equilibrated
quasidefinite blocks); the floor only keeps a zero pivot finite.

On a CUDA tensor the wrapper launches the CUDA C++ kernel
(scptoolbox_torch/csrc/gj_kernels.cu, built with nvcc for sm_90a at first
use, see ops/cuda_lib.py) or raises; on a CPU tensor it runs the plain
version. The kernel holds each matrix in registers, on one thread block or
on a cluster of 2-4 where one block's registers do not hold it; the
launcher picks from s and the dtype (`plan` reports it) and takes s <= 256.
The plain version does the kernel's operations in the same order, so on
the card the two agree bit for bit. `gj_inverse.launches` counts the kernel
launches.
"""

from __future__ import annotations

import ctypes

import torch

from scptoolbox_torch.ops import cuda_lib
from scptoolbox_torch.ops.cuda_lib import I, L, P
from scptoolbox_torch.ops.lu_kernels import _pivot_recip

LIB = cuda_lib.CudaLibrary("gj_kernels", {
    "gj_inverse_f32": (P, P, L, I, P), "gj_inverse_f64": (P, P, L, I, P),
    "gj_plan_f32": (I, P), "gj_plan_f64": (I, P)})
MAX_S = 256           # the kernel's widest tile: 8 columns a lane


def gj_inverse_plain(M: torch.Tensor) -> torch.Tensor:
    """The Jordan exchange, one pivot per step, batched."""
    s = M.shape[-1]
    W = M.reshape(M.shape[:-2].numel(), s, s).clone()
    for j in range(s):
        d = _pivot_recip(W[:, j, j])
        rowj = W[:, j, :] * d[:, None]
        colj = W[:, :, j].clone()
        W -= colj[:, :, None] * rowj[:, None, :]
        W[:, :, j] = -colj * d[:, None]
        W[:, j, :] = rowj
        W[:, j, j] = d
    return W.reshape(M.shape)


def gj_inverse(M: torch.Tensor) -> torch.Tensor:
    """Inverse of every (s, s) block of (..., s, s): the CUDA kernel on the
    card, the plain version on the CPU."""
    if M.device.type == "cpu":
        return gj_inverse_plain(M)
    cuda_lib.check_cuda(M, "gj_inverse")
    s = M.shape[-1]
    if M.dim() < 2 or M.shape[-2] != s:
        raise ValueError(f"gj_inverse: square blocks expected, got "
                         f"{tuple(M.shape)}")
    if s > MAX_S:
        raise ValueError(f"gj_inverse: blocks up to {MAX_S} wide, got {s}")
    Mc = M.contiguous()
    out = torch.empty_like(Mc)
    nb = Mc.numel() // max(s * s, 1)
    if nb == 0 or s == 0:
        return out
    cuda_lib.launch(LIB, "gj_inverse", M.dtype, M.device, Mc.data_ptr(),
                    out.data_ptr(), nb, s)
    gj_inverse.launches += 1
    cuda_lib.record("gj_inverse", M.dtype, nb, s, s)
    return out


def plan(s: int, dtype: torch.dtype) -> dict:
    """The launch the kernel makes for (s, s) blocks of `dtype`: C blocks a
    matrix, each of 16 warps holding R x CC tiles; raises where there is
    none."""
    out = (ctypes.c_int * 3)()
    rc = getattr(LIB.load(), f"gj_plan_{cuda_lib.SUFFIX[dtype]}")(
        s, ctypes.addressof(out))
    if rc != 0:
        raise ValueError(f"gj_inverse: no launch for {s}x{s} {dtype} "
                         f"(CUDA error {rc})")
    return dict(zip(("C", "R", "CC"), out))


gj_inverse.launches = 0


def reset_launch_counts() -> None:
    gj_inverse.launches = 0


def launch_counts() -> dict:
    return {"gj_inverse": gj_inverse.launches}
