"""The library's dense LU, as the port's dense and staged KKTs call it.

On the CPU, `torch.linalg.lu_factor` of a batch of matrices larger than
128 x 128 does not return when PyTorch runs more than one intra-op thread
(MKL's getrf prints "Parameter 6 was incorrect on entry to SLASWP" or DLASWP
and spins; any data, finite or not, e.g. 2 x 158 x 158 at two threads), while
one matrix at a time works at any thread count. So on the CPU the batch is
factored one matrix at a time; on the card the batched call is kept.

The factor is `torch.linalg.lu_factor_ex`, which reports a zero pivot in
its `info` instead of raising as `torch.linalg.lu_factor` does: an exactly
singular block (a KKT matrix whose scaling underflowed) leaves its zero on
U's diagonal, and the solve gives inf or NaN, as LAPACK's and the JAX
package's `lu_factor` do; the IPM's guards then discard that step.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _factor(M):
    LU, piv, _ = torch.linalg.lu_factor_ex(M)
    return LU, piv


def lu_factor(M: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The library's pivoted LU of (..., n, n): (LU, 1-based pivots)."""
    lead = M.shape[:-2]
    if M.device.type != "cpu" or lead.numel() <= 1:
        return _factor(M)
    facs = [_factor(m) for m in M.reshape(-1, *M.shape[-2:])]
    return (torch.stack([f[0] for f in facs]).reshape(M.shape),
            torch.stack([f[1] for f in facs]).reshape(*lead, M.shape[-1]))
