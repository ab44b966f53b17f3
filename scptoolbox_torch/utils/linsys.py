"""Exact zero- and first-order-hold discretization via the matrix
exponential.

Counterpart of `scptoolbox_tpu/utils/linsys.py` (`c2d_zoh` :19, `c2d_foh`
:35, `expm_diff` :60).
"""

from __future__ import annotations

from typing import Tuple

import torch


def c2d_zoh(A: torch.Tensor, B: torch.Tensor, dt
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact zero-order-hold discretization of dx/dt = A x + B u: (Ad, Bd)
    with x+ = Ad x + Bd u, from exp([[A, B], [0, 0]] dt). dt may be a
    tensor (differentiable, as the rocket landing's flight time is)."""
    n, m = A.shape[0], B.shape[1]
    M = torch.cat([torch.cat([A, B], dim=1),
                   torch.zeros(m, n + m, dtype=A.dtype, device=A.device)],
                  dim=0)
    E = torch.linalg.matrix_exp(M * dt)
    return E[:n, :n], E[:n, n:]


def c2d_foh(A: torch.Tensor, B: torch.Tensor, dt
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact first-order-hold discretization of dx/dt = A x + B u.

    Returns (Ad, Bm, Bp) with x+ = Ad x + Bm u_k + Bp u_{k+1}, from the
    augmented exponential exp([[A, B, 0], [0, 0, I/dt], [0, 0, 0]] dt)."""
    n, m = A.shape[0], B.shape[1]
    dt = torch.as_tensor(dt, dtype=A.dtype, device=A.device)
    eye = torch.eye(m, dtype=A.dtype, device=A.device) / dt
    z = lambda r, c: torch.zeros(r, c, dtype=A.dtype, device=A.device)
    M = torch.cat([
        torch.cat([A, B, z(n, m)], dim=1),
        torch.cat([z(m, n), z(m, m), eye], dim=1),
        z(m, n + 2 * m)], dim=0)
    E = torch.linalg.matrix_exp(M * dt)
    Ad = E[:n, :n]
    I1 = E[:n, n:n + m]
    I2 = E[:n, n + m:]
    return Ad, I1 - I2, I2


def expm_diff(A, dA, t=1.0) -> torch.Tensor:
    """Directional derivative of the matrix exponential,
    d/deps expm((A + eps dA) t) at eps = 0, by forward-mode AD (reference
    helper.jl:532 integrates a block-augmented system for it)."""
    A = torch.as_tensor(A)
    dA = torch.as_tensor(dA, dtype=A.dtype, device=A.device)
    return torch.func.jvp(lambda M: torch.linalg.matrix_exp(M * t), (A,),
                          (dA,))[1]
