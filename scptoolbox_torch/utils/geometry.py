"""Geometric helpers.

Counterpart of `scptoolbox_tpu/utils/geometry.py:skew` (reference
src/utils/helper.jl:65). The ellipsoid, hyperrectangle and homogeneous
transform helpers come with the models that use them.
"""

from __future__ import annotations

import torch


def skew(v) -> torch.Tensor:
    """3x3 cross-product (skew-symmetric) matrix of v: skew(v) w = v x w."""
    v = torch.as_tensor(v)
    z = torch.zeros((), dtype=v.dtype, device=v.device)
    return torch.stack([
        torch.stack([z, -v[2], v[1]]),
        torch.stack([v[2], z, -v[0]]),
        torch.stack([-v[1], v[0], z])])
