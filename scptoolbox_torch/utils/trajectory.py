"""Continuous-time trajectory container.

Counterpart of `scptoolbox_tpu/utils/trajectory.py` (reference
src/utils/trajectory.jl:30-82): `ContinuousTimeTrajectory(t, x, interp)`
with linear, zero-order-hold and impulse sampling.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from scptoolbox_torch.utils.interp import diracinterp, linterp, zohinterp


class ContinuousTimeTrajectory(NamedTuple):
    """Sampled trajectory with an interpolation rule: "linear", "zoh" or
    "impulse"."""

    t: torch.Tensor  # (N,)
    x: torch.Tensor  # (N, dim)
    interp: str = "linear"


def sample(traj: ContinuousTimeTrajectory, t):
    """The trajectory at time t (reference trajectory.jl:71-82)."""
    if traj.interp == "linear":
        return linterp(t, traj.x, traj.t)
    if traj.interp == "zoh":
        return zohinterp(t, traj.x, traj.t)
    if traj.interp == "impulse":
        return diracinterp(t, traj.x, traj.t)
    raise ValueError(f"unknown interpolation '{traj.interp}'")
