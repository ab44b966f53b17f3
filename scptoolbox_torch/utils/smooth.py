"""Smooth approximations of discrete logic, and the homotopy schedule.

Counterpart of `scptoolbox_tpu/utils/smooth.py` (`logsumexp` :17, `sigmoid`
:30, `indicator` :38, `smooth_or` :44, `Homotopy` :65; reference
src/utils/helper.jl:623-807 and src/utils/homotopy.jl:22-73). Derivatives
come from torch.func.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch


def logsumexp(f, kappa=1.0):
    """Stable (1/kappa) log(sum(exp(kappa f))) over the last axis: tends to
    max(f) from above as kappa grows."""
    z = kappa * torch.as_tensor(f)
    m = torch.amax(z, dim=-1, keepdim=True)
    return (m[..., 0] + torch.log(torch.sum(torch.exp(z - m), dim=-1))) / kappa


def sigmoid(x, kappa=1.0):
    """Logistic sigmoid of sharpness kappa (tends to the step at x = 0)."""
    return 0.5 * (torch.tanh(0.5 * kappa * torch.as_tensor(x)) + 1.0)


def indicator(x, kappa=1.0):
    """Smooth indicator that x >= 0: sigmoid(x; kappa)."""
    return sigmoid(x, kappa)


def smooth_or(predicates: Sequence, kappa=1.0, *, match=None, normalize=1.0):
    """Smooth OR of the conditions "p >= 0": the sigmoid of the smooth max
    of p / normalize at sharpness kappa. With `match`, the curve is shifted
    so that OR is exactly 1 where a predicate reaches `match`, the value the
    exact indicator would give."""
    stacked = torch.stack([torch.as_tensor(p) for p in predicates], dim=-1)
    val = sigmoid(logsumexp(stacked / normalize, kappa), kappa)
    if match is not None:
        m = torch.atleast_1d(torch.as_tensor(
            match, dtype=stacked.dtype, device=stacked.device)) / normalize
        val = val + 1.0 - sigmoid(logsumexp(m, kappa), kappa)
    return val


class Homotopy(NamedTuple):
    """Exponential continuation schedule for a sharpness parameter:
    h(x) = log(1/eps - 1) / (rho^x delta_max), rho = delta_min / delta_max,
    so the sigmoid's transition half-width is delta_max at x = 0 and
    delta_min at x = 1 (within eps of the exact step at its edge)."""

    delta_min: float = 1e-8
    delta_max: float = 1.0
    eps: float = 1e-2

    @property
    def rho(self) -> float:
        return self.delta_min / self.delta_max

    def __call__(self, x):
        x = torch.as_tensor(x, dtype=torch.float64)
        return torch.log(torch.as_tensor(1.0 / self.eps - 1.0,
                                         dtype=torch.float64)) / (
            self.rho ** x * self.delta_max)
