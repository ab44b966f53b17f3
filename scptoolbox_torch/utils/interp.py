"""Interpolation on time grids.

Counterpart of `scptoolbox_tpu/utils/interp.py` (`get_interval` :14,
`linterp` :23, `zohinterp` :38, `diracinterp` :51,
`straightline_interpolate` :63; reference src/utils/helper.jl:84-203).
Branch-free (searchsorted and gathers), on the device and dtype of the
grid.
"""

from __future__ import annotations

import torch


def _time(t, t_grid: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(t, dtype=t_grid.dtype, device=t_grid.device)


def _search_right(t_grid: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """numpy's searchsorted(t_grid, t, side="right") for scalar or
    batched t."""
    return torch.searchsorted(t_grid, t.reshape(-1), right=True).reshape(
        t.shape)


def get_interval(t, t_grid: torch.Tensor) -> torch.Tensor:
    """Index k with t_grid[k] <= t < t_grid[k+1], clipped to 0..N-2
    (reference helper.jl:84)."""
    t = _time(t, t_grid)
    k = _search_right(t_grid, t) - 1
    return torch.clamp(k, 0, t_grid.shape[0] - 2)


def linterp(t, f_grid: torch.Tensor, t_grid: torch.Tensor) -> torch.Tensor:
    """Piecewise-linear interpolation of f_grid (N, ...) at time t
    (reference helper.jl:107)."""
    t = _time(t, t_grid)
    k = get_interval(t, t_grid)
    t0 = t_grid[k]
    t1 = t_grid[k + 1]
    theta = torch.clamp((t - t0) / torch.clamp(t1 - t0, min=1e-300),
                        0.0, 1.0)
    f0 = f_grid[k]
    f1 = f_grid[k + 1]
    return f0 + theta * (f1 - f0)


def zohinterp(t, f_grid: torch.Tensor, t_grid: torch.Tensor
              ) -> torch.Tensor:
    """Zero-order hold: the value of the left grid node, the last node
    holding the last value (reference helper.jl:135)."""
    t = _time(t, t_grid)
    k = torch.clamp(_search_right(t_grid, t) - 1, 0, f_grid.shape[0] - 1)
    return f_grid[k]


def diracinterp(t, f_grid: torch.Tensor, t_grid: torch.Tensor
                ) -> torch.Tensor:
    """Impulse train: f_grid[k] where t is close to t_grid[k], else 0
    (reference helper.jl:166)."""
    hit = torch.isclose(_time(t, t_grid), t_grid)
    k = torch.argmax(hit.to(torch.int8))
    return torch.where(hit.any(), f_grid[k], torch.zeros_like(f_grid[0]))


def straightline_interpolate(v0, vf, N: int) -> torch.Tensor:
    """(N, dim) straight line from v0 to vf (reference helper.jl:203), in
    the dtype of a floating tensor v0 (else float64) and on v0's device."""
    dt = (v0.dtype if isinstance(v0, torch.Tensor)
          and v0.is_floating_point() else torch.float64)
    v0 = torch.atleast_1d(torch.as_tensor(v0, dtype=dt))
    vf = torch.atleast_1d(torch.as_tensor(vf, dtype=dt, device=v0.device))
    theta = torch.linspace(0.0, 1.0, N, dtype=dt, device=v0.device)[:, None]
    return v0[None, :] * (1 - theta) + vf[None, :] * theta
