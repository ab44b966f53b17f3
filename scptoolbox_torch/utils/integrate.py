"""Numerical integration: RK4 over tuples of tensors, trapezoid rules.

Counterpart of `scptoolbox_tpu/utils/integrate.py` (`rk4_step` :19,
`rk4` :38, `rk4_grid` :80, `trapz` :86, `grad_trapz` :95; reference
src/utils/helper.jl:350-591, with per-step state actions such as
quaternion renormalization).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


def _scal(a, y):
    """a * y, with a batch of scalars a (M,) broadcast over y (M, ...)."""
    if isinstance(a, torch.Tensor) and 0 < a.dim() < y.dim():
        a = a.reshape(a.shape + (1,) * (y.dim() - a.dim()))
    return a * y


def _axpy(a, y, z):
    if isinstance(y, torch.Tensor):
        return _scal(a, y) + z
    return type(z)(*(_scal(a, l) + m for l, m in zip(y, z)))


def rk4_step(f: Callable, x, t, dt):
    """One classical RK4 step for dx/dt = f(t, x). `x` is a tensor or a
    NamedTuple of tensors; `t` and `dt` may be (M,) tensors, one per entry
    of the state's leading batch dim."""
    k1 = f(t, x)
    k2 = f(t + dt / 2, _axpy(dt / 2, k1, x))
    k3 = f(t + dt / 2, _axpy(dt / 2, k2, x))
    k4 = f(t + dt, _axpy(dt, k3, x))
    if isinstance(x, torch.Tensor):
        ksum = k1 + 2 * k2 + 2 * k3 + k4
    else:
        ksum = type(x)(*(a + 2 * b + 2 * c + d
                         for a, b, c, d in zip(k1, k2, k3, k4)))
    return _axpy(dt / 6.0, ksum, x)


def _stack(first, rest):
    """first (...) followed by the list rest of the same, along a new
    leading dim; field by field for a NamedTuple state."""
    if isinstance(first, torch.Tensor):
        return torch.stack([first] + rest)
    return type(first)(*(_stack(a, [r[i] for r in rest])
                         for i, a in enumerate(first)))


def rk4(f: Callable, x0, t_grid: torch.Tensor,
        actions: Optional[Callable] = None, full: bool = False):
    """Integrate dx/dt = f(t, x) across t_grid (M,) with RK4 from x0 at
    t_grid[0]. `actions(x) -> x`, when given, is applied after every step
    (e.g. quaternion renormalization). Returns the final state, or with
    full=True the (M, ...) trajectory. x may be a tensor or a NamedTuple
    of tensors."""
    t0s = t_grid[:-1]
    dts = t_grid[1:] - t_grid[:-1]
    x = x0
    xs = []
    for t, dt in zip(t0s, dts):
        x = rk4_step(f, x, t, dt)
        if actions is not None:
            x = actions(x)
        xs.append(x)
    return _stack(x0, xs) if full else x


def rk4_grid(f: Callable, x0, t0, t1, nsub: int, actions=None,
             full: bool = False):
    """RK4 over nsub equal substeps on [t0, t1], in the dtype and on the
    device of x0."""
    leaf = x0 if isinstance(x0, torch.Tensor) else x0[0]
    t_grid = torch.linspace(float(t0), float(t1), nsub + 1,
                            dtype=leaf.dtype, device=leaf.device)
    return rk4(f, x0, t_grid, actions=actions, full=full)


def trapz(f_grid: torch.Tensor, t_grid: torch.Tensor) -> torch.Tensor:
    """Trapezoidal quadrature of samples f_grid (M, ...) over t_grid (M,)."""
    dt = t_grid[1:] - t_grid[:-1]
    mid = (f_grid[1:] + f_grid[:-1]) / 2.0
    if mid.dim() > 1:
        dt = dt.reshape((-1,) + (1,) * (mid.dim() - 1))
    return torch.sum(mid * dt, dim=0)


def grad_trapz(t_grid: torch.Tensor) -> torch.Tensor:
    """Gradient of trapz with respect to the samples: the quadrature
    weights (N,) (reference helper.jl:591)."""
    dt = t_grid[1:] - t_grid[:-1]
    w = torch.zeros_like(t_grid)
    w[:-1] += dt / 2.0
    w[1:] += dt / 2.0
    return w
