"""Trajectory problem definition: a dataclass of pure PyTorch functions.

Counterpart of `scptoolbox_tpu/parser/problem.py` (`bind_consts` :49, the
cone constructors :65-116 with `geom` :107 and `exp_cone` :111,
`GuSTORunningCost` :127, `_taylor1` :163, `make_gusto_running_cost` :179,
`TrajectoryProblem` :231 with its `gusto_cost` / `force_hard` fields
:294-298, `constraint_structure` :332, `affine_blocks` / `quadratic_form`
:341-393). Constraints are functions returning cone-tagged
residual blocks (`ConeCon`); affine structure is extracted with
`torch.func.jacfwd` at the reference point (exact for the affine-in-decision
functions the contract requires), quadratic costs by `torch.func.hessian`.

Problem callbacks are written for one node and unbatched tensors (t and k
are 0-d tensors); the solvers map them over nodes and scenarios with
`torch.func.vmap`, so per-node logic uses `torch.where` on t or k, never a
Python branch on a tensor value.
"""

from __future__ import annotations

import dataclasses
import enum
import functools
import inspect
from typing import Any, Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import grad, grad_and_value, hessian, jacfwd


def wants_consts(fn: Optional[Callable]) -> bool:
    """True when a callback declares a `consts` parameter."""
    if fn is None:
        return False
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return False
    return "consts" in sig.parameters


def bind_consts(fn: Optional[Callable], consts) -> Optional[Callable]:
    """Bind the problem-constants tree into a callback that asks for it
    (keyword `consts`); other callbacks are returned as they are."""
    if fn is None or not wants_consts(fn):
        return fn
    return functools.partial(fn, consts=consts)


class ConeKind(enum.Enum):
    ZERO = "zero"      # v = 0
    NONPOS = "nonpos"  # v <= 0 elementwise
    SOC = "soc"        # v[0] >= ||v[1:]||_2
    L1 = "l1"          # v[0] >= ||v[1:]||_1   (lowered: aux slacks)
    LINF = "linf"      # v[0] >= max|v[1:]|    (lowered: linear rows)
    GEOM = "geom"      # geomean(v[1:]) >= v[0] (lowered to SOC(3) nodes)
    EXP = "exp"        # (x, y, z): y > 0, y e^{x/y} <= z (native rows)


class ConeCon(NamedTuple):
    """A residual vector tagged with its cone: `v in K`."""

    kind: ConeKind
    v: torch.Tensor


def _vec(v) -> torch.Tensor:
    v = torch.as_tensor(v)
    return v.reshape(1) if v.dim() == 0 else v


def zero(v) -> ConeCon:
    return ConeCon(ConeKind.ZERO, _vec(v))


def nonpos(v) -> ConeCon:
    return ConeCon(ConeKind.NONPOS, _vec(v))


def soc(v) -> ConeCon:
    return ConeCon(ConeKind.SOC, _vec(v))


def l1(v) -> ConeCon:
    return ConeCon(ConeKind.L1, _vec(v))


def linf(v) -> ConeCon:
    return ConeCon(ConeKind.LINF, _vec(v))


def geom(v) -> ConeCon:
    return ConeCon(ConeKind.GEOM, _vec(v))


def exp_cone(v) -> ConeCon:
    """v = (x, y, z) in K_exp = cl{y > 0, y e^{x/y} <= z}."""
    return ConeCon(ConeKind.EXP, _vec(v))


class BoundingBox(NamedTuple):
    """Per-dimension (min, max) scaling advice (numpy arrays)."""

    lo: np.ndarray
    hi: np.ndarray


class Constants:
    """A model's constant arrays as tensors, made once per dtype and device:
    `cst(x)["name"]` in a callback gives the array in the dtype and on the
    device of x (callbacks see tensors of the solver's dtype and device)."""

    def __init__(self, **arrays):
        self._np = arrays
        self._cache = {}

    def __call__(self, like):
        key = (like.dtype, like.device)
        c = self._cache.get(key)
        if c is None:
            c = {k: torch.as_tensor(v, dtype=like.dtype, device=like.device)
                 for k, v in self._np.items()}
            self._cache[key] = c
        return c


@dataclasses.dataclass(frozen=True)
class GuSTORunningCost:
    """GuSTO's structured running cost (reference problem.jl:365-418)

        Gamma(t, k, x, u, p) = u' S(t, k, p) u + ell(t, k, x, p)' u
                               + g(t, k, x, p),

    each term with a convexity flag. A `*_cvx=True` term is kept exact in
    the convex subproblem (so it must be affine or convex quadratic in the
    decision variables: S constant in p and PSD, ell constant in (x, p));
    a `*_cvx=False` term is linearized about the reference there
    (gusto.jl:570-707), while the true cost (J_aug, the ratio test) uses
    its exact value. Callables may be None (term absent):
    S(t, k, p[, consts]) -> (nu, nu); ell(t, k, x, p[, consts]) -> (nu,);
    g(t, k, x, p[, consts]) -> scalar. solvers.gusto.GuSTO turns it into a
    running cost with `make_gusto_running_cost`."""

    S: Optional[Callable] = None
    ell: Optional[Callable] = None
    g: Optional[Callable] = None
    S_cvx: bool = True
    ell_cvx: bool = True
    g_cvx: bool = True


def _taylor1(scalar_fn: Callable) -> Callable:
    """First-order wrapper: the value and gradient of `scalar_fn(d)` are
    exact at every point, but its Hessian under torch.func is zero
    (`detach` stops the tangents at d, as JAX's stop_gradient does), so
    the template's quadratic expansion about the reference posts the
    linearized term: value and gradient at the reference, no curvature."""

    def wrapped(d):
        d0 = d.detach()
        g0, v0 = grad_and_value(scalar_fn)(d0)
        return v0 + g0 @ (d - d0)

    return wrapped


def make_gusto_running_cost(spec: GuSTORunningCost, nx: int,
                            nu: int) -> Callable:
    """A `running_cost(t, k, x, u, p, consts=None)` from the structured
    triple: its value is the exact Gamma everywhere, and the terms flagged
    nonconvex are wrapped by _taylor1 so their Hessian vanishes."""
    terms = (("S", spec.S, spec.S_cvx), ("ell", spec.ell, spec.ell_cvx),
             ("g", spec.g, spec.g_cvx))

    def running_cost(t, k, x, u, p, consts=None):
        kw = {} if consts is None else {"consts": consts}

        def term(name, fn):
            def value(d):
                xx, uu, pp = d[:nx], d[nx:nx + nu], d[nx + nu:]
                args = (t, k, pp) if name == "S" else (t, k, xx, pp)
                v = fn(*args, **kw) if wants_consts(fn) else fn(*args)
                if name == "S":
                    return uu @ v @ uu
                return v @ uu if name == "ell" else v

            return value

        d = torch.cat([x, u, p])
        total = torch.zeros((), dtype=d.dtype, device=d.device)
        for name, fn, cvx in terms:
            if fn is not None:
                one = term(name, fn)
                total = total + (one(d) if cvx else _taylor1(one)(d))
        return total

    return running_cost


@dataclasses.dataclass
class TrajectoryProblem:
    """Definition of a nonconvex trajectory optimization problem.

    Required: nx, nu, np; dynamics `f(t, x, u, p) -> (nx,)` (under IMPULSE
    discretization the coasting field); `guess(N) -> (x (N, nx), u (N, nu),
    p (np,))` as numpy arrays.
    Optional: `jac` (analytic (A, B, F)), `impulse(t, x, u, p) -> (nx,)`
    (the state jump at each node under IMPULSE), `terminal_cost(xf, p)`,
    `running_cost(t, k, x, u, p)` (affine or convex quadratic), convex sets
    `X(t, k, x, p)` / `U(t, k, u, p)` returning lists of ConeCon, nonconvex
    path constraints `s(t, k, x, u, p) <= 0`, boundary conditions
    `gic(x, p)` / `gtc(x, p)` = 0, `integration_actions`, scaling advice
    `xrg/urg/prg`, `consts` bound into callbacks that declare it, a host
    `callback(rec: IterationRecord) -> bool` that the serial solvers call
    after every iteration (True vetoes stopping), user progress-table
    columns (`add_table_column`), GuSTO's structured running cost
    `gusto_cost` (used when `running_cost` is None) and `force_hard`, which
    keeps X hard under GuSTO (otherwise relaxed with indicator variables).
    Callbacks receive tensors of the solver's dtype and device; constants
    they create must follow the dtype and device of their arguments.
    """

    nx: int
    nu: int
    np: int
    f: Callable
    guess: Callable
    consts: Any = None
    jac: Optional[Callable] = None
    impulse: Optional[Callable] = None
    terminal_cost: Optional[Callable] = None
    running_cost: Optional[Callable] = None
    X: Optional[Callable] = None
    U: Optional[Callable] = None
    s: Optional[Callable] = None
    gic: Optional[Callable] = None
    gtc: Optional[Callable] = None
    integration_actions: Optional[Callable] = None
    xrg: Optional[BoundingBox] = None
    urg: Optional[BoundingBox] = None
    prg: Optional[BoundingBox] = None
    callback: Optional[Callable] = None
    gusto_cost: Optional[GuSTORunningCost] = None
    force_hard: bool = False
    # (key, heading, format, fn(rec: IterationRecord) -> value), appended to
    # the serial solvers' verbose tables
    table_columns: list = dataclasses.field(default_factory=list)

    def add_table_column(self, key: str, heading: str, fmt: str,
                         fn: Callable) -> None:
        """Append a custom progress-table column."""
        self.table_columns.append((key, heading, fmt, fn))

    def dims(self) -> Tuple[int, int, int]:
        return self.nx, self.nu, self.np


class AffineBlocks(NamedTuple):
    """v_i(args) = J_i @ cat(args) + v0_i, with the blocks' kinds/dims."""

    kinds: Tuple[ConeKind, ...]
    dims: Tuple[int, ...]
    J: torch.Tensor
    v0: torch.Tensor


def constraint_structure(fn: Callable, *example_args
                         ) -> Tuple[Tuple[ConeKind, ...], Tuple[int, ...]]:
    """The static structure of a constraint function (its blocks' kinds and
    dimensions), from one evaluation at example arguments."""
    cons = fn(*example_args)
    return (tuple(c.kind for c in cons),
            tuple(int(c.v.shape[0]) for c in cons))


def affine_blocks(fn: Callable, args: Sequence[torch.Tensor],
                  static_args: Sequence = ()) -> AffineBlocks:
    """(J, v0) of the stacked residuals of `fn(*static_args, *args)` with
    respect to cat(args), evaluated at `args`."""
    sizes = [int(a.shape[0]) for a in args]

    def stacked(vec):
        parts = torch.split(vec, sizes)
        cons = fn(*static_args, *parts)
        return torch.cat([c.v for c in cons])

    at = torch.cat(list(args))
    v_ref = stacked(at)
    J = jacfwd(stacked)(at).to(at.dtype)
    v0 = v_ref - J @ at
    cons = fn(*static_args, *args)
    return AffineBlocks(kinds=tuple(c.kind for c in cons),
                        dims=tuple(int(c.v.shape[0]) for c in cons),
                        J=J, v0=v0)


class QuadraticForm(NamedTuple):
    """J(d) = 0.5 (d-d0)'H(d-d0) + g'(d-d0) + c at a reference d0."""

    H: torch.Tensor
    g: torch.Tensor
    c: torch.Tensor
    d0: torch.Tensor


def quadratic_form(fn: Callable, args: Sequence[torch.Tensor],
                   static_args: Sequence = ()) -> QuadraticForm:
    """Quadratic form of `fn(*static_args, *args)` wrt cat(args)."""
    sizes = [int(a.shape[0]) for a in args]

    def scalar(vec):
        return fn(*static_args, *torch.split(vec, sizes))

    d0 = torch.cat(list(args))
    return QuadraticForm(H=hessian(scalar)(d0).to(d0.dtype),
                         g=grad(scalar)(d0).to(d0.dtype),
                         c=scalar(d0), d0=d0)
