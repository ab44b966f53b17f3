"""What a plain reference model gives the reference PTR step.

Every function acts on one node in float64 and is written with plain torch
operations, so that `torch.func.jacfwd` and `vmap` can take its Jacobians.
"""

from __future__ import annotations

import dataclasses
import importlib.util
from pathlib import Path
from typing import Callable, Optional

import numpy as np


@dataclasses.dataclass
class RefModel:
    nx: int
    nu: int
    np: int
    f: Callable                          # (t, x, u, p) -> dx/dt
    x_lo: np.ndarray                     # the scaling boxes (advice)
    x_hi: np.ndarray
    u_lo: np.ndarray
    u_hi: np.ndarray
    p_lo: np.ndarray = None
    p_hi: np.ndarray = None
    convex: Optional[Callable] = None    # (t, x, u, p) -> g, g <= 0 (affine)
    ncvx: Optional[Callable] = None      # (t, x, u, p) -> s, s <= vs
    gic: Optional[Callable] = None       # (x0, p) -> g, g = 0 (relaxed)
    gtc: Optional[Callable] = None       # (xN, p) -> g, g = 0 (relaxed)
    running: Optional[Callable] = None   # (t, x, u, p) -> convex quadratic
    terminal: Optional[Callable] = None  # (xN, p) -> linear
    check_guess: Optional[Callable] = None  # (x, u, p) numpy -> gap


def load(models_dir: Path, name: str, params: dict, N: int) -> RefModel:
    """The reference model `name` (file `<models_dir>/<name>.py`) with the
    model parameters `params`."""
    path = Path(models_dir) / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_bench_ref_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.make(dict(params), int(N))
