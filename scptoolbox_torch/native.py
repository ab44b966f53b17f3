"""ctypes bindings for the native (C++) host IPM backend.

Counterpart of `scptoolbox_tpu/native.py` (`NativeSolution`, `available`,
`build_error`, `solve`). `native/ipm.cpp` implements the same HSDE
Mehrotra predictor-corrector conic IPM as `ops/ipm.py` in dependency-free
float64 C++, over zero, nonnegative and second-order cones (it has no
exponential cone). It serves as a cross-check of the device IPM and as the
host backend of small programs (`ConicProgram.solve(backend="native")`).

The shared library is built with g++ at first use into the git-ignored
`scptoolbox_torch/_build/`, named by the hash of the source and the flags;
each build writes a file of its own process and moves it into place, so
processes that build at once do not race. Importing this module builds
nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np

from scptoolbox_torch.ops.cones import ConeSpec
from scptoolbox_torch.ops.ipm import IPMStatus

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG.parent / "native" / "ipm.cpp"
BUILD_DIR = _PKG / "_build"
FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


class NativeSolution(NamedTuple):
    x: np.ndarray
    s: np.ndarray
    z: np.ndarray
    status: IPMStatus
    iters: int
    pres: float
    dres: float
    gap: float
    obj: float


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes() + " ".join(FLAGS).encode())
    return BUILD_DIR / f"libscptipm_{h.hexdigest()[:16]}.so"


def _build(force: bool = False) -> Path:
    """The library's path, compiled first where it is missing (or, with
    force, in any case)."""
    path = library_path()
    if path.exists() and not force:
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ exit {proc.returncode}: "
                           f"{proc.stderr[-2000:]}")
    os.replace(tmp, path)
    return path


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            try:
                lib = ctypes.CDLL(str(_build()))
            except OSError:
                # a library built by another machine's toolchain: once more
                lib = ctypes.CDLL(str(_build(force=True)))
        except (OSError, RuntimeError, subprocess.TimeoutExpired) as exc:
            _build_error = f"{type(exc).__name__}: {exc}"
            return None
        dptr = ctypes.POINTER(ctypes.c_double)
        iptr = ctypes.POINTER(ctypes.c_int)
        lib.scpt_ipm_solve.restype = ctypes.c_int
        lib.scpt_ipm_solve.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, iptr, dptr, dptr, dptr,
            ctypes.c_int, ctypes.c_double, ctypes.c_double,
            dptr, dptr, dptr, dptr,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    """True when the native backend could be built and loaded."""
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the library could not be built or loaded (None if it was)."""
    _load()
    return _build_error


def _host(a) -> np.ndarray:
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(a, np.float64))


def solve(A, b, c, spec: ConeSpec, *, tol: float = 1e-8,
          tol_almost: float = 1e-5, max_iter: int = 50) -> NativeSolution:
    """Solve min c'x s.t. Ax + s = b, s in K on the host in float64, with
    the status semantics of ops/ipm.py `solve`. A, b, c are numpy arrays
    or tensors on any device. Raises ValueError on a spec with
    exponential-cone blocks, which ipm.cpp does not have."""
    if spec.nexp:
        raise ValueError(f"the native IPM has no exponential cone "
                         f"({spec.nexp} exp blocks in the spec)")
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native backend unavailable: {_build_error}")
    A, b, c = _host(A), _host(b), _host(c)
    m, n = A.shape
    assert m == spec.m and b.shape == (m,) and c.shape == (n,)
    socs = np.asarray(spec.socs, np.int32)
    x = np.zeros(n)
    s = np.zeros(m)
    z = np.zeros(m)
    info = np.zeros(6)
    dptr = ctypes.POINTER(ctypes.c_double)
    iptr = ctypes.POINTER(ctypes.c_int)
    rc = lib.scpt_ipm_solve(
        m, n, spec.nz, spec.nl, len(spec.socs),
        socs.ctypes.data_as(iptr),
        A.ctypes.data_as(dptr), b.ctypes.data_as(dptr),
        c.ctypes.data_as(dptr),
        max_iter, tol, tol_almost,
        x.ctypes.data_as(dptr), s.ctypes.data_as(dptr),
        z.ctypes.data_as(dptr), info.ctypes.data_as(dptr),
    )
    if rc != 0:
        raise RuntimeError(f"scpt_ipm_solve failed with code {rc}")
    return NativeSolution(
        x=x, s=s, z=z, status=IPMStatus(int(info[0])), iters=int(info[1]),
        pres=float(info[2]), dres=float(info[3]), gap=float(info[4]),
        obj=float(info[5]))
