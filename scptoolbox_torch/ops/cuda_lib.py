"""Build and bind the port's hand-written CUDA kernels.

Each kernel source `scptoolbox_torch/csrc/<name>.cu` has a plain C interface.
It is compiled with nvcc for sm_90a at first use into the git-ignored
`scptoolbox_torch/_build/` (one shared library per source, named by the
hash of the source, the shared headers `csrc/*.cuh` and the flags) and
loaded with ctypes; importing a kernel module builds nothing. `build_all`
starts one nvcc per source, all at once.

While `launch_shapes` is a Counter, every kernel launch of every wrapper adds
one under (kernel, dtype suffix, nb, n, K): the shapes a run gave the
kernels, at which chip_smoke.py then checks each kernel against its plain
version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Sequence, Tuple

import torch

_PKG = Path(__file__).resolve().parent.parent
BUILD_DIR = _PKG / "_build"
# -fmad=false: products and differences round as the plain versions'
# separate PyTorch operations do, so kernel and plain version can agree
# bit for bit
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC")
SUFFIX = {torch.float32: "f32", torch.float64: "f64"}

P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

launch_shapes = None


def record(kernel: str, dtype: torch.dtype, nb: int, n: int, K: int) -> None:
    if launch_shapes is not None:
        launch_shapes[(kernel, SUFFIX[dtype], nb, n, K)] += 1


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the kernels are built on the card's "
                       "machine (CUDA toolkit under /usr/local/cuda)")


class CudaLibrary:
    """One kernel source and the C functions it exports:
    `signatures` maps each function name to its ctypes argument types (the
    return type is int: a CUDA error code, 0 on success)."""

    def __init__(self, name: str,
                 signatures: Dict[str, Sequence[type]]):
        self.source = _PKG / "csrc" / f"{name}.cu"
        self.name = name
        self.signatures = signatures
        self.lib = None
        self._lock = threading.Lock()

    def path(self) -> Path:
        # the sources' shared headers are part of every build
        h = hashlib.sha256(self.source.read_bytes()
                           + " ".join(NVCC_FLAGS).encode())
        for header in sorted(self.source.parent.glob("*.cuh")):
            h.update(header.read_bytes())
        return BUILD_DIR / f"lib{self.name}_{h.hexdigest()[:16]}.so"

    def load(self):
        with self._lock:
            if self.lib is None:
                lib = ctypes.CDLL(str(build_all([self])[0]))
                for fn_name, argtypes in self.signatures.items():
                    fn = getattr(lib, fn_name)
                    fn.argtypes = list(argtypes)
                    fn.restype = I
                self.lib = lib
        return self.lib


def build_all(libraries: Iterable[CudaLibrary],
              verbose: bool = False) -> List[Path]:
    """Compile every library that is not built yet, one nvcc process per
    source, all started together. Returns their paths in order."""
    libraries = list(libraries)
    paths = [lib.path() for lib in libraries]
    jobs: List[Tuple[CudaLibrary, Path, Path, subprocess.Popen]] = []
    for lib, path in zip(libraries, paths):
        if path.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS] + (["-Xptxas", "-v"] if verbose
                                        else []) + ["-o", str(tmp),
                                                    str(lib.source)]
        jobs.append((lib, path, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for lib, path, tmp, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{lib.source.name}: nvcc exit {proc.returncode}\n"
                          f"{err}")
            continue
        if verbose and err:
            print(err)
        os.replace(tmp, path)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def check_cuda(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA or CPU tensor, got "
                         f"{t.device}")
    if t.dtype not in SUFFIX:
        raise TypeError(f"{what}: dtype {t.dtype} not supported "
                        "(float32, float64)")


def stream(dev: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def launch(lib: CudaLibrary, fn_name: str, dtype: torch.dtype,
           device: torch.device, *args) -> None:
    """Call `<fn_name>_<f32|f64>(*args, stream)` on the device; raises when
    the launch fails."""
    with torch.cuda.device(device):
        rc = getattr(lib.load(), f"{fn_name}_{SUFFIX[dtype]}")(
            *args, stream(device))
    if rc != 0:
        raise RuntimeError(f"{fn_name} kernel launch failed: CUDA error {rc}")
