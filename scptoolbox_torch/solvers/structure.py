"""KKT method resolution and stage-structure probing for the SCP solvers.

Counterpart of `scptoolbox_tpu/solvers/structure.py` (`resolve_kkt` :31,
`ipm_kkt_kwargs` :64, `random_dltv` :78, `build_kkt_builder` :87,
`build_staged_builder` :114). The port carries the normal-equations block
sweep (`ops/block_kkt.py`, the float64 auto choice for n >= 600 and what
`structured_kkt=True` forces), the five staged augmented methods of
`ops/aug_kkt.py` ("staged_lu", "staged_qr", "staged_cr", "staged_crpl",
"staged_crqd") and the dense ones ("schur", "lu", and "qrchol", the
null-space QR-Cholesky KKT of ops/ipm.py).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from scptoolbox_torch.ops.aug_kkt import (make_staged_cr_builder,
                                          make_staged_crpl_builder,
                                          make_staged_crqd_builder,
                                          make_staged_lu_builder,
                                          make_staged_qr_builder,
                                          probe_aug_structure)
from scptoolbox_torch.ops.block_kkt import make_kkt_builder, probe_structure
from scptoolbox_torch.ops.discretize import DLTV

STAGED_METHODS = ("staged_lu", "staged_qr", "staged_cr",
                  "staged_crpl", "staged_crqd")


def resolve_kkt(tmpl, probe, kkt_method, structured_kkt):
    """(effective kkt_method, kkt_builder) for a solver's request:
      * an explicit staged method is probed here; "schur", "lu" and
        "qrchol" pass through to ipm.solve;
      * auto, n >= 600, float32: "staged_cr";
      * auto, n >= 600, float64, or structured_kkt=True: the block sweep
        (build_kkt_builder; the dense Schur KKT where the probe fails);
      * otherwise the dense Schur KKT.
    A staged method whose probe fails (or "staged_lu" on a spec with exp
    cones) resolves with no builder: ipm_kkt_kwargs then takes the dense
    augmented LU."""
    if kkt_method in STAGED_METHODS:
        return kkt_method, build_staged_builder(
            tmpl, probe, variant=kkt_method.split("_", 1)[1])
    if kkt_method is not None:
        return kkt_method, None
    if (structured_kkt is None and tmpl.n >= 600
            and tmpl.dtype == torch.float32):
        return "staged_cr", build_staged_builder(tmpl, probe, variant="cr")
    return None, build_kkt_builder(tmpl, probe, enabled=structured_kkt)


def ipm_kkt_kwargs(kkt_method, kkt_builder) -> dict:
    """ipm.solve kwargs for the resolved pair: staged methods route through
    their probed builder (the dense augmented LU when probing failed)."""
    if kkt_method in STAGED_METHODS:
        if kkt_builder is not None:
            return dict(kkt_builder=kkt_builder, kkt_method=None)
        return dict(kkt_builder=None, kkt_method="lu")
    return dict(kkt_builder=None if kkt_method else kkt_builder,
                kkt_method=kkt_method)


def random_dltv(rng: np.random.Generator, N: int, nx: int, nu: int,
                npp: int, dtype, device) -> DLTV:
    """A random DLTV (scenario batch of one) drawn from numpy, in the JAX
    package's draw order, for sparsity probes."""
    r = lambda *sh: torch.as_tensor(rng.standard_normal(sh), dtype=dtype,
                                    device=device)[None]
    return DLTV(A=r(N - 1, nx, nx), Bm=r(N - 1, nx, nu),
                Bp=r(N - 1, nx, nu), F=r(N - 1, nx, npp),
                r=r(N - 1, nx), E=r(N - 1, nx, nx),
                defects=r(N - 1, nx), xprop=r(N - 1, nx))


def build_kkt_builder(tmpl, assemble: Callable[[int], np.ndarray],
                      enabled=None) -> Optional[Callable]:
    """The block-sweep builder of a frozen template, or None (the dense
    Schur KKT). enabled=None (auto): at n >= 600 in float64, where forming
    the dense H dominates (the float32 sweep loses enough accuracy that the
    SCP iterates diverge); True/False force it. None also when the probe
    finds a cone row spanning non-adjacent stages, and for specs with EXP
    cones (the stage classifier does not map their blocks)."""
    if tmpl.spec.nexp > 0:
        return None
    if enabled is None:
        enabled = tmpl.n >= 600 and tmpl.dtype == torch.float64
    if not enabled:
        return None
    st = probe_structure(tmpl.layout, tmpl.N, tmpl.spec, assemble)
    if st is None:
        return None
    return make_kkt_builder(st)


def build_staged_builder(tmpl, assemble: Callable[[int], np.ndarray],
                         variant: str) -> Optional[Callable]:
    """Probe the stage structure and return the augmented staged builder:
    "lu" (the forward LU stage sweep), "qr" (the band-QR sweep), "cr"
    (cyclic reduction on the library LU), "crpl" (the same on the
    hand-written LU kernels) or "crqd" (cyclic reduction with 2-Cholesky
    block inverses). None when the template does not fit the stage pattern,
    and for "lu" on a spec with exp cones (their W^2 blocks are dense 3x3,
    which only the NT-scaled sweeps avoid)."""
    if tmpl.spec.nexp > 0 and variant == "lu":
        return None
    st = probe_aug_structure(tmpl.layout, tmpl.N, tmpl.spec, assemble)
    if st is None:
        return None
    return {"lu": make_staged_lu_builder,
            "qr": make_staged_qr_builder,
            "cr": make_staged_cr_builder,
            "crpl": make_staged_crpl_builder,
            "crqd": make_staged_crqd_builder}[variant](st)
