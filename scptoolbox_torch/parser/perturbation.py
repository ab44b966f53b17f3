"""Per-element perturbation specification for the variational (KKT) program.

Counterpart of `scptoolbox_tpu/parser/perturbation.py:21-85` (pure numpy;
the port keeps its own copy). Each element of a variable block is tagged
FREE (unbounded), FIXED (delta = 0), ABSOLUTE (|delta| <= amount) or
RELATIVE (|delta| <= amount * |nominal|); `parser.variation.Variation`
posts the matching rows on its delta variables.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Sequence, Union

import numpy as np


class PerturbationKind(enum.Enum):
    FREE = "free"
    FIXED = "fixed"
    ABSOLUTE = "absolute"
    RELATIVE = "relative"


FREE = PerturbationKind.FREE
FIXED = PerturbationKind.FIXED
ABSOLUTE = PerturbationKind.ABSOLUTE
RELATIVE = PerturbationKind.RELATIVE


@dataclasses.dataclass(frozen=True)
class Perturbation:
    """Per-element spec for one variable block: kinds and amounts of the
    block's shape. FREE forces amount inf, FIXED defaults it to 0,
    ABSOLUTE and RELATIVE require one."""

    kind: np.ndarray    # object array of PerturbationKind
    amount: np.ndarray  # float array, same shape

    @staticmethod
    def make(shape: Sequence[int],
             kind: Union[PerturbationKind, Sequence[PerturbationKind]],
             amount: Optional[Union[float, Sequence[float]]] = None
             ) -> "Perturbation":
        """kind: one kind for the whole block, one a element (reshaped to
        the block), or any shape that broadcasts to it."""
        shape = tuple(int(s) for s in shape) or (1,)
        k = np.empty(shape, dtype=object)
        if isinstance(kind, PerturbationKind):
            k[...] = kind
        else:
            karr = np.asarray(kind, dtype=object)
            if karr.size == int(np.prod(shape)):
                k = karr.reshape(shape).copy()
            else:
                k = np.broadcast_to(karr, shape).copy()
        a = np.full(shape, np.nan, dtype=float)
        if amount is not None:
            a[...] = np.broadcast_to(np.asarray(amount, float), shape)
        flat_k = k.reshape(-1)
        flat_a = a.reshape(-1)
        for i, ki in enumerate(flat_k):
            if ki == PerturbationKind.FREE:
                flat_a[i] = np.inf
            elif ki == PerturbationKind.FIXED:
                if np.isnan(flat_a[i]):
                    flat_a[i] = 0.0
            elif np.isnan(flat_a[i]):
                raise ValueError(
                    f"Perturbation is {ki} but amount was not specified")
        return Perturbation(kind=k, amount=a)


def perturbation(shape, kind, amount=None) -> Perturbation:
    """Perturbation.make(shape, kind, amount)."""
    return Perturbation.make(shape, kind, amount)
