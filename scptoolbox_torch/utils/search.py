"""Scalar minimization by golden-section search.

Counterpart of `scptoolbox_tpu/utils/search.py:golden` (reference
src/utils/helper.jl:291-331), used by the LCvx rocket landing to minimize the
fuel cost over the flight time. The reference's bracketing rule is kept: on a
rejected probe the bracket becomes (b, c), reversed, with the incumbent
kept, which re-enters a finite window of an objective that is +inf outside
it. The best of all probed points is returned.
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

_PHI = (1.0 + math.sqrt(5.0)) / 2.0


def golden(f: Callable[[float], float], a: float, b: float,
           tol: float = 1e-3) -> Tuple[float, float]:
    """Minimize f on [a, b] to bracket tolerance `tol`: (x_best, f(x_best))
    over all probed points, after ceil(log_phi((b - a) / tol) + 1) + 1
    evaluations."""
    a, b = float(a), float(b)
    if abs(b - a) <= tol:
        x = 0.5 * (a + b)
        return x, f(x)
    n = int(math.ceil(math.log((b - a) / tol) / math.log(_PHI) + 1.0))
    rho = _PHI - 1.0
    best_x, best_y = math.nan, math.inf

    def probe(x):
        nonlocal best_x, best_y
        y = f(x)
        if y < best_y or math.isnan(best_x):
            best_x, best_y = x, y
        return y

    d = rho * b + (1.0 - rho) * a
    yd = probe(d)
    for _ in range(n - 1):
        c = rho * a + (1.0 - rho) * b
        yc = probe(c)
        if yc < yd:
            b, d, yd = d, c, yc
        else:
            a, b = b, c
    y_final = probe(b)
    if y_final <= best_y:
        return b, y_final
    return best_x, best_y
