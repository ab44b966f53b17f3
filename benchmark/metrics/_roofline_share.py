"""A kernel share's roofline: the least time of the traced steps' launches
(the frozen work of `benchmark/roofline.py` at the wrappers' launch
shapes) over the profiler's device time of the share's kernels, %."""

import re
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
from benchmark import roofline  # noqa: E402

_MODE = re.compile(r"(panel_solve_kernel|solve_cluster_kernel)<[^,>]+,\s*"
                   r"\(?[A-Za-z_:]*\)?\s*(\w+)")


def share_of(name):
    """The roofline share a device kernel's name belongs to, or None."""
    if "lu_factor_" in name:
        return "lu_factor"
    if "lu_solve_rows" in name:
        return "lu_solve"
    if "cholesky" in name:
        return "cholesky"
    if "tri_solve_kernel" in name:
        return "tri_solve"
    m = _MODE.search(name)
    if m:
        mode = m.group(2)
        if mode in ("true", "false"):      # the Cholesky solves' clusters
            return "tri_solve"
        return "lu_solve" if mode in ("0", "kLU") else "tri_solve"
    return None


def read_share(rec, share):
    prof = rec["profile"]
    if not prof:
        return None
    t = sum(s for n, s in prof["kernels"].items() if share_of(n) == share)
    bound = roofline.bound_total(prof["shapes"], share)
    if t <= 0.0 or bound <= 0.0:
        return None
    return 100.0 * bound / t
