"""Fixed-width iteration progress table (host side).

Counterpart of `scptoolbox_tpu/utils/table.py` (`Column` :14, `Table` :27,
`improvement_percent` :66; reference src/utils/table.jl:26-221): columns of
a fixed width, the header printed before the first row and again after
`reset`, one row per SCP iteration from a dict.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence


class Column:
    """One table column: dict key, heading, format, width. The format may
    be given as "{:12.4e}" (str.format), "%12.4e" (printf) or "12.4e"."""

    def __init__(self, key: str, heading: str, fmt: str,
                 width: Optional[int] = None):
        self.key = key
        self.heading = heading
        if fmt.startswith("{:") and fmt.endswith("}"):
            fmt = fmt[2:-1]
        self.fmt = fmt
        self.width = max(width or 0, len(heading) + 2)


class Table:
    """Progress table printed one row per SCP iteration."""

    def __init__(self, columns: Sequence[Column],
                 print_fn: Callable[[str], None] = print):
        self.columns = list(columns)
        self._print = print_fn
        self._header_printed = False

    def reset(self):
        """Print the header again before the next row."""
        self._header_printed = False

    def _header(self) -> str:
        line = " |".join(c.heading.rjust(c.width) for c in self.columns)
        return line + "\n" + "-" * len(line)

    def print_row(self, row: Dict):
        """Print one row; a missing or None key leaves its cell blank."""
        if not self._header_printed:
            self._print(self._header())
            self._header_printed = True
        cells: List[str] = []
        for c in self.columns:
            if row.get(c.key) is not None:
                v = row[c.key]
                try:
                    cell = (c.fmt % v) if "%" in c.fmt else format(v, c.fmt)
                except (TypeError, ValueError):
                    cell = str(v)
            else:
                cell = ""
            cells.append(cell.rjust(c.width))
        self._print(" |".join(cells))


def improvement_percent(J_old: float, J_new: float) -> float:
    """Relative cost improvement in percent (NaN from a zero or non-finite
    old cost)."""
    if not math.isfinite(J_old) or J_old == 0.0:
        return float("nan")
    return (J_old - J_new) / abs(J_old) * 100.0
