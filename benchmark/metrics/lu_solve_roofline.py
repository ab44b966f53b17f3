"""Kernels: `lu_solve`'s share of its roofline over the traced steps (see
`_roofline_share.py`), %."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "_bench_roofline_share", Path(__file__).with_name("_roofline_share.py"))
_share = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_share)


def read(rec):
    return _share.read_share(rec, "lu_solve")
