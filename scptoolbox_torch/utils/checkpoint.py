"""Checkpoint and resume: SCP solver state on disk.

Counterpart of `scptoolbox_tpu/utils/checkpoint.py`, in its format: a
numpy .npz with a JSON entry (`__meta_json__`) for the scalar metadata and
no pickle, so a file written by either package loads in the other.

  * `save_solution` / `load_solution`: a whole SCPSolution (trajectory,
    history, continuous-time replay), loadable as the `warm=` argument of
    a solver's `solve()` in another process (the reference's in-memory
    warm_start, scp.jl:532-539, across processes);
  * `save_state` / `load_state`: any flat dict of arrays, tensors (from any
    device) and scalars, e.g. a homotopy ladder's position mid-solve.
"""

from __future__ import annotations

import json
from typing import Any, Dict

import numpy as np
import torch

from scptoolbox_torch.config import SCPStatus
from scptoolbox_torch.solvers.solution import IterationRecord, SCPSolution

_META_KEY = "__meta_json__"


def _norm_path(path) -> str:
    """np.savez appends '.npz' to a path without it; both save and load
    do the same, so that save_state('ckpt') / load_state('ckpt') agree."""
    path = str(path)
    return path if path.endswith(".npz") else path + ".npz"


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def save_state(path: str, state: Dict[str, Any]) -> None:
    """Save a flat dict of arrays / tensors / scalars / strings to `path`
    (.npz)."""
    path = _norm_path(path)
    arrays = {}
    meta = {}
    for k, v in state.items():
        assert k != _META_KEY, f"reserved key {k}"
        if isinstance(v, (str, bool, int, float)) or v is None:
            meta[k] = v
        else:
            arrays[k] = _host(v)
    np.savez(path, **arrays, **{_META_KEY: np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8)})


def load_state(path: str) -> Dict[str, Any]:
    """Inverse of save_state (arrays come back as numpy)."""
    out: Dict[str, Any] = {}
    with np.load(_norm_path(path), allow_pickle=False) as data:
        for k in data.files:
            if k == _META_KEY:
                out.update(json.loads(bytes(data[k]).decode()))
            else:
                out[k] = data[k]
    return out


def save_solution(path: str, sol: SCPSolution) -> None:
    """Serialize an SCPSolution (with its per-iteration history; its
    arrays may be tensors on any device) so that a later process can
    `solver.solve(warm=load_solution(path))`. Not kept, as the format has
    no pickle: `SCPSolution.extras` and each record's `extras` / `timing`
    (loaded records get empty dicts)."""
    state: Dict[str, Any] = {
        "status": int(sol.status),
        "algorithm": sol.algorithm,
        "iterations": int(sol.iterations),
        "xd": sol.xd, "ud": sol.ud, "p": sol.p,
        "cost": float(sol.cost),
        "t_grid": sol.t_grid,
        "feas": bool(sol.feas),
        "n_history": len(sol.history),
    }
    if sol.t_cont is not None:
        state["t_cont"] = sol.t_cont
        state["x_cont"] = sol.x_cont
    for i, rec in enumerate(sol.history):
        state[f"h{i}_x"] = rec.x
        state[f"h{i}_u"] = rec.u
        state[f"h{i}_p"] = rec.p
        state[f"h{i}_scalars"] = np.asarray([
            float(v) for v in (
                rec.iteration, rec.J_aug, rec.J_orig, rec.feas,
                rec.deviation, rec.improv_rel, rec.ipm_status,
                rec.ipm_iters, rec.defect_norm, rec.vd_norm,
                rec.vs_norm)], dtype=np.float64)
    save_state(path, state)


def load_solution(path: str) -> SCPSolution:
    """Inverse of save_solution (arrays come back as numpy)."""
    st = load_state(path)
    history = []
    for i in range(int(st["n_history"])):
        s = st[f"h{i}_scalars"]
        history.append(IterationRecord(
            iteration=int(s[0]), x=st[f"h{i}_x"], u=st[f"h{i}_u"],
            p=st[f"h{i}_p"], J_aug=float(s[1]), J_orig=float(s[2]),
            feas=bool(s[3]), deviation=float(s[4]), improv_rel=float(s[5]),
            ipm_status=int(s[6]), ipm_iters=int(s[7]),
            defect_norm=float(s[8]), vd_norm=float(s[9]),
            vs_norm=float(s[10])))
    return SCPSolution(
        status=SCPStatus(int(st["status"])),
        algorithm=st["algorithm"],
        iterations=int(st["iterations"]),
        xd=st["xd"], ud=st["ud"], p=st["p"],
        cost=float(st["cost"]), t_grid=st["t_grid"],
        feas=bool(st["feas"]), history=history,
        t_cont=st.get("t_cont"), x_cont=st.get("x_cont"))
