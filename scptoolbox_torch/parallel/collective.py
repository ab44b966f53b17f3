"""Batched PTR over a mesh with a global convergence vote.

Counterpart of `scptoolbox_tpu/parallel/collective.py` (`CollectiveResult`
:39, `solve_batched_collective` :54). Each rank owns B / world scenarios
and runs the batched PTR iteration (`PTR._batched_iteration`, the loop body
of `solve_batched`) on them; after every iteration the ranks all-reduce
their counts of active scenarios, and the whole fleet stops together once
no scenario anywhere is active or the budget is spent. A rank whose
scenarios have all stopped keeps voting but computes nothing. The feasible
count and the iteration total are all-reduced at the end, and the
per-scenario results gathered, so every rank returns the global batch.
The vote is one all-reduce over every dimension of the mesh (both of a
2-D host x batch mesh), as the JAX package's psum over
`mesh.axis_names`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from scptoolbox_torch.parallel.batch import (Collectives, make_mesh,
                                             shard_batch)


class CollectiveResult(NamedTuple):
    """Per-scenario outputs + all-reduced global statistics."""

    x: torch.Tensor            # (B, N, nx)
    u: torch.Tensor            # (B, N, nu)
    p: torch.Tensor            # (B, np)
    J_aug: torch.Tensor        # (B,)
    feas: torch.Tensor         # (B,) bool
    status: torch.Tensor       # (B,) int32 SCPStatus codes
    iters: torch.Tensor        # (B,) int32
    n_feasible: int            # summed over the mesh
    total_iters: int           # summed over the mesh
    outer_iters: int           # trips of the voting loop actually taken


def solve_batched_collective(solver, bx, bu, bp, n_iters: int,
                             mesh: Optional[DeviceMesh] = None,
                             axis: str = "batch") -> CollectiveResult:
    """Mesh-distributed batched PTR (`solver` a PTR instance) that stops
    as soon as the all-reduced number of active scenarios reaches zero,
    saving whole SCP iterations for easy batches. Every rank passes the
    whole batch and gets the whole result back; the mesh size must divide
    the batch."""
    if mesh is None:
        mesh = make_mesh(axis=axis)
    as_t = lambda a: torch.as_tensor(a, dtype=solver.dtype,
                                     device=solver.device)
    bx, bu, bp = shard_batch((as_t(bx), as_t(bu), as_t(bp)), mesh, axis)
    comm = Collectives(mesh)
    state = solver._batched_start(bx, bu, bp)
    active = comm.sum(bx.shape[0])
    it = 0
    while it < n_iters and active > 0:
        solver._batched_iteration(state, it)
        it += 1
        # the vote: the loop goes on while any scenario anywhere is active
        active = comm.sum((~state["done"]).sum())
    out = solver._batched_result(state)
    return CollectiveResult(
        x=comm.gather(out["x"]), u=comm.gather(out["u"]),
        p=comm.gather(out["p"]), J_aug=comm.gather(out["J_aug"]),
        feas=comm.gather(out["feas"]), status=comm.gather(out["status"]),
        iters=comm.gather(out["iters"]),
        n_feasible=comm.sum(out["feas"].sum()),
        total_iters=comm.sum(out["iters"].sum()), outer_iters=it)
