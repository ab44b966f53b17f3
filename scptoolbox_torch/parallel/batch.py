"""Scenario batches spread over the ranks of a `torch.distributed` world.

Counterpart of `scptoolbox_tpu/parallel/batch.py` (`make_mesh` :27,
`make_mesh_2d` :36, `shard_batch` :54, `BatchResult` :60,
`solve_batched_sharded` :73, `scenario_sweep` :94). One process runs per
rank (SPMD): every rank is given the whole batch, keeps its contiguous
B / world rows, solves them with `PTR.solve_batched` on its own device, and
the results are gathered back so that every rank returns the global batch.
Scenarios are independent, so nothing is exchanged inside the SCP loop.

A mesh is a `torch.distributed.device_mesh.DeviceMesh` over the whole
initialised world, 1-D ("batch") or 2-D ("host", "batch": the ranks of
one host in a row). Without a process group a mesh is a world of one, as
the JAX package's one-device mesh is, and nothing is communicated. The
collectives run on the group's own device: the card under NCCL, the CPU
under gloo (which takes CUDA tensors only for all_reduce and broadcast).
Any other backend raises.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

_BACKEND_DEVICE = {"nccl": "cuda", "gloo": "cpu"}


def _backend_device_type() -> str:
    """"cuda" under NCCL, "cpu" under gloo or without a process group."""
    if not dist.is_initialized():
        return "cpu"
    backend = str(dist.get_backend())
    if backend not in _BACKEND_DEVICE:
        raise ValueError(f"process-group backend {backend!r} is not "
                         "supported: use nccl or gloo")
    return _BACKEND_DEVICE[backend]


def _mesh(ranks: torch.Tensor, names: Sequence[str]) -> DeviceMesh:
    names = tuple(names)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if ranks.numel() != world:
        raise ValueError(f"a mesh spans the whole world: {ranks.numel()} "
                         f"ranks asked for, the world has {world}")
    if not dist.is_initialized():
        return DeviceMesh("cpu", ranks, mesh_dim_names=names,
                          _init_backend=False, _rank=0)
    return DeviceMesh(_backend_device_type(), ranks, mesh_dim_names=names)


def make_mesh(n_devices: Optional[int] = None,
              axis: str = "batch") -> DeviceMesh:
    """1-D mesh over the world's ranks (n_devices, when given, must be the
    world size)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = world if n_devices is None else int(n_devices)
    return _mesh(torch.arange(n), (axis,))


def make_mesh_2d(n_hosts: int, n_per_host: Optional[int] = None,
                 axes: Sequence[str] = ("host", "batch")) -> DeviceMesh:
    """2-D (host x batch) mesh over the world's ranks, host-major: rank r
    sits at (r // n_per_host, r % n_per_host), so each host's ranks form a
    row."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_per_host is None:
        assert world % n_hosts == 0, (world, n_hosts)
        n_per_host = world // n_hosts
    return _mesh(torch.arange(n_hosts * n_per_host).reshape(
        n_hosts, n_per_host), axes)


def _position(mesh: DeviceMesh) -> int:
    """This rank's place in the mesh's flattened (host-major) order."""
    rank = dist.get_rank() if dist.is_initialized() else 0
    return mesh.mesh.flatten().tolist().index(rank)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(tree, mesh: DeviceMesh, axis: str = "batch"):
    """Every tensor of `tree` (a tensor, or tuples, lists and dicts of
    them) cut to this rank's contiguous rows of its leading (scenario)
    dim, where the tensor is (the solvers put the batch on their device
    first). Every place of the mesh holds its own rows, whatever `axis`
    (kept from the JAX signature) names. The mesh size must divide the
    batch."""
    n_dev = mesh.size()
    pos = _position(mesh)

    def cut(a):
        a = torch.as_tensor(a)
        B = a.shape[0]
        assert B % n_dev == 0, f"batch {B} must divide mesh size {n_dev}"
        Bl = B // n_dev
        return a[pos * Bl:(pos + 1) * Bl]

    return _map(cut, tree)


class Collectives:
    """The reductions and gathers over every rank of a mesh, all its
    dimensions at once (one collective over the world it spans), on the
    group's own device; without a process group a world of one."""

    def __init__(self, mesh: DeviceMesh):
        self.on = dist.is_initialized()
        if self.on and mesh.size() != dist.get_world_size():
            raise ValueError("a mesh spans the whole world")
        self.ranks = mesh.mesh.flatten().tolist()   # the rank at each place
        self.device_type = _backend_device_type()

    def _to_comm(self, t: torch.Tensor) -> torch.Tensor:
        if self.device_type == "cuda":
            return t.to(torch.device("cuda", torch.cuda.current_device()))
        return t.cpu()

    def _reduce(self, value, op) -> int:
        t = self._to_comm(torch.as_tensor(value, dtype=torch.int64))
        if self.on:
            dist.all_reduce(t, op=op)
        return int(t)

    def sum(self, value) -> int:
        """The sum over the mesh of an integer count."""
        return self._reduce(value, dist.ReduceOp.SUM)

    def max(self, value) -> int:
        return self._reduce(value, dist.ReduceOp.MAX)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's rows concatenated in mesh order, on t's device."""
        if not self.on:
            return t
        dev, dtype = t.device, t.dtype
        c = self._to_comm(t.to(torch.uint8) if dtype == torch.bool else t)
        parts = [torch.empty_like(c) for _ in self.ranks]
        dist.all_gather(parts, c.contiguous())
        return torch.cat([parts[r] for r in self.ranks]).to(dev).to(dtype)


class BatchResult(NamedTuple):
    """Batched solve outputs + cross-scenario convergence summary."""

    x: torch.Tensor            # (B, N, nx)
    u: torch.Tensor            # (B, N, nu)
    p: torch.Tensor            # (B, np)
    J_aug: torch.Tensor        # (B,)
    feas: torch.Tensor         # (B,) bool
    defect_norm: torch.Tensor  # (B,)
    n_feasible: int
    traces: list               # per iteration, {name: (B,)}


def solve_batched_sharded(solver, bx, bu, bp, n_iters: int,
                          mesh: Optional[DeviceMesh] = None,
                          axis: str = "batch") -> BatchResult:
    """`solver.solve_batched` (a PTR instance) on this rank's share of the
    batch, then gathered: every rank returns the global (B, ...) results,
    traces and feasible count. The ranks stop at different iterations, so
    each pads its traces to the longest rank's with frozen entries; the
    gathered traces then equal those of one unsharded solve. The mesh size
    must divide the batch."""
    if mesh is None:
        mesh = make_mesh(axis=axis)
    as_t = lambda a: torch.as_tensor(a, dtype=solver.dtype,
                                     device=solver.device)
    bx, bu, bp = shard_batch((as_t(bx), as_t(bu), as_t(bp)), mesh, axis)
    out = solver.solve_batched(bx, bu, bp, n_iters)
    comm = Collectives(mesh)
    n_tr = comm.max(len(out["traces"]))
    traces = out["traces"]
    traces = traces + [solver.frozen_trace(bx.shape[0])
                       for _ in range(n_tr - len(traces))]
    traces = [{k: comm.gather(v) for k, v in tr.items()} for tr in traces]
    feas = comm.gather(out["feas"])
    return BatchResult(
        x=comm.gather(out["x"]), u=comm.gather(out["u"]),
        p=comm.gather(out["p"]), J_aug=comm.gather(out["J_aug"]),
        feas=feas, defect_norm=comm.gather(out["defect_norm"]),
        n_feasible=int(feas.sum()), traces=traces)


def scenario_sweep(solver, perturb: Callable, B: int, n_iters: int,
                   mesh: Optional[DeviceMesh] = None) -> BatchResult:
    """Monte-Carlo / sweep harness: the B scenario guesses are
    `perturb(i, x, u, p) -> (x, u, p)` of the solver's guess for
    i = 0..B-1, built on the host, then solved by solve_batched_sharded."""
    gx, gu, gp = solver._guess
    guesses = [perturb(i, gx, gu, gp) for i in range(B)]
    bx, bu, bp = (torch.stack([torch.as_tensor(g[k]) for g in guesses])
                  for k in range(3))
    return solve_batched_sharded(solver, bx, bu, bp, n_iters, mesh=mesh)
