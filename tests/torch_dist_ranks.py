"""Rank functions of the port's torch.distributed tests, run in processes
that `torch.multiprocessing.spawn` starts: they import neither JAX nor the
test configuration, only torch, numpy and the port.

`collective_ranks` solves one scenario batch of the double integrator on a
gloo world with `solve_batched_collective` over a 1-D mesh of every rank
(and, at world 4, over a 2 x 2 host x batch mesh) and with
`solve_batched_sharded`, and writes each rank's results to
`<out_dir>/rank<r>.npz`."""

import os
from importlib import import_module

import numpy as np
import torch
import torch.distributed as dist


def _numpy(tree, prefix, out):
    for k, v in tree.items():
        if isinstance(v, torch.Tensor):
            out[prefix + k] = v.cpu().numpy()
        elif isinstance(v, (int, float)):
            out[prefix + k] = np.asarray(v)


def run_batches(solver, bx, bu, bp, n_iters, out, meshes):
    """The collective solve on each mesh of `meshes` ({tag: mesh}) and
    the sharded solve on the first, into `out` (numpy, by name)."""
    from scptoolbox_torch.parallel import (solve_batched_collective,
                                           solve_batched_sharded)

    first = None
    for tag, mesh in meshes.items():
        res = solve_batched_collective(solver, bx, bu, bp, n_iters,
                                       mesh=mesh)
        _numpy(res._asdict(), f"{tag}_", out)
        first = first or mesh
    sh = solve_batched_sharded(solver, bx, bu, bp, n_iters, mesh=first)
    _numpy({k: v for k, v in sh._asdict().items() if k != "traces"},
           "sharded_", out)
    out["sharded_n_traces"] = np.asarray(len(sh.traces))
    for i, tr in enumerate(sh.traces):
        _numpy(tr, f"sharded_trace{i}_", out)


def collective_ranks(rank, world, init_file, out_dir, model, pars, batch,
                     n_iters):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        from scptoolbox_torch.parallel import (make_mesh, make_mesh_2d,
                                               shard_batch)
        from scptoolbox_torch.solvers import ptr

        # the models package re-exports functions under the module names
        di = import_module("scptoolbox_torch.models.double_integrator")
        solver = ptr.PTR(di.double_integrator(
            di.DoubleIntegratorParameters(**model)),
            ptr.PTRParameters(**pars), device="cpu")
        bx, bu, bp = (torch.as_tensor(a) for a in batch)
        meshes = {"mesh1d": make_mesh(world)}
        if world == 4:
            mesh2 = make_mesh_2d(2, 2)
            assert mesh2.mesh_dim_names == ("host", "batch")
            meshes["mesh2d"] = mesh2
        try:                       # the mesh size must divide the batch
            shard_batch(torch.zeros(world + 1), meshes["mesh1d"])
        except AssertionError:
            pass
        else:
            raise RuntimeError("shard_batch took an indivisible batch")
        out = {}
        run_batches(solver, bx, bu, bp, n_iters, out, meshes)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()
