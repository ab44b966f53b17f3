"""Scenario batches over torch.distributed (scptoolbox_torch/parallel/)
against the JAX package's mesh solves, on the CPU in float64.

The double integrator at refs.DI_MODEL / DI_PARS (N=15, Nsub=8) on the
dense KKT, B=8 guesses spread by 50% in x (scenarios 6 and 7 stop one
iteration before the others), 10 iterations: JAX's
`solve_batched_collective` on its 8-device virtual mesh is the reference of
the port's at world 1 (no process group, and a gloo group in this process)
and at world 4 (four gloo ranks from one `torch.multiprocessing.spawn`, on a
1-D mesh and on a 2 x 2 host x batch mesh). `solve_batched_sharded` and its
padded traces are held to the port's unsharded `solve_batched`."""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from scptoolbox_torch.config import SCPStatus
from scptoolbox_torch.parallel import (make_mesh, make_mesh_2d,
                                       scenario_sweep, shard_batch,
                                       solve_batched_collective,
                                       solve_batched_sharded)
from scptoolbox_torch.parallel import batch as tbatch
from scptoolbox_torch.solvers import ptr as tptr
from scptoolbox_tpu import parallel as jparallel
from tests import torch_dist_ranks as ranks
from tests import torch_refs as refs

torch.set_num_threads(1)

B, N_ITERS, SPREAD = 8, 10, 0.5
FIELDS = ("J_aug", "iters", "status", "n_feasible", "total_iters",
          "outer_iters")


def _batch(guess):
    gx, gu, gp = (np.asarray(a) for a in guess)
    scale = (1.0 + SPREAD * (np.arange(B) / B - 0.5))[:, None, None]
    return (gx[None] * scale, np.broadcast_to(gu, (B,) + gu.shape).copy(),
            np.broadcast_to(gp, (B,) + gp.shape).copy())


@pytest.fixture(scope="module")
def setup():
    J = refs.jax_di_ptr_dense()
    batch = _batch(J._guess)
    res = jparallel.solve_batched_collective(
        J, *(jnp.asarray(a) for a in batch), N_ITERS,
        mesh=jparallel.make_mesh(8))
    jres = {k: np.asarray(v) for k, v in res._asdict().items()}
    T = tptr.PTR(refs.tdi.double_integrator(
        refs.tdi.DoubleIntegratorParameters(**refs.DI_MODEL)),
        tptr.PTRParameters(**refs.DI_PARS), device="cpu")
    tb = tuple(torch.as_tensor(a) for a in batch)
    return J, jres, T, batch, tb, T.solve_batched(*tb, N_ITERS)


def _hold_to_jax(got, jres):
    """The port's collective results (numpy by field) against JAX's."""
    np.testing.assert_allclose(got["J_aug"], jres["J_aug"], rtol=1e-8)
    for k in FIELDS[1:]:
        np.testing.assert_array_equal(got[k], jres[k], err_msg=k)


def _hold_sharded(out, ref):
    """solve_batched_sharded's outputs (numpy by name, as the rank helper
    writes them) against the unsharded solve_batched's."""
    for k in ("x", "u", "p", "J_aug", "feas", "defect_norm"):
        np.testing.assert_array_equal(out[f"sharded_{k}"], ref[k].numpy(),
                                      err_msg=k)
    assert int(out["sharded_n_feasible"]) == int(ref["feas"].sum())
    assert int(out["sharded_n_traces"]) == len(ref["traces"])
    for i, tr in enumerate(ref["traces"]):
        for k, v in tr.items():
            np.testing.assert_array_equal(out[f"sharded_trace{i}_{k}"],
                                          v.numpy(), err_msg=f"{i} {k}")


def test_reference_run_stops_early_and_unevenly(setup):
    _, jres, _, _, _, ref = setup
    assert int(jres["n_feasible"]) == B
    assert np.all(jres["status"] == int(SCPStatus.SOLVED))
    assert int(jres["outer_iters"]) < N_ITERS
    # uneven stops: the sharded traces are padded on some rank
    assert len(set(jres["iters"].tolist())) > 1
    assert ref["iters"].tolist() == jres["iters"].tolist()


def test_world1_without_a_group_matches_jax(setup):
    _, jres, T, _, tb, ref = setup
    assert not dist.is_initialized()
    mesh = make_mesh()
    assert mesh.size() == 1 and mesh.mesh_dim_names == ("batch",)
    out = {}
    ranks.run_batches(T, *tb, N_ITERS, out, {"w1": mesh})
    _hold_to_jax({k: out[f"w1_{k}"] for k in FIELDS}, jres)
    # at world 1 the collective is solve_batched itself
    for k in ("J_aug", "iters", "status"):
        np.testing.assert_array_equal(out[f"w1_{k}"], ref[k].numpy())
    _hold_sharded(out, ref)


def test_world1_gloo_group_matches_jax(setup, tmp_path, monkeypatch):
    _, jres, T, _, tb, ref = setup
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/init",
                            world_size=1, rank=0)
    try:
        out = {}
        mesh2 = make_mesh_2d(1)
        assert mesh2.mesh_dim_names == ("host", "batch")
        ranks.run_batches(T, *tb, N_ITERS, out,
                          {"w1": make_mesh(1), "w1_2d": mesh2})
        # only nccl and gloo: no silent fallback for another backend
        monkeypatch.setattr(tbatch.dist, "get_backend", lambda *a: "mpi")
        with pytest.raises(ValueError, match="nccl or gloo"):
            tbatch.Collectives(mesh2)
    finally:
        monkeypatch.undo()
        dist.destroy_process_group()
    for tag in ("w1", "w1_2d"):
        _hold_to_jax({k: out[f"{tag}_{k}"] for k in FIELDS}, jres)
    _hold_sharded(out, ref)


@pytest.fixture(scope="module")
def world4(setup, tmp_path_factory):
    _, _, _, batch, _, _ = setup
    d = tmp_path_factory.mktemp("world4")
    mp.spawn(ranks.collective_ranks,
             args=(4, str(d / "init"), str(d), refs.DI_MODEL, refs.DI_PARS,
                   batch, N_ITERS), nprocs=4)
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(4)]


@pytest.mark.parametrize("tag", ["mesh1d", "mesh2d"])
def test_world4_collective_matches_jax(setup, world4, tag):
    _, jres, _, _, _, _ = setup
    for out in world4:           # every rank returns the global results
        _hold_to_jax({k: out[f"{tag}_{k}"] for k in FIELDS}, jres)
        for k in ("x", "u", "p", "feas"):
            np.testing.assert_array_equal(out[f"{tag}_{k}"],
                                          world4[0][f"{tag}_{k}"])


def test_world4_sharded_matches_solve_batched_with_padded_traces(setup,
                                                                world4):
    _, _, _, _, _, ref = setup
    # rank 3 holds scenarios 6 and 7, which stop first: its traces were
    # padded with frozen entries (NaN, False, 0)
    last = ref["traces"][-1]
    assert not bool(last["active"][6:].any())
    assert math.isnan(float(last["J_aug"][7]))
    for out in world4:
        _hold_sharded(out, ref)


def test_scenario_sweep_and_shard_batch(setup):
    _, _, T, batch, _, ref = setup
    scale = 1.0 + SPREAD * (torch.arange(B, dtype=torch.float64) / B - 0.5)
    res = scenario_sweep(T, lambda i, x, u, p: (x * scale[i], u, p), B,
                         N_ITERS)
    np.testing.assert_array_equal(res.J_aug.numpy(), ref["J_aug"].numpy())
    assert res.n_feasible == B and len(res.traces) == len(ref["traces"])
    got = shard_batch({"a": [torch.arange(4.0)]}, make_mesh())
    assert torch.equal(got["a"][0], torch.arange(4.0))
    with pytest.raises(ValueError, match="whole world"):
        make_mesh(2)
