"""Scenario batches over torch.distributed (scptoolbox_torch/parallel/) on
the card: an NCCL group of one rank on a FileStore, the collective solve
(on "staged_crpl", the LU kernels) and the sharded solve (the dense Schur
KKT's Cholesky ladder) against `PTR.solve_batched` on the same scenarios,
float32. At world 1 both must equal it exactly (at N=15 the float32
Schur ladder leaves these scenarios infeasible after 10 iterations, as the
plain solve_batched does; the collective on the LU kernels solves them
all). Everything here carries the `cuda` marker and skips where there is
no CUDA device.

This file imports neither JAX nor the JAX package, so that it also runs on a
machine with the card and without JAX:

    python -m pytest --noconftest tests/test_torch_parallel_card.py
"""

from importlib import import_module

import pytest
import torch
import torch.distributed as dist

from scptoolbox_torch.config import SCPStatus
from scptoolbox_torch.parallel import (make_mesh, make_mesh_2d,
                                       solve_batched_collective,
                                       solve_batched_sharded)
from scptoolbox_torch.solvers import ptr

# bench.py:33-36, cut to N=15, Nsub=8
MODEL = dict(drag=True, g=0.01, s=30.0)
PARS = dict(N=15, Nsub=8, wvc=1e3, wtr=5e-3, ipm_tol=3e-6, ipm_max_iter=30)
B, N_ITERS = 16, 10


@pytest.mark.cuda
def test_without_a_group_a_mesh_is_a_world_of_one():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert not dist.is_initialized()
    assert make_mesh().size() == 1
    assert make_mesh_2d(1).mesh_dim_names == ("host", "batch")
    solver, batch = _solver_and_batch("staged_crpl")
    res = solve_batched_collective(solver, *batch, N_ITERS)
    assert torch.equal(res.J_aug, solver.solve_batched(*batch,
                                                       N_ITERS)["J_aug"])


@pytest.fixture(scope="module")
def nccl(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: NCCL and the kernels run only on "
                    "the card")
    torch.cuda.set_device(0)
    store = tmp_path_factory.mktemp("nccl") / "store"
    dist.init_process_group("nccl", store=dist.FileStore(str(store), 1),
                            world_size=1, rank=0)
    yield make_mesh()
    dist.destroy_process_group()


def _solver_and_batch(kkt_method):
    di = import_module("scptoolbox_torch.models.double_integrator")
    solver = ptr.PTR(di.double_integrator(di.DoubleIntegratorParameters(
        **MODEL)), ptr.PTRParameters(**PARS, kkt_method=kkt_method),
        dtype=torch.float32, device="cuda")
    gx, gu, gp = solver._guess
    scale = 1.0 + 0.1 * (torch.arange(B, dtype=torch.float32,
                                      device="cuda") / B - 0.5)
    return solver, (gx[None] * scale[:, None, None],
                    gu[None].expand(B, *gu.shape).clone(),
                    gp[None].expand(B, *gp.shape).clone())


@pytest.mark.cuda
def test_nccl_collective_equals_solve_batched(nccl):
    assert str(dist.get_backend()) == "nccl"
    solver, batch = _solver_and_batch("staged_crpl")
    res = solve_batched_collective(solver, *batch, N_ITERS, mesh=nccl)
    ref = solver.solve_batched(*batch, N_ITERS)
    for k in ("J_aug", "iters", "status", "feas", "x"):
        assert torch.equal(getattr(res, k), ref[k]), k
    assert res.n_feasible == B
    assert bool((res.status == int(SCPStatus.SOLVED)).all())
    assert res.outer_iters == int(ref["iters"].max()) < N_ITERS
    assert res.total_iters == int(ref["iters"].sum())


@pytest.mark.cuda
def test_nccl_sharded_equals_solve_batched(nccl):
    solver, batch = _solver_and_batch(None)
    res = solve_batched_sharded(solver, *batch, N_ITERS, mesh=nccl)
    ref = solver.solve_batched(*batch, N_ITERS)
    for k in ("J_aug", "feas", "x", "defect_norm"):
        assert torch.equal(getattr(res, k), ref[k]), k
    assert res.n_feasible == int(ref["feas"].sum())
    assert len(res.traces) == len(ref["traces"])
    for got, want in zip(res.traces, ref["traces"]):
        for k, v in want.items():
            assert torch.equal(got[k].nan_to_num(), v.nan_to_num()), k
