"""The stage-structured KKT (scptoolbox_torch/ops/block_kkt.py) on the card:
its block sweep on the CUDA Cholesky and triangular-solve kernels against
the same class on CPU tensors (the kernels' plain versions), in float64, on
the double integrator's first PTR subproblem at N=15 with the block sweep
forced. Everything here carries the `cuda` marker and skips where there is
no CUDA device.

This file imports neither JAX nor the JAX package, so that it also runs on a
machine with the card and without JAX:

    python -m pytest --noconftest tests/test_torch_block_kkt_card.py
"""

import numpy as np
import pytest
import torch

from scptoolbox_torch.models.double_integrator import double_integrator
from scptoolbox_torch.ops import chol_kernels as ck
from scptoolbox_torch.ops import cones as cn
from scptoolbox_torch.ops import ipm
from scptoolbox_torch.solvers import ptr

REG = 1e-10


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def subproblem(card):
    """(solver, A, b, c) on the CPU, float64."""
    S = ptr.PTR(double_integrator(), ptr.PTRParameters(
        N=15, Nsub=8, iter_max=3, structured_kkt=True), device="cpu")
    assert S.kkt_builder is not None
    x, u, p = (a[None] for a in S._guess)
    A, b, c, _ = S._assemble(x, u, p, S._discretize(x, u, p), S.consts)
    return S, A, b, c


def _interior(spec, rng):
    """A strictly interior cone point, zero on the zero-cone rows."""
    v = np.abs(rng.standard_normal(spec.m)) + 0.5
    off = spec.nz + spec.nl
    for d in spec.socs:
        w = rng.standard_normal(d - 1) * 0.2
        v[off] = np.linalg.norm(w) + 1.0
        v[off + 1: off + d] = w
        off += d
    v[: spec.nz] = 0.0
    return v


def _solve(S, A, W, rhs):
    mask = torch.as_tensor(S.spec.cone_mask(), dtype=A.dtype,
                           device=A.device)
    kkt = S.kkt_builder(S.spec, A, REG, mask)
    return kkt.solve(kkt.factor(W), rhs)


@pytest.mark.cuda
@pytest.mark.parametrize("nb,scaled", [(1, True), (1, False), (3, True)])
def test_block_kkt_on_card_matches_cpu(card, subproblem, nb, scaled):
    """Factor and solve, two right-hand sides, at nb NT scalings (or W =
    None): the card within a relative 1e-10 of the CPU, every Cholesky
    kernel launched and none of the work left to the CPU."""
    S, A, _, _ = subproblem
    spec = S.spec
    rng = np.random.default_rng(nb)
    A = A.expand(nb, -1, -1).contiguous()
    rhs = torch.as_tensor(rng.standard_normal((nb, A.shape[1] + A.shape[2],
                                               2)))
    W = W_gpu = None
    if scaled:
        s, z = (torch.as_tensor(np.stack([_interior(spec, rng)
                                          for _ in range(nb)]))
                for _ in range(2))
        W = cn.nt_scaling(spec, s, z)
        W_gpu = cn.nt_scaling(spec, s.to(card), z.to(card))
    ref = _solve(S, A, W, rhs)
    ck.reset_launch_counts()
    out = _solve(S, A.to(card), W_gpu, rhs.to(card))
    torch.cuda.synchronize()
    counts = ck.launch_counts()
    st = S.kkt_builder.structure
    assert counts["cholesky"] == st.N + 2, counts     # stages, L_g, L_S
    assert counts["solve_lower"] > 0 and counts["solve_lower_t"] > 0, counts
    assert out.device.type == "cuda"
    err = (out.cpu() - ref).abs().max().item()
    assert err <= 1e-10 * ref.abs().max().item(), err


@pytest.mark.cuda
def test_ipm_on_block_kkt_on_card_matches_cpu(card, subproblem):
    """A whole IPM solve on the block builder: same status and iterations,
    x within a relative 1e-8 of the CPU's."""
    S, A, b, c = subproblem
    kw = dict(tol=1e-9, max_iter=60, kkt_builder=S.kkt_builder)
    ref = ipm.solve(A[0], b[0], c[0], S.spec, **kw)
    ck.reset_launch_counts()
    out = ipm.solve(A[0].to(card), b[0].to(card), c[0].to(card), S.spec,
                    **kw)
    assert ck.launch_counts()["cholesky"] > 0
    assert int(out.status) == int(ref.status) == int(ipm.IPMStatus.OPTIMAL)
    assert int(out.iters) == int(ref.iters)
    scale = ref.x.abs().max().item()
    assert (out.x.cpu() - ref.x).abs().max().item() <= 1e-8 * scale
