"""The library LU behind the port's dense and staged KKTs on the CPU
(scptoolbox_torch/ops/linalg.py), and what becomes of a non-finite block.

Batched `torch.linalg.lu_factor` of matrices larger than 128 x 128 does not
return on the CPU when PyTorch runs more than one intra-op thread (MKL
prints "Parameter 6 was incorrect on entry to SLASWP" and spins), for any
data: this is what stopped the port's float32 StagedCR IPM on the Starship
subproblems, at the first CR level of its first factor, with every block
finite. The port factors one matrix at a time on the CPU. Each check runs in
a daemon thread with a deadline, so that a regression fails the test rather
than hanging the run."""

import numpy as np
import pytest
import torch

from scptoolbox_torch.ops import linalg
from tests.torch_refs import with_threads

torch.set_num_threads(1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_batched_factor_returns_under_threads(dtype):
    M = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (2, 3, 158, 158)), dtype=dtype)
    LU, piv = with_threads(2, lambda: linalg.lu_factor(M))
    assert LU.shape == M.shape and piv.shape == (2, 3, 158)
    # against one-thread factors: MKL's threaded getrf blocks differently,
    # so the factors agree to roundoff, the pivots exactly
    tol = 1e-4 if dtype == torch.float32 else 1e-12
    for i in range(2):
        for j in range(3):
            lu1, p1 = torch.linalg.lu_factor(M[i, j])
            assert torch.equal(piv[i, j], p1)
            assert (LU[i, j] - lu1).abs().max() <= tol * lu1.abs().max()


def test_non_finite_block_stays_in_its_block():
    """A NaN block: no exception, its factor is NaN with pivots in range,
    its solve is NaN, and the other blocks are untouched. In the IPM such a
    step is then refused by the finite check of the iterate (the scenario
    keeps its previous iterate and stops)."""
    M = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (3, 40, 40)))
    M[1, 5:, 7] = float("nan")
    LU, piv = linalg.lu_factor(M)
    assert torch.isnan(LU[1]).any() and torch.isfinite(LU[[0, 2]]).all()
    assert int(piv.min()) >= 1 and int(piv.max()) <= 40
    X = torch.linalg.lu_solve(LU, piv, torch.ones(3, 40, 2,
                                                  dtype=torch.float64))
    assert torch.isnan(X[1]).any() and torch.isfinite(X[[0, 2]]).all()


def test_single_matrix_and_empty_batch_pass_through():
    A = torch.eye(5, dtype=torch.float64) * 2.0
    LU, piv = linalg.lu_factor(A)
    assert torch.equal(LU, A) and piv.shape == (5,)
    LU, piv = linalg.lu_factor(torch.zeros(0, 4, 4))
    assert LU.shape == (0, 4, 4) and piv.shape == (0, 4)


@pytest.mark.parametrize("batched", [False, True])
def test_singular_block_factors_as_lapack_does(batched):
    """An exactly singular block (a zero pivot): no exception where
    `torch.linalg.lu_factor` raises, the zero left on U's diagonal, and a
    solve of inf/NaN, as LAPACK's getrf and the JAX package's lu_factor
    give (the staged CR KKT's arrow block on the card hit this)."""
    import jax.scipy.linalg as jsl

    A = np.eye(4)
    A[2, 2] = 0.0
    M = torch.as_tensor(np.stack([np.eye(4), A]) if batched else A)
    LU, piv = linalg.lu_factor(M)
    lu_j, piv_j = jsl.lu_factor(A)
    np.testing.assert_array_equal(LU[-1].numpy() if batched else LU.numpy(),
                                  np.asarray(lu_j))
    X = torch.linalg.lu_solve(LU, piv, torch.ones(M.shape[:-1] + (1,),
                                                  dtype=torch.float64))
    assert not torch.isfinite(X[-1] if batched else X).all()
    if batched:
        assert torch.equal(X[0], torch.ones(4, 1, dtype=torch.float64))
