"""The port's batched Cholesky and triangular solves
(scptoolbox_torch/ops/chol_kernels.py) against the JAX package's Pallas
kernels cholesky / solve_lower / solve_lower_t (interpret mode on the CPU),
on the same numpy inputs.

n = 130 crosses the Pallas wrappers' 128-lane padding. Tolerances, relative
to the largest entry: 1e-12 in float64 and 1e-5 in float32. The two sides do
the same operations in the same order except that the Pallas factor takes
rsqrt(d) where the port takes 1/sqrt(d) and XLA may fuse a product into a
subtraction, so they differ by a few roundings per step.

The CUDA kernels run only on the card: test_torch_chol_kernels_card.py holds
them against the plain versions there."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scptoolbox_torch.ops import chol_kernels as ck
from scptoolbox_tpu.ops import pallas_kernels as pk

torch.set_num_threads(1)

NB = 3
TOL = {np.float64: 1e-12, np.float32: 1e-5}


def _spd(rng, n, dtype):
    M = rng.standard_normal((NB, n, n))
    return (M @ M.transpose(0, 2, 1) + n * np.eye(n)).astype(dtype)


def _close(a, b, dtype):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.abs(a - b).max() <= TOL[dtype] * np.abs(b).max(), \
        np.abs(a - b).max() / np.abs(b).max()


KS = (None, 1, 2, 17)      # None: a vector right-hand side


@pytest.fixture(scope="module", params=[5, 37, 130])
def factors(request):
    """(n, {dtype: (H, port L, Pallas L, right-hand sides by K, Pallas
    forward and backward solutions by K)}). The Pallas solves run once on
    all the right-hand sides side by side (their columns are independent,
    and the wrapper pads K to 128 lanes anyway)."""
    n = request.param
    rng = np.random.default_rng(n)
    out = {}
    for dtype in (np.float64, np.float32):
        H = _spd(rng, n, dtype)
        Lt = ck.cholesky(torch.as_tensor(H)).numpy()
        Bs = {K: rng.standard_normal((NB, n, K or 1)).astype(dtype)
              for K in KS}
        allB = jnp.asarray(np.concatenate(list(Bs.values()), axis=2))
        fwd, bwd = (np.asarray(f(jnp.asarray(Lt), allB, interpret=True))
                    for f in (pk.solve_lower, pk.solve_lower_t))
        cuts = np.cumsum([0] + [b.shape[2] for b in Bs.values()])
        sl = lambda Y: {K: Y[:, :, a:b] for K, a, b in
                        zip(KS, cuts[:-1], cuts[1:])}
        out[dtype] = (H, Lt,
                      np.asarray(pk.cholesky(jnp.asarray(H), interpret=True)),
                      Bs, sl(fwd), sl(bwd))
    return n, out


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_cholesky_plain_matches_pallas(factors, dtype):
    H, Lt, Lj = factors[1][dtype][:3]
    assert Lt.dtype == dtype
    _close(Lt, Lj, dtype)
    assert (np.triu(Lt, 1) == 0).all()
    np.testing.assert_allclose(Lt @ Lt.transpose(0, 2, 1), H,
                               rtol=10 * TOL[dtype],
                               atol=10 * TOL[dtype] * np.abs(H).max())


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_triangular_solves_plain_match_pallas(factors, dtype, K):
    """Both solves against the Pallas kernels on the same factor, and their
    composition cho_solve against H."""
    H, Lt, _, Bs, fwd, bwd = factors[1][dtype]
    B = Bs[K][..., 0] if K is None else Bs[K]
    L_t, B_t = torch.as_tensor(Lt), torch.as_tensor(B)
    Y = ck.solve_lower(L_t, B_t).numpy()
    X = ck.solve_lower_t(L_t, B_t).numpy()
    assert Y.shape == X.shape == B.shape
    vec = (lambda a: a[..., 0]) if K is None else (lambda a: a)
    _close(Y, vec(fwd[K]), dtype)
    _close(X, vec(bwd[K]), dtype)
    Z = ck.cho_solve(L_t, B_t).numpy().astype(np.float64)
    ref = vec(np.linalg.solve(H.astype(np.float64),
                              Bs[K].astype(np.float64)))
    # float32: the conditioning of H (about n) on top of the roundoff
    tol = TOL[dtype] if dtype == np.float64 else 1e-4
    assert np.abs(Z - ref).max() <= tol * np.abs(ref).max()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_non_spd_gives_nan_in_both(dtype):
    """An indefinite input: no exception, NaN from the first non-positive
    pivot on, on both sides (torch.linalg.cholesky would raise)."""
    rng = np.random.default_rng(3)
    H = _spd(rng, 9, dtype)
    H[:, 4, 4] = -50.0
    Lt = ck.cholesky(torch.as_tensor(H)).numpy()
    Lj = np.asarray(pk.cholesky(jnp.asarray(H), interpret=True))
    for L in (Lt, Lj):
        bad = np.isnan(np.diagonal(L, axis1=1, axis2=2))
        assert bad.any(axis=1).all()
        assert (bad.argmax(axis=1) == 4).all()
    # the columns before the bad pivot agree on and above row 4
    _close(Lt[:, :5, :4], Lj[:, :5, :4], dtype)


def test_empty_shapes():
    L = ck.cholesky(torch.zeros(2, 0, 0))
    assert L.shape == (2, 0, 0)
    assert ck.cho_solve(torch.eye(3).expand(2, 3, 3),
                        torch.zeros(2, 3, 0)).shape == (2, 3, 0)
    assert ck.cho_solve(L, torch.zeros(2, 0, 4)).shape == (2, 0, 4)


def test_wrappers_take_the_plain_version_on_cpu():
    H = torch.as_tensor(_spd(np.random.default_rng(0), 6, np.float64))
    ck.reset_launch_counts()
    L = ck.cholesky(H)
    assert torch.equal(L, ck.cholesky_plain(H))
    B = torch.ones(NB, 6, 2, dtype=torch.float64)
    assert torch.equal(ck.cho_solve(L, B), ck.solve_lower_t_plain(
        L, ck.solve_lower_plain(L, B)))
    assert ck.launch_counts() == {"cholesky": 0, "solve_lower": 0,
                                  "solve_lower_t": 0}


def test_wrappers_raise_off_cpu_and_cuda():
    M = torch.empty(2, 3, 3, device="meta")
    with pytest.raises(ValueError):
        ck.cholesky(M)
    with pytest.raises(ValueError):
        ck.solve_lower(M, torch.empty(2, 3, 1, device="meta"))
    with pytest.raises(ValueError):
        ck.solve_lower_t(torch.eye(3), torch.zeros(4, 1, dtype=torch.float32))
