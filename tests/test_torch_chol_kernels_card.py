"""The CUDA Cholesky and triangular-solve kernels
(scptoolbox_torch/csrc/chol_kernels.cu) against their plain PyTorch
versions, on the card. Everything here carries the `cuda` marker and skips
where there is no CUDA device.

This file imports neither JAX nor the JAX package, so that it also runs on a
machine with the card and without JAX:

    python -m pytest --noconftest tests/test_torch_chol_kernels_card.py
"""

import numpy as np
import pytest
import torch

from scptoolbox_torch.ops import chol_kernels as ck


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _spd(nb, n, dtype, device, seed=0):
    M = torch.as_tensor(np.random.default_rng(seed).standard_normal(
        (nb, n, n)), dtype=torch.float64)
    return (M @ M.transpose(1, 2) + n * torch.eye(n, dtype=torch.float64)
            ).to(dtype=dtype, device=device)


# (nb, n, K, dtype) of the dense Schur KKT's ladder on the paths
# chip_smoke.py drives: the batched double integrator (H 314^2, S 64^2,
# K = 2 and nz = 64, float32), the oscillator (541 and 60, float64) and the
# LCvx rocket landing (876 and 566, float64)
SHAPES = [(128, 314, (2, 64), torch.float32), (128, 64, (2,), torch.float32),
          (1, 541, (2, 60), torch.float64), (1, 60, (2,), torch.float64),
          (1, 876, (2, 566), torch.float64), (1, 566, (2,), torch.float64)]


@pytest.mark.cuda
@pytest.mark.parametrize("nb,n,Ks,dtype", SHAPES)
def test_kernels_equal_plain_on_card(card, nb, n, Ks, dtype):
    """Kernel and plain version do the same operations in the same order:
    bit for bit equal."""
    H = _spd(nb, n, dtype, card)
    ck.reset_launch_counts()
    L = ck.cholesky(H)
    assert torch.equal(L, ck.cholesky_plain(H))
    for K in Ks:
        B = torch.randn(nb, n, K, dtype=dtype, device=card)
        assert torch.equal(ck.solve_lower(L, B), ck.solve_lower_plain(L, B))
        assert torch.equal(ck.solve_lower_t(L, B),
                           ck.solve_lower_t_plain(L, B))
    v = torch.randn(nb, n, dtype=dtype, device=card)
    assert torch.equal(ck.cho_solve(L, v), ck.solve_lower_t_plain(
        L, ck.solve_lower_plain(L, v)))
    assert ck.launch_counts() == {"cholesky": 1,
                                  "solve_lower": len(Ks) + 1,
                                  "solve_lower_t": len(Ks) + 1}


# one matrix (and a few): the factor spread over a cooperative grid and the
# backward solve over clusters, around the panel width (31, 32, 33) and at
# the serial programs' widths, with a short last panel (541, 877)
ONE = [(1, 31), (1, 32), (1, 33), (1, 541), (1, 876), (1, 877), (3, 314)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("nb,n", ONE)
def test_small_batches_equal_plain_on_card(card, nb, n, dtype):
    H = _spd(nb, n, dtype, card, seed=n)
    L = ck.cholesky(H)
    assert torch.equal(L, ck.cholesky_plain(H))
    for K in (1, 2, 566):
        B = torch.randn(nb, n, K, dtype=dtype, device=card)
        assert torch.equal(ck.solve_lower_t(L, B),
                           ck.solve_lower_t_plain(L, B)), K
        assert torch.equal(ck.solve_lower(L, B), ck.solve_lower_plain(L, B))


@pytest.mark.cuda
def test_one_matrix_empty_cases(card):
    assert ck.cholesky(torch.zeros(1, 0, 0, dtype=torch.float64,
                                   device=card)).shape == (1, 0, 0)
    L = ck.cholesky(_spd(1, 541, torch.float64, card))
    B = torch.zeros(1, 541, 0, dtype=torch.float64, device=card)
    assert ck.solve_lower_t(L, B).shape == (1, 541, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n,bad", [(40, 17), (876, 500)])
def test_non_spd_gives_nan_on_one_matrix(card, n, bad):
    H = _spd(1, n, torch.float64, card)
    H[0, bad, bad] = -1e6
    L = ck.cholesky(H)
    torch.cuda.synchronize()
    d = torch.diagonal(L[0])
    assert torch.isnan(d[bad]) and torch.isfinite(d[:bad]).all()
    assert torch.equal(torch.isnan(L), torch.isnan(ck.cholesky_plain(H)))


@pytest.mark.cuda
def test_non_spd_gives_nan_not_an_error(card):
    H = _spd(2, 40, torch.float64, card)
    H[1, 17, 17] = -1e3
    L = ck.cholesky(H)
    torch.cuda.synchronize()
    assert torch.isfinite(L[0]).all()
    d = torch.diagonal(L[1])
    assert torch.isnan(d[17]) and torch.isfinite(d[:17]).all()
    assert torch.equal(torch.isnan(L), torch.isnan(ck.cholesky_plain(H)))


@pytest.mark.cuda
def test_transposed_view_and_empty_shapes(card):
    H = _spd(3, 20, torch.float32, card)
    L = ck.cholesky(H)
    AT = torch.randn(3, 7, 20, device=card).transpose(1, 2)   # like A_E'
    assert torch.equal(ck.cho_solve(L, AT), ck.cho_solve(L, AT.contiguous()))
    assert ck.cholesky(torch.zeros(3, 0, 0, device=card)).shape == (3, 0, 0)
    assert ck.cho_solve(L, torch.zeros(3, 20, 0, device=card)).shape == \
        (3, 20, 0)
    with pytest.raises(TypeError):
        ck.cholesky(torch.zeros(2, 4, 4, dtype=torch.float16, device=card))
    with pytest.raises(ValueError):
        ck.solve_lower(L, torch.zeros(2, 20, 1, device=card))


# batches beyond the clusters the card holds at once: solve_lower's panel
# design (its panels of L in shared memory), and where two panels of n
# rows do not fit there (541 float64), the one-block design reading L in
# device memory; at the column counts of the panel design's switch points
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nb,n", [(32, 31), (32, 145), (128, 64),
                                  (128, 314), (32, 541), (512, 158)])
def test_batched_solves_equal_plain_on_card(card, nb, n, dtype):
    L = ck.cholesky(_spd(nb, n, dtype, card, seed=n))
    gen = torch.Generator(device=card)
    gen.manual_seed(n)
    for K in (1, 2, 8, 9, 33, 64, 65):
        B = torch.randn(nb, n, K, dtype=dtype, device=card, generator=gen)
        assert torch.equal(ck.solve_lower(L, B), ck.solve_lower_plain(L, B)), K
        assert torch.equal(ck.solve_lower_t(L, B),
                           ck.solve_lower_t_plain(L, B)), K


@pytest.mark.cuda
def test_cluster_occupancy_caches_do_not_mix(card):
    """The forward and backward cluster kernels keep their own occupancy
    caches: whichever is asked first, each cached answer is the card's
    answer for its own kernel."""
    lib = ck.LIB.load()
    for fwd_first in (1, 0):
        for dtype, fn in ((torch.float64, lib.chol_cluster_fit_f64),
                          (torch.float32, lib.chol_cluster_fit_f32)):
            for n, K in ((876, 2), (876, 566), (541, 60), (3 * 314, 64)):
                for fwd in (fwd_first, 1 - fwd_first):
                    fresh = fn(fwd, n, K, 1, 0)
                    assert fresh > 0, (dtype, n, K, fwd, fresh)
                    assert fn(fwd, n, K, 1, 1) == fresh, (dtype, n, K, fwd)


@pytest.mark.cuda
def test_design_report_matches_the_launchers(card):
    """chol_design names the design each launcher takes, as the source's
    header sets it out: cholesky one block a matrix where the part below
    the first panel is one tile (n=27, 53) or for a batch that fills the
    card, else the cooperative spread; the solves on clusters at up to 16
    matrices of more than one 32-row panel, else on panels, or one block a
    matrix where two panels of n rows do not fit in shared memory (n=541
    float64); solve_lower_t on cluster_solve.cuh's clusters of 8 (3) past
    16 columns a cluster (876 x 566) and at the free-flyer's 1593-wide
    factor at K = 403, of 16 (4) at 2400 x 403, where solve_lower keeps
    its clusters (0) or one block (2); and the kernels launched at those
    shapes still equal their plain versions."""
    lib = ck.LIB.load()
    f64, f32 = lib.chol_design_f64, lib.chol_design_f32
    assert f64(0, 1, 27, 27) == f64(0, 1, 53, 53) == 1
    assert f32(0, 128, 314, 314) == 1
    assert f64(0, 1, 403, 403) >= 2 and f64(0, 8, 186, 186) >= 2
    for which in (1, 2):
        assert f64(which, 1, 403, 234) == 0 and f64(which, 8, 186, 2) == 0
        assert f64(which, 8, 27, 2) == 1 and f32(which, 128, 314, 64) == 1
        assert f64(which, 64, 541, 2) == 2
        assert f64(which, 1, 1593, 2) == 0
    assert f64(2, 1, 876, 566) == 3 and f64(1, 1, 876, 566) == 0
    assert f64(2, 1, 1593, 403) == 3 and f64(1, 1, 1593, 403) == 2
    assert f64(2, 1, 2400, 403) == 4 and f64(1, 1, 2400, 403) == 2
    for nb, n, K in ((1, 403, 234), (8, 27, 2), (64, 541, 2)):
        H = _spd(nb, n, torch.float64, card)
        B = torch.as_tensor(np.random.default_rng(1).standard_normal(
            (nb, n, K)), dtype=torch.float64, device=card)
        L = ck.cholesky(H)
        assert torch.equal(L, ck.cholesky_plain(H))
        assert torch.equal(ck.solve_lower(L, B), ck.solve_lower_plain(L, B))
        assert torch.equal(ck.solve_lower_t(L, B),
                           ck.solve_lower_t_plain(L, B))


# the free-flyer GuSTO step's Cholesky ladder (H 1593^2 float64: HiAE =
# cho_solve(L_H, A_E') at K = 403, the vector solves at K = 2) and one
# larger factor, where solve_lower_t takes cluster_solve.cuh's clusters of
# 8 with two staged steps (1593 x 403) or of 16 blocks (2400 x 403);
# solve_lower at the same shapes (clusters, or one block where its plan
# does not fit)
@pytest.mark.cuda
@pytest.mark.parametrize("n,K", [(1593, 2), (1593, 37), (1593, 403),
                                 (2400, 2), (2400, 403)])
def test_solves_at_the_free_flyer_factor_equal_plain(card, n, K):
    L = ck.cholesky(_spd_on_card(1, n, torch.float64, card, seed=n))
    gen = torch.Generator(device=card)
    gen.manual_seed(K)
    B = torch.randn(1, n, K, dtype=torch.float64, device=card, generator=gen)
    assert torch.equal(ck.solve_lower_t(L, B), ck.solve_lower_t_plain(L, B))
    assert torch.equal(ck.solve_lower(L, B), ck.solve_lower_plain(L, B))


# the staged KKTs' groups: StagedCRQD's ridge ladder on the Starship
# subproblem at B=32 (Z 105^2 and S 53^2, three rungs of the 16 odd blocks
# of a scenario in one launch, Lh^-1 by solve_lower at K = n identity
# columns), float32
CRQD = [(3 * 32 * 16, 105), (3 * 32 * 16, 53), (3 * 32, 105)]


@pytest.mark.cuda
@pytest.mark.parametrize("nb,n", CRQD)
def test_crqd_ladder_equals_plain_on_card(card, nb, n):
    H = _spd(nb, n, torch.float32, card, seed=n)
    L = ck.cholesky(H)
    assert torch.equal(L, ck.cholesky_plain(H))
    eye = torch.eye(n, device=card).expand(nb, n, n).contiguous()
    assert torch.equal(ck.solve_lower(L, eye), ck.solve_lower_plain(L, eye))


@pytest.mark.cuda
@pytest.mark.parametrize("nb,n", CRQD)
def test_indefinite_blocks_give_the_plain_nan(card, nb, n):
    """Half the blocks negative definite (the ladder's failing rungs): no
    error, every one of their factors non-finite where the plain version's
    is, the SPD half bit for bit."""
    H = _spd(nb, n, torch.float32, card, seed=n + 1)
    H[: nb // 2] = -H[: nb // 2]
    L, ref = ck.cholesky(H), ck.cholesky_plain(H)
    torch.cuda.synchronize()
    assert torch.equal(torch.isfinite(L), torch.isfinite(ref))
    bad = ~torch.isfinite(L).all(dim=-1).all(dim=-1)
    assert bad[: nb // 2].all() and not bad[nb // 2:].any()
    assert torch.equal(L[nb // 2:], ref[nb // 2:])


@pytest.mark.cuda
@pytest.mark.parametrize("nb,n,K,dtype", [
    (4, 158, 2, torch.float64), (4, 158, 145, torch.float64),
    (128, 29, 2, torch.float32), (128, 29, 16, torch.float32),
    (1, 541, 2, torch.float64)])
def test_qr_back_substitution_equals_plain_on_card(card, nb, n, K, dtype):
    """StagedQR's R_k x = g as solve_lower_t(R_k', g): R's diagonal carries
    either sign (Householder QR). Float64 on Starship's stages (s = 158,
    K = 2 and nb = 145: clusters), float32 on the double integrator's
    (panels), and one 541-wide float64 factor (the one-block design)."""
    rng = np.random.default_rng(K + n)
    L = np.tril(rng.standard_normal((nb, n, n))) / np.sqrt(n)
    d = (1.0 + rng.random((nb, n))) * rng.choice([-1.0, 1.0], (nb, n))
    L[:, np.arange(n), np.arange(n)] = d
    L = torch.as_tensor(L, dtype=dtype, device=card)
    B = torch.randn(nb, n, K, dtype=dtype, device=card)
    assert torch.equal(ck.solve_lower_t(L, B), ck.solve_lower_t_plain(L, B))


def _spd_on_card(nb, n, dtype, device, seed):
    """M M' + n I, made on the card from a seeded generator."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    M = torch.randn(nb, n, n, generator=gen, device=device,
                    dtype=torch.float64)
    eye = torch.eye(n, dtype=torch.float64, device=device)
    return (M @ M.transpose(1, 2) + n * eye).to(dtype)


def _largest_smem_n(dtype):
    """The largest n the shared-memory design takes (chol_design's variant
    1 for a batch that fills the card)."""
    f = getattr(ck.LIB.load(), "chol_design_f32" if dtype == torch.float32
                else "chol_design_f64")
    n = 33
    while f(3, 1536, n + 1, n + 1) == 1:
        n += 1
    return n


# the batched designs: a warp a matrix up to n = 32, the triangle in shared
# memory above it (up to its largest n), around the panel width and at
# StagedCRQD's (53, 105) and bench.py's (314) widths, at one matrix, a few,
# about a card's worth and StagedCRQD's 1536
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nb", [1, 27, 96, 128, 1536])
@pytest.mark.parametrize("n", [1, 31, 32, 33, 53, 105, 240, 314, "largest"])
def test_batched_cholesky_designs_equal_plain(card, dtype, nb, n):
    if n == "largest":
        n = _largest_smem_n(dtype)
    H = _spd_on_card(nb, n, dtype, card, seed=n + nb)
    L = ck.cholesky(H)
    assert torch.equal(L, ck.cholesky_plain(H))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nb,n", [(1, 31), (27, 31), (1, 53), (96, 53),
                                  (1536, 105), (128, 314)])
def test_batched_designs_give_the_plain_nan(card, dtype, nb, n):
    """Indefinite blocks (every other one negative definite, and one
    turning indefinite at its last pivot) give the plain version's NaN, no
    error; the SPD blocks stay bit for bit."""
    H = _spd_on_card(nb, n, dtype, card, seed=n)
    H[::2] = -H[::2]
    H[-1, n - 1, n - 1] = -1e6
    L, ref = ck.cholesky(H), ck.cholesky_plain(H)
    torch.cuda.synchronize()
    assert torch.equal(torch.isnan(L), torch.isnan(ref))
    assert torch.equal(torch.isfinite(L), torch.isfinite(ref))
    ok = torch.isfinite(ref).all(dim=-1).all(dim=-1)
    assert torch.equal(L[ok], ref[ok])
    assert not ok[::2].any() and not ok[-1]


@pytest.mark.cuda
def test_design_report_names_the_batched_designs(card):
    """chol_design's variant query (which = 3): 0 a warp a matrix up to
    n = 32, 1 the triangle in shared memory above it (float32 past 314,
    float64 past 200), also for the few matrices the spread would give up
    to 3 blocks each and one float64 matrix up to 212 wide, 2 the
    device-memory design past that at a batch that fills the card, 3 the
    spread (one 250-wide matrix), whose blocks a matrix query 0
    reports (1 for the others)."""
    lib = ck.LIB.load()
    for f, big in ((lib.chol_design_f32, 314), (lib.chol_design_f64, 200)):
        assert f(3, 1536, 32, 32) == 0 and f(3, 1, 27, 27) == 0
        assert f(3, 1536, 33, 33) == 1 and f(3, 1536, big, big) == 1
        assert f(3, 1, 53, 53) == 1 and f(3, 1, 96, 96) == 1
        assert f(3, 1, 102, 102) == 1 and f(0, 1, 102, 102) == 1
        assert f(3, 128, 340, 340) == 2 and f(0, 128, 340, 340) == 1
        assert f(3, 1, 250, 250) == 3 and f(0, 1, 250, 250) >= 2
    assert lib.chol_design_f32(3, 128, 314, 314) == 1
    assert lib.chol_design_f32(3, 64, 314, 314) == 1
    assert lib.chol_design_f32(3, 1, 314, 314) == 3
    assert lib.chol_design_f64(3, 1, 209, 209) == 1
    assert lib.chol_design_f64(3, 1, 224, 224) == 3
    assert _largest_smem_n(torch.float32) >= 314
    assert _largest_smem_n(torch.float64) >= 200
