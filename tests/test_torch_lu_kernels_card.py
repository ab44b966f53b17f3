"""The CUDA LU kernels (scptoolbox_torch/csrc/lu_kernels.cu) against their
plain PyTorch versions, on the card. Everything here carries the `cuda`
marker and skips where there is no CUDA device.

This file imports neither JAX nor the JAX package, so that it also runs on a
machine with the card and without JAX:

    python -m pytest --noconftest tests/test_torch_lu_kernels_card.py
"""

import collections

import numpy as np
import pytest
import torch

from scptoolbox_torch.ops import cuda_lib
from scptoolbox_torch.ops import lu_kernels as lk


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _blocks(nb, s, dtype, device):
    # 1e-7-scaled diagonals: unpivoted elimination breaks down on them
    M = np.random.default_rng(2).standard_normal((nb, s, s))
    M[:, np.arange(s), np.arange(s)] *= 1e-7
    return torch.as_tensor(M, dtype=dtype, device=device)


# (nb, s, K) of the launches on the paths chip_smoke.py drives: Starship's
# stage blocks (s=158: K=158 in the factor, 37 for the arrow, 2 in FGMRES)
# and arrow Schur block (145); the double integrator's (29 and 16) at B=128;
# the LU stage sweep's (StagedLU: one stage a launch at B=4, its E_k/F_k
# solve at K = s + nb, 303 on Starship and 45 on the double integrator)
SHAPES = [(64, 158, (1, 2, 37, 158)), (32, 145, (1, 2)),
          (2048, 29, (2, 8, 29)), (128, 16, (2,)),
          (4, 158, (1, 2, 303)), (4, 145, (1, 2)), (128, 29, (2, 45))]


@pytest.mark.cuda
@pytest.mark.parametrize("nb,s,Ks", SHAPES)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.float64, 1e-10)])
def test_kernels_match_plain_on_card(card, dtype, tol, nb, s, Ks):
    M = _blocks(nb, s, dtype, card)
    lk.reset_launch_counts()
    F, P = lk.lu_factor(M)
    Fp, Pp = lk.lu_factor_plain(M)
    assert torch.equal(P, Pp)
    assert torch.equal(F, Fp)
    for K in Ks:
        B = torch.randn(nb, s, K, dtype=dtype, device=card)
        X = lk.lu_solve((F, P), B)
        Xp = lk.lu_solve_plain((F, P), B)
        assert (X - Xp).abs().max() <= tol * Xp.abs().max()
    assert lk.launch_counts() == {"lu_factor": 1, "lu_solve": len(Ks)}


@pytest.mark.cuda
def test_launch_shapes_record_each_launch(card):
    M = _blocks(3, 16, torch.float32, card)
    cuda_lib.launch_shapes = collections.Counter()
    try:
        fac = lk.lu_factor(M.reshape(1, 3, 16, 16))
        lk.lu_solve(fac, torch.ones(1, 3, 16, 2, device=card))
        lk.lu_solve(fac, torch.ones(1, 3, 16, 2, device=card))
        lk.lu_factor_plain(M)
        shapes = dict(cuda_lib.launch_shapes)
    finally:
        cuda_lib.launch_shapes = None
    assert shapes == {("lu_factor", "f32", 3, 16, 16): 1,
                      ("lu_solve", "f32", 3, 16, 2): 2}


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    with pytest.raises(TypeError):
        lk.lu_factor(torch.zeros(2, 4, 4, dtype=torch.float16, device=card))
    with pytest.raises(ValueError):
        lk.lu_factor(torch.zeros(2, 4, 5, device=card))
    F, P = lk.lu_factor(torch.eye(4, device=card).expand(2, 4, 4))
    with pytest.raises(ValueError):
        lk.lu_solve((F, P), torch.zeros(3, 4, 1, device=card))


def _equal_or_both_nan(a, b):
    return (torch.equal(torch.isnan(a), torch.isnan(b))
            and torch.equal(torch.nan_to_num(a, 0.0), torch.nan_to_num(b, 0.0)))


# lu_factor's two designs (a warp per matrix up to s = 32, 32-column panels
# above; inside the warp design 16 or 32 columns in registers; panels held
# by one warp or several) and their switch points, at one matrix, a few, a
# card's worth of blocks and more
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nb", [1, 7, 512, 2048])
@pytest.mark.parametrize("s", [1, 16, 17, 29, 31, 32, 33, 64, 65, 145, 158])
def test_lu_factor_equals_plain_bit_for_bit(card, dtype, nb, s):
    M = _blocks(nb, s, dtype, card)
    F, P = lk.lu_factor(M)
    Fp, Pp = lk.lu_factor_plain(M)
    assert torch.equal(P, Pp)
    assert torch.equal(F, Fp)


def _hard_blocks(nb, s, dtype, device):
    """Blocks whose pivot search meets ties after swaps (small integers,
    repeated rows, an all-zero column), a NaN and pivots below 1e-30."""
    rng = np.random.default_rng(s)
    M = rng.integers(-2, 3, (nb, s, s)).astype(np.float64)
    if s > 3:
        M[:, 2] = M[:, 0]                # repeated rows: exact ties
        M[:, :, 1] = 0.0                 # an all-zero column
        M[1::4, s // 2] = M[1::4, 1]
    if s > 5:
        M[2::4, :, 3] *= 1e-35           # pivots below the floor (float64)
        M[3::4, s - 1, 4] = np.nan       # a NaN in column 4, last row
    M[0, 0, 0] = -1e-31                  # a first pivot below the floor
    return torch.as_tensor(M, dtype=dtype, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("s", [1, 6, 16, 29, 32, 33, 64, 145, 158, 200,
                               694])
def test_lu_factor_ties_nan_and_floor_like_plain(card, dtype, s):
    M = _hard_blocks(8, s, dtype, card)
    F, P = lk.lu_factor(M)
    Fp, Pp = lk.lu_factor_plain(M)
    assert torch.equal(P, Pp)
    assert _equal_or_both_nan(F, Fp)
    if s > 5:
        assert torch.isnan(Fp[3]).any()


@pytest.mark.cuda
def test_lu_factor_refuses_blocks_beyond_shared_memory(card):
    """A 200-wide float64 block (320 KB) does not fit in a block's shared
    memory: the panel design refuses it and the wrapper takes the grid
    design (the matrix in device memory), bit for bit as the plain
    version, never the library."""
    M = _blocks(1, 200, torch.float64, card)
    need = lk._factor_shared_bytes(200, 8)
    assert need > lk._max_shared_bytes(card.index or 0)
    lk.reset_launch_counts()
    F, P = lk.lu_factor(M)
    assert lk.launch_counts()["lu_factor"] == 1
    Fp, Pp = lk.lu_factor_plain(M)
    assert torch.equal(P, Pp) and torch.equal(F, Fp)


# the grid design (blocks beyond shared memory): one matrix over every SM,
# a few, and more matrices than SMs (groups in rounds); the arrow Schur
# complement of the softplus quadrotor's staged sweeps is 694 wide
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,s,nb", [
    (torch.float64, 169, 1), (torch.float64, 200, 5),
    (torch.float64, 694, 1), (torch.float64, 694, 2),
    (torch.float32, 240, 1), (torch.float32, 240, 200),
    (torch.float32, 694, 3)])
def test_lu_factor_grid_equals_plain_bit_for_bit(card, dtype, s, nb):
    M = _blocks(nb, s, dtype, card)
    F, P = lk.lu_factor(M)
    Fp, Pp = lk.lu_factor_plain(M)
    assert torch.equal(P, Pp)
    assert torch.equal(F, Fp)


# the panel solve at widths around its 32-row panels and at the paths'
# block sizes, at the column counts of its designs and their switch points
# (a warp per column up to 8 columns, register tiles above; tiles of up to
# 64 columns, narrower while they leave SMs idle), at one matrix, a few
# and a card's worth
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nb", [1, 32, 512])
@pytest.mark.parametrize("s", [16, 31, 32, 33, 145, 158])
def test_lu_solve_equals_plain_bit_for_bit(card, dtype, nb, s):
    M = _blocks(nb, s, dtype, card)
    fac = lk.lu_factor(M)
    gen = torch.Generator(device=card)
    gen.manual_seed(s + nb)
    for K in (1, 2, 8, 9, 33, 37, 64, 65, 158):
        B = torch.randn(nb, s, K, dtype=dtype, device=card, generator=gen)
        assert torch.equal(lk.lu_solve(fac, B), lk.lu_solve_plain(fac, B)), K


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("K", [2, 37])
@pytest.mark.parametrize("s", [158, 694])     # 694 float64: the rows design
def test_lu_solve_floor_and_nan_like_plain(card, dtype, K, s):
    """Pivots below the 1e-30 floor (either sign, and zero) are floored with
    their sign kept, and a NaN in the factor spreads as in the plain
    version; the record is any valid one (row j swaps with a row >= j)."""
    nb = 4
    rng = np.random.default_rng(5)
    F = torch.as_tensor(rng.standard_normal((nb, s, s)), dtype=dtype,
                        device=card)
    F[0, 3, 3], F[0, 40, 40], F[1, 100, 100] = 1e-35, -1e-40, 0.0
    F[2, 77, 12] = float("nan")
    F[3, 150, 150] = float("nan")
    rec = np.array([[rng.integers(j, s) for j in range(s)]
                    for _ in range(nb)])
    fac = (F, torch.as_tensor(rec, dtype=torch.int32, device=card))
    B = torch.randn(nb, s, K, dtype=dtype, device=card)
    X, Xp = lk.lu_solve(fac, B), lk.lu_solve_plain(fac, B)
    assert torch.isnan(Xp[2]).any() and torch.isnan(Xp[3]).any()
    assert _equal_or_both_nan(X, Xp)


@pytest.mark.cuda
def test_lu_solve_refuses_panels_beyond_shared_memory(card):
    """Two staged 32-column panels of a 500-wide float64 factor (264 KB) do
    not fit in a block's shared memory: the panel design refuses them and
    the launch takes the cluster design (lu_design 2), bit for bit as the
    plain version; past a float64 block's rows on clusters of 16 (s =
    6500) and past the clusters the card holds (20 matrices) it takes the
    rows design (1)."""
    s = 500
    lib = lk.LIB.load()
    assert lib.lu_design(1, 1, 427, 2, 8) == 0
    assert lib.lu_design(1, 1, 428, 2, 8) == 2
    assert lib.lu_design(1, 1, s, 2, 8) == 2
    assert lib.lu_design(1, 1, 4500, 2, 8) == 3
    assert lib.lu_design(1, 1, 6500, 2, 8) == 1
    assert lib.lu_design(1, 20, s, 2, 8) == 1
    F = torch.eye(s, dtype=torch.float64, device=card)[None]
    rec = torch.arange(s, dtype=torch.int32, device=card)[None]
    B = torch.randn(1, s, 2, dtype=torch.float64, device=card)
    X = lk.lu_solve((F, rec), B)
    assert torch.equal(X, lk.lu_solve_plain((F, rec), B))


# the rows design, past the cluster design's reach (more matrices than the
# card holds clusters, and a float64 factor whose rows do not fit a block
# of a cluster of 16), at the column counts around its 32-column blocks,
# with pivots and the floor
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,s,nb", [(torch.float64, 500, 20),
                                        (torch.float64, 694, 17),
                                        (torch.float64, 6500, 1),
                                        (torch.float32, 900, 17)])
def test_lu_solve_rows_equals_plain_bit_for_bit(card, dtype, s, nb):
    fac = lk.lu_factor(_blocks(nb, s, dtype, card))
    gen = torch.Generator(device=card)
    gen.manual_seed(s + nb)
    esize = 8 if dtype == torch.float64 else 4
    for K in (1, 2, 31, 32, 33, 37, 65):
        assert lk.LIB.load().lu_design(1, nb, s, K, esize) == 1, K
        B = torch.randn(nb, s, K, dtype=dtype, device=card, generator=gen)
        assert torch.equal(lk.lu_solve(fac, B), lk.lu_solve_plain(fac, B)), K


# the cluster design (a few factors whose panels do not fit in shared
# memory: float64 past s ~ 430, float32 past ~ 840; the softplus
# quadrotor's arrow is 694 wide), on clusters of 8 and, past what their
# blocks hold (3500 float64), of 16, at one matrix, a few, and column
# counts around its warps
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("nb", [1, 2, 3])
@pytest.mark.parametrize("s", [431, 500, 694, 1000, 1500, 2100, 3500])
def test_lu_solve_cluster_equals_plain_bit_for_bit(card, dtype, nb, s):
    fac = lk.lu_factor(_blocks(nb, s, dtype, card))
    gen = torch.Generator(device=card)
    gen.manual_seed(s + nb)
    esize = 8 if dtype == torch.float64 else 4
    for K in (1, 2, 37, 64):
        design = lk.LIB.load().lu_design(1, nb, s, K, esize)
        if esize == 4:
            want = 0 if s <= 842 else 2       # 842: the panels still fit
        else:
            want = 3 if s >= 3500 else 2
        assert design == want, (K, design)
        B = torch.randn(nb, s, K, dtype=dtype, device=card, generator=gen)
        assert torch.equal(lk.lu_solve(fac, B), lk.lu_solve_plain(fac, B)), K


# ties after swaps, an all-zero column, a NaN and pivots below the floor,
# factored and solved on the cluster design
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("nb,s", [(1, 694), (3, 694), (2, 1000)])
def test_lu_solve_cluster_ties_nan_and_floor_like_plain(card, dtype, nb, s):
    M = _hard_blocks(8, s, dtype, card)
    M = M[:1] if nb == 1 else M[2:2 + nb]    # blocks 2: the floor, 3: a NaN
    fac = lk.lu_factor(M)
    B = torch.randn(nb, s, 37, dtype=dtype, device=card)
    X, Xp = lk.lu_solve(fac, B), lk.lu_solve_plain(fac, B)
    assert _equal_or_both_nan(X, Xp)
    if nb > 1:
        assert torch.isnan(Xp[1]).any()


# the blocked grid design past a block's shared memory: the first s past
# it in each type (169 float64, 240 float32), the staged sweeps' 694, a
# panel whose rows exceed the 512 a block holds in registers (694, 1000)
# and one that does not (431), panels whose rows exceed what registers
# and shared memory hold in either type (2100, 3000: those rows take
# their steps in device memory), at one matrix (every SM on it) and a few
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nb", [1, 2, 3])
@pytest.mark.parametrize("s", [169, 240, 431, 694, 1000, 2100, 3000])
def test_lu_factor_blocked_grid_equals_plain_bit_for_bit(card, dtype, nb, s):
    M = _blocks(nb, s, dtype, card)
    F, P = lk.lu_factor(M)
    Fp, Pp = lk.lu_factor_plain(M)
    assert torch.equal(P, Pp)
    assert torch.equal(F, Fp)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("s", [694, 1000, 2100])
def test_lu_factor_blocked_grid_ties_nan_and_floor_like_plain(card, dtype,
                                                              s):
    M = _hard_blocks(8, s, dtype, card)
    F, P = lk.lu_factor(M)
    Fp, Pp = lk.lu_factor_plain(M)
    assert torch.equal(P, Pp)
    assert _equal_or_both_nan(F, Fp)
    assert torch.isnan(Fp[3]).any()


@pytest.mark.cuda
def test_lu_design_reports_the_blocked_grid(card):
    """lu_design names the grid design (2) from the first s past a block's
    shared memory on, the panel design (1) up to it; the grid design
    takes both types well past the panels that shared memory holds (its
    rows past them in device memory)."""
    lib = lk.LIB.load()
    design = lambda s, esize: lib.lu_design(0, 1, s, s, esize)
    assert design(168, 8) == 1 and design(169, 8) == 2
    assert design(239, 4) == 1 and design(240, 4) == 2
    assert design(694, 8) == 2
    assert lib.lu_factor_grid_max_s(8) > 20000
    assert lib.lu_factor_grid_max_s(4) > 20000
