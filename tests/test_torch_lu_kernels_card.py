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
# and arrow Schur block (145); the double integrator's (29 and 16) at B=128
SHAPES = [(64, 158, (1, 2, 37, 158)), (32, 145, (1, 2)),
          (2048, 29, (2, 8, 29)), (128, 16, (2,))]


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
    assert (F - Fp).abs().max() <= tol * Fp.abs().max()
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
