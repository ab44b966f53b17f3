"""The CUDA Gauss-Jordan inverse (scptoolbox_torch/csrc/gj_kernels.cu)
against its plain PyTorch version, bit for bit, on the card: at the staged
KKT's block shapes (the Starship CR blocks, s = 158 and 145), at every
design the launcher chooses (C = 1 to 4 thread blocks a matrix, R x CC
register tiles; the choice depends on s and the dtype, not on nb) and on
each side of its switch points. Everything here carries the `cuda` marker
and skips where there is no CUDA device.

This file imports neither JAX nor the JAX package, so that it also runs on a
machine with the card and without JAX:

    python -m pytest --noconftest tests/test_torch_gj_kernels_card.py
"""

import numpy as np
import pytest
import torch

from scptoolbox_torch.ops import gj_kernels as gk


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _quasidefinite(nb, s, dtype, device, seed=0):
    """Jacobi-equilibrated [[H, A'], [A, -D]] blocks."""
    rng = np.random.default_rng(seed)
    n1 = s // 3 + 1
    n2 = s - n1
    G = rng.standard_normal((nb, n1, n1))
    K = np.zeros((nb, s, s))
    K[:, :n1, :n1] = G @ G.transpose(0, 2, 1) + n1 * np.eye(n1)
    A = rng.standard_normal((nb, n2, n1))
    K[:, n1:, :n1] = A
    K[:, :n1, n1:] = A.transpose(0, 2, 1)
    K[:, n1:, n1:] = -(np.abs(rng.standard_normal((nb, n2, 1))) + 0.1) \
        * np.eye(n2)
    sc = 1.0 / np.sqrt(np.abs(np.diagonal(K, axis1=1, axis2=2)))
    K = K * sc[:, :, None] * sc[:, None, :]
    return torch.as_tensor(K, dtype=dtype, device=device)


# (nb, s): the Starship CR blocks at their batches, both sides of the lane
# column counts (s = 32 | 33, 64 | 65, 128 | 129, 160 | 161), of the tile
# rows (16-row chunks: 16 | 17, 96 | 97, 128 | 129) and of the cluster
# sizes (below), the smallest and the largest s
SHAPES = [(512, 158), (32, 145), (64, 158), (4, 145), (1, 158), (1, 1),
          (3, 2), (5, 31), (5, 32), (5, 33), (2, 64), (2, 65), (7, 96),
          (7, 97), (7, 128), (7, 129), (3, 160), (3, 161), (2, 169),
          (2, 192), (2, 193), (2, 240), (2, 256), (300, 16), (300, 17)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nb,s", SHAPES)
def test_gj_inverse_equals_plain_on_card(card, nb, s, dtype):
    M = _quasidefinite(nb, s, dtype, card)
    gk.reset_launch_counts()
    out = gk.gj_inverse(M)
    assert gk.launch_counts() == {"gj_inverse": 1}
    assert torch.equal(out, gk.gj_inverse_plain(M))
    eye = torch.eye(s, dtype=torch.float64, device=card)
    res = (M.double() @ out.double() - eye).abs().max().item()
    assert res < (1e-2 if dtype == torch.float32 else 1e-9), res


# the launcher's cluster size C on each side of its switch points: the
# fewest blocks a matrix whose tiles fit in 64 registers a thread
SWITCHES = {torch.float32: [(160, 1), (161, 2), (256, 2)],
            torch.float64: [(128, 1), (129, 2), (160, 2), (161, 3),
                            (192, 3), (193, 4), (256, 4)]}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gj_launcher_switch_points_on_card(card, dtype):
    for s, C in SWITCHES[dtype]:
        p = gk.plan(s, dtype)
        assert p["C"] == C, (s, p)
        M = _quasidefinite(3, s, dtype, card, seed=s)
        assert torch.equal(gk.gj_inverse(M), gk.gj_inverse_plain(M)), s


# (s, dtype): one shape of each design the launcher chooses (C = 1 in both
# dtypes, 2, 3 and 4)
DESIGNS = [(40, torch.float32), (40, torch.float64), (145, torch.float64),
           (200, torch.float32), (170, torch.float64), (200, torch.float64)]


@pytest.mark.cuda
@pytest.mark.parametrize("s,dtype", DESIGNS)
def test_gj_inverse_pivot_floor_and_nan_on_card(card, s, dtype):
    M = _quasidefinite(3, s, dtype, card)
    M[1, 0, 0] = 0.0                   # below the floor: d = 1e30
    M[1, 17, 17] = 1e-35
    M[2, 4, 5] = float("nan")
    M[2, s - 10, 3] = float("nan")
    out, ref = gk.gj_inverse(M), gk.gj_inverse_plain(M)
    assert torch.equal(out.isnan(), ref.isnan())
    ok = ~ref.isnan()
    assert torch.equal(out[ok], ref[ok])
    assert ref[0].isfinite().all() and ref[2].isnan().any()


@pytest.mark.cuda
def test_gj_inverse_empty_and_refused_on_card(card):
    assert gk.gj_inverse(torch.zeros(2, 0, 0, device=card)).shape == (2, 0, 0)
    assert gk.gj_inverse(torch.zeros(0, 5, 5, device=card)).shape == (0, 5, 5)
    with pytest.raises(ValueError):
        gk.gj_inverse(torch.zeros(1, 257, 257, device=card))
    with pytest.raises(ValueError):
        gk.plan(257, torch.float32)
