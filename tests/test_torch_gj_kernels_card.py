"""The CUDA Gauss-Jordan inverse (scptoolbox_torch/csrc/gj_kernels.cu)
against its plain PyTorch version, on the card, at the staged KKT's block
shapes (the Starship CR blocks, s = 158 and 145). Everything here carries
the `cuda` marker and skips where there is no CUDA device.

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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nb,s", [(512, 158), (32, 145)])
def test_gj_inverse_equals_plain_on_card(card, nb, s, dtype):
    M = _quasidefinite(nb, s, dtype, card)
    gk.reset_launch_counts()
    out = gk.gj_inverse(M)
    assert gk.launch_counts() == {"gj_inverse": 1}
    assert torch.equal(out, gk.gj_inverse_plain(M))
    eye = torch.eye(s, dtype=torch.float64, device=card)
    res = (M.double() @ out.double() - eye).abs().max().item()
    assert res < (1e-2 if dtype == torch.float32 else 1e-9), res


@pytest.mark.cuda
def test_gj_inverse_pivot_floor_and_nan_on_card(card):
    M = _quasidefinite(3, 13, torch.float64, card)
    M[1, 0, 0] = 0.0
    M[2, 4, 5] = float("nan")
    assert torch.equal(gk.gj_inverse(M).isnan(),
                       gk.gj_inverse_plain(M).isnan())
    out, ref = gk.gj_inverse(M), gk.gj_inverse_plain(M)
    ok = ~ref.isnan()
    assert torch.equal(out[ok], ref[ok])
    assert gk.gj_inverse(torch.zeros(2, 0, 0, device=card)).shape == (2, 0, 0)
