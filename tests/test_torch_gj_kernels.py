"""The port's batched Gauss-Jordan inverse (scptoolbox_torch/ops/gj_kernels.py)
against the JAX package's Pallas gj_inverse (interpret mode on the CPU), on
the same numpy inputs: Jacobi-equilibrated quasidefinite blocks
[[H, A'], [A, -D]], the blocks that kernel was written for.

s = 13 is no multiple of the Pallas wrapper's 8-row sublane padding. The
tolerances, relative to the largest entry, are 1e-12 in float64 and 1e-5 in
float32: the two sides do the same operations in the same order, but XLA on
the CPU may contract a product into the subtraction that follows it, which
rounds once where the port rounds twice.

The CUDA kernel runs only on the card: test_torch_gj_kernels_card.py holds
it against the plain version there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scptoolbox_torch.ops import gj_kernels as gk
from scptoolbox_tpu.ops import pallas_kernels as pk

torch.set_num_threads(1)

TOL = {np.float64: 1e-12, np.float32: 1e-5}


def quasidefinite(rng, nb, s):
    """nb Jacobi-equilibrated quasidefinite blocks of size s, float64."""
    n1 = s // 3 + 1
    n2 = s - n1
    G = rng.standard_normal((nb, n1, n1))
    H = G @ G.transpose(0, 2, 1) + n1 * np.eye(n1)
    A = rng.standard_normal((nb, n2, n1))
    D = np.abs(rng.standard_normal((nb, n2))) + 0.1
    K = np.zeros((nb, s, s))
    K[:, :n1, :n1] = H
    K[:, n1:, :n1] = A
    K[:, :n1, n1:] = A.transpose(0, 2, 1)
    K[:, n1:, n1:] = -D[:, :, None] * np.eye(n2)
    sc = 1.0 / np.sqrt(np.abs(np.diagonal(K, axis1=1, axis2=2)))
    return K * sc[:, :, None] * sc[:, None, :]


@pytest.fixture(scope="module")
def pallas_inverses():
    """The blocks and the Pallas inverses of both dtypes, from one jitted
    call (one JAX compile for the file)."""
    M = quasidefinite(np.random.default_rng(13), 5, 13)
    both = jax.jit(lambda a, b: (pk.gj_inverse(a, interpret=True),
                                 pk.gj_inverse(b, interpret=True)))
    inv64, inv32 = both(jnp.asarray(M), jnp.asarray(M.astype(np.float32)))
    return M, {np.float64: np.asarray(inv64), np.float32: np.asarray(inv32)}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_gj_inverse_plain_matches_pallas(pallas_inverses, dtype):
    M, ref = pallas_inverses
    Mt = torch.as_tensor(M.astype(dtype))
    gk.reset_launch_counts()
    out = gk.gj_inverse(Mt)                  # a CPU tensor: the plain version
    assert gk.launch_counts() == {"gj_inverse": 0}
    assert out.dtype == Mt.dtype and out.shape == Mt.shape
    assert torch.equal(out, gk.gj_inverse_plain(Mt))
    got = out.numpy().astype(np.float64)
    want = ref[dtype].astype(np.float64)
    assert np.abs(got - want).max() <= TOL[dtype] * np.abs(want).max()
    # and it is the inverse
    eye = np.broadcast_to(np.eye(13), M.shape)
    assert np.abs(M @ got - eye).max() <= 1e3 * TOL[dtype]


def _step_zero(M):
    """What step 0 of the Jordan exchange gives, written out from the rule."""
    p = M[0, 0]
    d = (-1.0 if p < 0 else 1.0) / max(abs(p), 1e-30)
    out = M - np.outer(M[:, 0], M[0] * d)
    out[:, 0] = -M[:, 0] * d
    out[0] = M[0] * d
    out[0, 0] = d
    return d, out


@pytest.mark.parametrize("pivot", [0.0, -1e-40])
def test_pivot_floor_keeps_the_sign(pivot):
    """A zero and a negative-tiny pivot take the 1e-30 floor with their sign
    (1/1e-30 and -1/1e-30), as the Pallas kernel's rule says; a 1x1 block makes
    the whole result that one step, and a 3x3 block's first step is checked
    entry by entry through the fully exchanged result."""
    floored = (1.0 if pivot == 0.0 else -1.0) / 1e-30
    one = gk.gj_inverse_plain(torch.tensor([[[pivot]]], dtype=torch.float64))
    assert one.item() == floored
    M = np.array([[pivot, 2.0, -1.0], [3.0, 1.0, 0.5], [-2.0, 0.25, 4.0]])
    d, after0 = _step_zero(M)
    assert d == floored
    # exchanging the remaining pivots of `after0` must give the same block as
    # exchanging all three of M
    full = gk.gj_inverse_plain(torch.as_tensor(M[None])).numpy()[0]
    W = torch.as_tensor(after0[None])
    for j in (1, 2):                      # steps 1 and 2 by the same rule
        sub = W[0].numpy()
        p = sub[j, j]
        dj = (-1.0 if p < 0 else 1.0) / max(abs(p), 1e-30)
        nxt = sub - np.outer(sub[:, j], sub[j] * dj)
        nxt[:, j] = -sub[:, j] * dj
        nxt[j] = sub[j] * dj
        nxt[j, j] = dj
        W = torch.as_tensor(nxt[None])
    np.testing.assert_array_equal(W.numpy()[0], full)


def test_nan_in_gives_nan_out():
    M = torch.as_tensor(quasidefinite(np.random.default_rng(1), 2, 6))
    M[1, 2, 3] = float("nan")
    out = gk.gj_inverse(M)
    assert torch.isfinite(out[0]).all()
    assert torch.isnan(out[1]).any()
    Mp = M.clone()
    Mp[0, 0, 0] = float("nan")               # a NaN pivot: d is NaN
    assert torch.isnan(gk.gj_inverse(Mp)[0]).all()


def test_empty_and_off_device():
    assert gk.gj_inverse(torch.zeros(3, 0, 0)).shape == (3, 0, 0)
    with pytest.raises(ValueError):
        gk.gj_inverse(torch.empty(2, 3, 3, device="meta"))
