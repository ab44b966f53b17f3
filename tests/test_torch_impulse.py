"""IMPULSE discretization, the rendezvous models and the quaternion
utilities of the port against the JAX package on the CPU (float64).

The planar rendezvous at N=8, Nsub=5 (solve_rendezvous_planar's other
parameters, the first rung of its homotopy, the block sweep forced): the IMPULSE DLTV at the
guess, the IMPULSE replay, and two whole PTR iterations, the slice end to
end on the block sweep. The 3-D rendezvous model's callbacks and every
quaternion function at seeded random inputs. JAX compiles the PTR's
structure probe, its discretization and its step, and each 3-D callback
once; the replay and the quaternion functions run eagerly."""

import dataclasses
import math
from importlib import import_module

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scptoolbox_torch import interop
from scptoolbox_torch.ops import discretize as tdisc
from scptoolbox_torch.utils import quaternion as tq
from scptoolbox_tpu.ops import discretize as jdisc
from scptoolbox_tpu.utils import quaternion as jq
from tests import torch_refs as refs

torch.set_num_threads(1)

j3 = import_module("scptoolbox_tpu.models.rendezvous_3d")
t3 = import_module("scptoolbox_torch.models.rendezvous_3d")


def _t(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


def _close(b, a, rtol, what=""):
    """b within rtol of a, relative to a's largest entry."""
    a = np.asarray(a)
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_allclose(b, a, rtol=rtol,
                               atol=rtol * np.abs(a).max(initial=0.0),
                               err_msg=what)


@pytest.fixture(scope="module")
def planar():
    return refs.planar_pair()


def test_impulse_dltv_matches_jax(planar):
    """discretize(..., IMPULSE) at the guess, field by field; r and the
    defects (differences of propagated states) at the states' scale."""
    J, T = planar
    dj = J._discretize(*J._guess)
    dt_ = T._discretize(*(a[None] for a in T._guess))
    xscale = np.abs(np.asarray(dj.xprop)).max()
    for name in jdisc.DLTV._fields:
        a = np.asarray(getattr(dj, name))
        b = getattr(dt_, name)[0].numpy()
        scale = (xscale if name in ("r", "defects")
                 else np.abs(a).max(initial=0.0))
        np.testing.assert_allclose(b, a, rtol=1e-10, atol=1e-10 * scale,
                                   err_msg=name)
    assert np.abs(np.asarray(dj.Bp)).max() == 0.0
    assert np.abs(np.asarray(dj.Bm)).max() > 0.0


def test_impulse_propagate_matches_jax(planar):
    """The continuous replay under seeded thrusts: jump at each node, then
    coast (JAX eagerly)."""
    J, T = planar
    rng = np.random.default_rng(3)
    xg, ug, pg = (np.asarray(a) for a in J._guess)
    u = ug.copy()
    u[:, :3] = 300.0 * rng.standard_normal((len(u), 3))
    t = J.t_np
    with jax.disable_jit():
        ts_j, xs_j = jdisc.propagate(
            J.pbm.f, jnp.asarray(xg[0]), jnp.asarray(u), jnp.asarray(pg),
            jnp.asarray(t), nsub=3, method=jdisc.DiscretizationType.IMPULSE,
            impulse=J.pbm.impulse)
    ts_t, xs_t = tdisc.propagate(
        T.pbm.f, _t(xg[0]), _t(u), _t(pg), _t(t), nsub=3,
        method=tdisc.DiscretizationType.IMPULSE, impulse=T.pbm.impulse)
    _close(ts_t, ts_j, 1e-10, "ts")
    _close(xs_t, xs_j, 1e-10, "xs")


@pytest.fixture(scope="module")
def two_iterations(planar):
    """Two PTR iterations from the guess in both packages."""
    J, T = planar
    # a strongly typed reference cost, as the step returns: one compile
    out_j = J._step(*J._guess, J._discretize(*J._guess),
                    jnp.asarray(np.inf, J.dtype), J.consts)
    out_j = [out_j, J._step(out_j["x"], out_j["u"], out_j["p"],
                            out_j["dltv"], out_j["J_aug"], J.consts)]
    ref = tuple(a[None] for a in T._guess)
    out_t = T._step_impl(*ref, T._discretize(*ref),
                         torch.full((1,), math.inf, dtype=torch.float64),
                         T.consts)
    out_t = [out_t, T._step_impl(out_t["x"], out_t["u"], out_t["p"],
                                 out_t["dltv"], out_t["J_aug"], T.consts)]
    return out_j, out_t


@pytest.mark.parametrize("key", ["x", "u", "p"])
def test_two_ptr_iterations_match_jax(planar, two_iterations, key):
    """The slice as a whole: IMPULSE discretization, assembly, the block
    sweep inside the IPM and the re-discretization, twice."""
    J, T = planar
    assert T._kkt_method is None and T.kkt_builder is not None
    out_j, out_t = two_iterations
    for oj, ot in zip(out_j, out_t):
        assert int(ot["ipm_iters"][0]) == int(oj["ipm_iters"])
        assert int(ot["ipm_status"][0]) == int(oj["ipm_status"])
        assert float(ot["J_aug"][0]) == pytest.approx(float(oj["J_aug"]),
                                                      rel=1e-6)
    _close(out_t[1][key][0], out_j[1][key], 1e-6, key)


@pytest.fixture(scope="module")
def rdv3d():
    mj = j3.Rendezvous3DParameters(hom_steps=5)
    mt = interop.model_parameters(t3.Rendezvous3DParameters,
                                  dataclasses.asdict(mj))
    return j3.rendezvous_3d(mj, N=15), t3.rendezvous_3d(mt, N=15)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(13)
    x[6:10] /= np.linalg.norm(x[6:10])
    u = 200.0 * np.abs(rng.standard_normal(33))
    p = 0.05 * rng.standard_normal(14)
    p[0] = 550.0
    return x, u, p


@pytest.mark.parametrize("fn", ["f", "impulse", "s", "X", "U", "gic", "gtc",
                                "integration_actions", "guess"])
def test_rendezvous_3d_callbacks_match_jax(rdv3d, fn):
    pj, pt = rdv3d
    x, u, p = _inputs(11)
    hom = float(j3.Rendezvous3DParameters(hom_steps=5).hom_grid()[2])
    for k in ((4, 14) if fn == "X" else (4,)):   # only X reads k
        args = {"f": (0.3, x, u, p), "impulse": (0.3, x, u, p),
                "s": (0.3, k, x, u, p), "X": (0.3, k, x, p),
                "U": (0.3, k, u, p), "gic": (x, p), "gtc": (x, p),
                "integration_actions": (x,)}.get(fn)
        if fn == "guess":
            out_j, out_t = pj.guess(15, None), pt.guess(15, None)
        else:
            kw_j = {"consts": {"hom": jnp.asarray(hom)}} if fn == "s" else {}
            kw_t = {"consts": {"hom": _t(hom)}} if fn == "s" else {}
            # X and U return cone tags; the others compile once, faster
            # than JAX's op-by-op first call
            fj = getattr(pj, fn)
            fj = fj if fn in ("X", "U") else jax.jit(fj)
            out_j = fj(*(jnp.asarray(a) for a in args), **kw_j)
            out_t = getattr(pt, fn)(*(torch.tensor(a) if isinstance(a, int)
                                      else _t(a) for a in args), **kw_t)
        if fn in ("X", "U"):
            assert [c.kind.value for c in out_t] == [c.kind.value
                                                     for c in out_j]
            out_j, out_t = [c.v for c in out_j], [c.v for c in out_t]
        if isinstance(out_j, (list, tuple)):
            for a, b in zip(out_j, out_t):
                _close(b, a, 1e-12, fn)
        else:
            _close(out_t, out_j, 1e-12, fn)


def _quaternions(seed, n=6):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    # the identity and near-axis rotations reach every branch of log,
    # slerp and from_dcm
    q[0] = [0.0, 0.0, 0.0, 1.0]
    q[1] = [0.999, 0.01, 0.02, 0.03]
    q[2] = [0.01, 0.999, 0.02, 0.03]
    q[3] = [0.01, 0.02, 0.999, 0.03]
    return q / np.linalg.norm(q, axis=1, keepdims=True)


# (module, q, a second unit quaternion p, a vector r) -> output
QUAT_CASES = {
    "identity": lambda m, q, p, r: m.identity(),
    "from_parts": lambda m, q, p, r: m.from_parts(r, q[3]),
    "vector": lambda m, q, p, r: m.vector(q),
    "scalar": lambda m, q, p, r: m.scalar(q),
    "from_angleaxis": lambda m, q, p, r: m.from_angleaxis(q[3] * 3.0, r),
    "skew_L": lambda m, q, p, r: m.skew_L(q),
    "skew_R": lambda m, q, p, r: m.skew_R(q),
    "mul": lambda m, q, p, r: m.mul(q, p),
    "conj": lambda m, q, p, r: m.conj(q),
    "normalize": lambda m, q, p, r: m.normalize(2.5 * q),
    "log": lambda m, q, p, r: m.log(q),
    "rotate": lambda m, q, p, r: m.rotate(q, r),
    "dcm": lambda m, q, p, r: m.dcm(q),
    "rpy": lambda m, q, p, r: m.rpy(q),
    "slerp": lambda m, q, p, r: m.slerp(q, p, 0.37),
    "slerp_near": lambda m, q, p, r: m.slerp(q, q, 0.6),
    "ddq": lambda m, q, p, r: m.ddq(q, r),
    "from_dcm": lambda m, q, p, r: m.from_dcm(m.dcm(q)),
}


@pytest.mark.parametrize("name", sorted(QUAT_CASES))
def test_quaternion_matches_jax(name):
    rng = np.random.default_rng(5)
    qs = _quaternions(17)
    for q, p in zip(qs, np.roll(qs, 1, axis=0)):
        r = rng.standard_normal(3)
        out_j = QUAT_CASES[name](jq, *(jnp.asarray(a) for a in (q, p, r)))
        out_t = QUAT_CASES[name](tq, _t(q), _t(p), _t(r))
        if isinstance(out_j, tuple):
            for a, b in zip(out_j, out_t):
                _close(b, a, 1e-12, name)
        else:
            _close(out_t, out_j, 1e-12, name)
