"""The geometry sets and the two SCvx models of the port against the JAX
package on the CPU (float64).

`Ellipsoid` and `Hyperrectangle` and the homogeneous transforms at seeded
inputs; every function of the quadrotor and free-flyer problems at N=6 and
at seeded points, to 1e-12; the free-flyer's solver scaling (the LP
auto-scaling of its unadvised entries) to 1e-9, and one SCvx step with the
q = 4 trust region (its tr_w / tr_geom rows) to 1e-7. One JAX solver, the
free-flyer's (torch_refs.FF_PARS), whose constructor runs the scaling LPs;
the model functions and the sets run eagerly."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scptoolbox_torch import interop
from scptoolbox_torch.utils import geometry as tg
from scptoolbox_tpu.utils import geometry as jg
from tests import torch_refs as refs

torch.set_num_threads(1)

N = 6


def _t(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


def _close(b, a, rtol, what=""):
    """b within rtol of a, relative to a's largest entry."""
    a = np.asarray(a, dtype=float)
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_allclose(b, a, rtol=rtol,
                               atol=rtol * np.abs(a).max(initial=0.0),
                               err_msg=what)


def _ellipsoid(seed, n):
    rng = np.random.default_rng(seed)
    H = rng.standard_normal((n, n)) + 2.0 * np.eye(n)
    c = rng.standard_normal(n)
    r = c + rng.standard_normal((4, n))
    return H, c, r


@pytest.mark.parametrize("seed,n", [(0, 3), (1, 4)])
def test_ellipsoid_value_and_grad_match_jax(seed, n):
    H, c, r = _ellipsoid(seed, n)
    Ej, Et = jg.Ellipsoid(jnp.asarray(H), jnp.asarray(c)), tg.Ellipsoid(
        _t(H), _t(c))
    for ri in r:
        _close(Et(_t(ri)), Ej(jnp.asarray(ri)), 1e-12, "value")
        _close(Et.grad(_t(ri)), Ej.grad(jnp.asarray(ri)), 1e-12, "grad")
    radii, center = np.abs(c) + 0.5, r[0]
    Fj = jg.Ellipsoid.from_radii(jnp.asarray(radii), jnp.asarray(center))
    Ft = tg.Ellipsoid.from_radii(_t(radii), _t(center))
    _close(Ft.H, Fj.H, 1e-12, "from_radii H")
    _close(Ft(_t(r[1])), Fj(jnp.asarray(r[1])), 1e-12, "from_radii value")


@pytest.mark.parametrize("axes", [[0, 1], [2], [1, 3], [0, 1, 2, 3]])
def test_ellipsoid_project_matches_jax(axes):
    """The shadow on a subset of axes: Schur complement, then eigh."""
    H, c, _ = _ellipsoid(2, 4)
    Pj = jg.Ellipsoid(jnp.asarray(H), jnp.asarray(c)).project(axes)
    Pt = tg.Ellipsoid(_t(H), _t(c)).project(axes)
    _close(Pt.H, Pj.H, 1e-12, "H")
    _close(Pt.c, Pj.c, 1e-12, "c")


def test_hyperrectangles_match_jax():
    """from_extrusion at the free-flyer's six rooms, from_ranges, s, center,
    contains; an extrusion that is not axis-aligned is refused."""
    rj = refs.jff.FreeFlyerParameters().rooms()
    rt = refs.tff.FreeFlyerParameters().rooms()
    rng = np.random.default_rng(3)
    for a, b in zip(rj, rt):
        for f in ("l", "u", "s", "center"):
            _close(getattr(b, f), getattr(a, f), 1e-12, f)
        for x in a.center + 0.6 * rng.standard_normal((5, 3)) * a.s:
            assert bool(b.contains(_t(x))) == bool(a.contains(x))
    hj = jg.Hyperrectangle.from_ranges((0.0, 1.0), (-2.0, 3.0))
    ht = tg.Hyperrectangle.from_ranges((0.0, 1.0), (-2.0, 3.0))
    _close(ht.l, hj.l, 0.0)
    _close(ht.u, hj.u, 0.0)
    for bad in (dict(yaw=45.0), dict(pitch=30.0), dict(roll=10.0)):
        with pytest.raises(ValueError):
            tg.Hyperrectangle.from_extrusion([0, 0, 0], 1, 1, 1, **bad)


def test_homogeneous_transforms_match_jax():
    rng = np.random.default_rng(4)
    Q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    t = rng.standard_normal(3)
    Tj = jg.homtransf(jnp.asarray(Q), jnp.asarray(t))
    Tt = tg.homtransf(_t(Q), _t(t))
    _close(Tt, Tj, 1e-12, "homtransf")
    _close(tg.hominv(Tt), jg.hominv(Tj), 1e-12, "hominv")
    _close(tg.homdisp(Tt), jg.homdisp(Tj), 0.0, "homdisp")
    _close(tg.homrot(Tt), jg.homrot(Tj), 0.0, "homrot")
    _close(tg.homtransf(), jg.homtransf(), 0.0, "identity")


def test_model_parameters_from_jax_dataclasses():
    """interop.model_parameters rebuilds both parameter sets from
    dataclasses.asdict of the JAX ones."""
    for jcls, tcls in ((refs.jquad.QuadrotorParameters,
                        refs.tquad.QuadrotorParameters),
                       (refs.jff.FreeFlyerParameters,
                        refs.tff.FreeFlyerParameters)):
        made = interop.model_parameters(tcls, dataclasses.asdict(jcls()))
        assert made == tcls()
    mdl = interop.model_parameters(
        refs.tquad.QuadrotorParameters, dataclasses.asdict(
            refs.jquad.QuadrotorParameters(rf=(1.0, 2.0, 3.0), gamma=0.3)))
    assert mdl.rf == (1.0, 2.0, 3.0) and mdl.gamma == 0.3


@pytest.fixture(scope="module")
def problems():
    """{name: (JAX problem, port problem)} at N=6."""
    return {
        "quadrotor": (refs.jquad.quadrotor(), refs.tquad.quadrotor()),
        "freeflyer": (refs.jff.freeflyer(N=N), refs.tff.freeflyer(N=N)),
    }


def _points(J, seed):
    """A seeded point near the guess's node 2: (t, k, x, u, p)."""
    rng = np.random.default_rng(seed)
    xg, ug, pg = (np.asarray(a) for a in J.guess(N))
    x = xg[2] + 0.1 * rng.standard_normal(J.nx)
    u = ug[2] + 0.01 * rng.standard_normal(J.nu)
    p = pg * (1.0 + 0.01 * rng.standard_normal(J.np))
    return 0.3, 2, x, u, p


FUNCTIONS = ["f", "s", "U", "X", "gic", "gtc", "running_cost",
             "terminal_cost", "integration_actions", "guess"]


@pytest.mark.parametrize("name", FUNCTIONS)
@pytest.mark.parametrize("model", ["quadrotor", "freeflyer"])
def test_model_functions_match_jax(problems, model, name):
    """Each callback at two seeded points (cone kinds equal, values to
    1e-12), the guess at N=6 and the scaling advice, NaN where none is
    given."""
    J, T = problems[model]
    if getattr(J, name) is None:
        assert getattr(T, name) is None
        return
    if name == "guess":
        for a, b in zip(J.guess(N), T.guess(N)):
            _close(b, a, 1e-12, "guess")
        for r in ("xrg", "urg", "prg"):
            a, b = getattr(J, r), getattr(T, r)
            assert (a is None) == (b is None), r
            if a is not None:
                np.testing.assert_array_equal(b.lo, np.asarray(a.lo))
                np.testing.assert_array_equal(b.hi, np.asarray(a.hi))
        return
    for seed in (0, 1):
        t, k, x, u, p = _points(J, seed)
        fj, ft = getattr(J, name), getattr(T, name)
        jt, jk, jx, ju, jp = (jnp.asarray(t), jnp.asarray(k), jnp.asarray(x),
                              jnp.asarray(u), jnp.asarray(p))
        tt, tk, tx, tu, tp = (_t(t), torch.tensor(k), _t(x), _t(u), _t(p))
        args = {"f": ((jt, jx, ju, jp), (tt, tx, tu, tp)),
                "s": ((jt, jk, jx, ju, jp), (tt, tk, tx, tu, tp)),
                "U": ((jt, jk, ju, jp), (tt, tk, tu, tp)),
                "X": ((jt, jk, jx, jp), (tt, tk, tx, tp)),
                "gic": ((jx, jp), (tx, tp)), "gtc": ((jx, jp), (tx, tp)),
                "running_cost": ((jt, jk, jx, ju, jp), (tt, tk, tx, tu, tp)),
                "terminal_cost": ((jx, jp), (tx, tp)),
                "integration_actions": ((jx,), (tx,))}[name]
        a, b = fj(*args[0]), ft(*args[1])
        if name in ("U", "X"):
            assert [c.kind.value for c in a] == [c.kind.value for c in b]
            a = np.concatenate([np.asarray(c.v) for c in a])
            b = torch.cat([c.v for c in b])
        _close(b, a, 1e-12, f"{model}.{name} seed {seed}")


@pytest.fixture(scope="module")
def ff_pair():
    return refs.freeflyer_scvx_pair()


def test_freeflyer_scaling_matches_jax(ff_pair):
    """The solver scaling: advice where given, the LP bounds of the X/U sets
    where the advice is NaN (v, omega, T, M), the [0, 1] default for the
    unbounded quaternion; to 1e-9."""
    J, T = ff_pair
    for f in J.scaling._fields:
        _close(getattr(T.scaling, f), getattr(J.scaling, f), 1e-9, f)
    assert np.isnan(T.pbm.xrg.lo[3:]).all() and T.pbm.urg is None
    assert torch.all(T.scaling.Sx[6:10] == 1.0)


def test_freeflyer_q4_step_matches_jax(ff_pair):
    """One step from the guess at eta = 0.7 with q_tr = 4 (w >= the 2-norm
    of the three epigraph columns, eta >= w^2 as an SOC): the IPM solution,
    L, J_aug, the deviation and the defect norm to 1e-7 relative."""
    J, T = ff_pair
    assert T.tmpl.plan.rows("tr_geom").shape == (N, 3)
    assert T.spec == refs.interop.cone_spec(
        J.spec.nz, J.spec.nl, J.spec.socs, J.spec.nexp)
    _, dl = J._ref_J_aug(*J._guess, J.consts)
    oj = J._step(*J._guess, dl, jnp.asarray(0.7, J.dtype), J.consts)
    ref = tuple(a[None] for a in T._guess)
    _, dl = T._ref_J_aug_impl(*ref, T.consts)
    out = T._step_impl(*ref, dl, torch.tensor([0.7], dtype=torch.float64),
                       T.consts)
    assert int(out["ipm_status"][0]) == int(oj["ipm_status"])
    assert int(out["ipm_iters"][0]) == int(oj["ipm_iters"])
    for k in ("x", "u", "p", "L", "L_aug", "J_aug", "deviation",
              "defect_norm"):
        _close(out[k][0], oj[k], 1e-7, k)
