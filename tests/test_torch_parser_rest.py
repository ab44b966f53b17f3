"""The rest of the port's parser against the JAX package's (float64, CPU):
the GEOM cone's SOC lowering (scptoolbox_torch/solvers/template.py) for
n = 1..7 terms and AM-GM (tests/test_cones.py:158-200), ConicProgram's
introspection accessors (tests/test_introspection.py), constraint_structure,
the KKT variational program (scptoolbox_torch/parser/variation.py) on the
four closed-form sensitivities of tests/test_variation.py with its
perturbation bounds, and the perturbation specs.

Each program is held to its closed form by the port's own solve, and its
lowering to the JAX package's: the same program declared in both packages
assembles to the same (A, b, c) (the JAX assembly jitted: eagerly it
takes ~4 s a program on the CPU). The sensitivities' parameter tangents
are held to JAX's jvp, and one whole variational program, built in both
packages from the port's solution, to the JAX package's lowered data."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scptoolbox_torch.parser import perturbation as tpert
from scptoolbox_torch.parser import problem as tprob
from scptoolbox_torch.parser.program import ConicProgram as TProgram
from scptoolbox_torch.parser.variation import variation as tvariation
from scptoolbox_tpu.parser import perturbation as jpert
from scptoolbox_tpu.parser import problem as jprob
from scptoolbox_tpu.parser.program import ConicProgram as JProgram
from scptoolbox_tpu.parser.program import ProgramSolution as JSolution
from scptoolbox_tpu.parser.variation import variation as jvariation

torch.set_num_threads(1)
PKG = {"jax": (jprob, JProgram, jnp.asarray, jnp.concatenate),
       "torch": (tprob, lambda: TProgram(device="cpu"),
                 lambda a: torch.as_tensor(np.asarray(a)), torch.cat)}


def _same_data(pj, pt, params=None, tol=1e-12):
    """Both programs' lowered (A, b, c, const) at the same parameters."""
    params = params or {}
    got = pt._assemble({n: torch.as_tensor(params.get(n, v),
                                           dtype=torch.float64)
                        for n, (_, v) in pt._pars.items()})
    want = jax.jit(pj._assemble)({n: jnp.asarray(params.get(n, v))
                                  for n, (_, v) in pj._pars.items()})
    assert pt.spec == type(pt.spec)(nz=pj.spec.nz, nl=pj.spec.nl,
                                    socs=pj.spec.socs, nexp=pj.spec.nexp)
    for name, g, w in zip("Abc", got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=tol,
                                   atol=tol * max(np.abs(w).max(), 1.0),
                                   err_msg=name)


def _geom_program(pkg, n, xval):
    """max t s.t. geomean(x) >= t, x fixed at xval."""
    P, make, arr, cat = PKG[pkg]
    prg = make()
    t = prg.variable("t")
    x = prg.variable("x", n)
    xv0 = arr(xval)
    prg.add_constraint("fix", lambda xv: [P.zero(xv - xv0)], (x,))
    prg.add_constraint("gm", lambda tv, xv: [P.geom(cat(
        [tv.reshape(1), xv]))], (t, x))
    prg.add_cost(lambda tv: -(tv.sum()), (t,))
    prg.build()
    return prg


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 6, 7])
def test_geom_lowering_matches_jax_and_geomean(n):
    """The lowering (one nonneg row for n = 1, a sqrt tree padded to the
    next power of two above) posts the JAX package's rows, and the solve
    reaches the geometric mean to rel 1e-6 (tests/test_cones.py:158-182)."""
    xval = 0.5 + np.random.default_rng(n).random(n)
    pt = _geom_program("torch", n, xval)
    _same_data(_geom_program("jax", n, xval), pt)
    sol = pt.solve()
    gm = float(np.exp(np.mean(np.log(xval))))
    assert float(sol.values["t"]) == pytest.approx(gm, rel=1e-6)
    assert sol.duals["gm0"].shape == (pt.plan.rows("gm0").size,)


def _am_gm(pkg, n=5):
    """min sum(x) s.t. geomean(x) >= 1."""
    P, make, arr, cat = PKG[pkg]
    prg = make()
    x = prg.variable("x", n)
    one = arr(np.ones(1))
    prg.add_constraint("gm", lambda xv: [P.geom(cat([one, xv]))], (x,))
    prg.add_cost(lambda xv: xv.sum(), (x,))
    prg.build()
    return prg


def test_geom_am_gm():
    """tests/test_cones.py:185-200: the optimum is x = 1, sum(x) = n."""
    pt = _am_gm("torch")
    _same_data(_am_gm("jax"), pt)
    sol = pt.solve()
    # np.allclose's tolerance, as the JAX test (the JAX package's own solve
    # of this program lands on the same point, 1.9e-5 from 1 on x_5)
    np.testing.assert_allclose(sol.values["x"].numpy(), 1.0, rtol=1e-5,
                               atol=1e-5)
    assert float(sol.obj) == pytest.approx(5.0, rel=1e-6)


def _introspected(pkg):
    """tests/test_introspection.py:13-25's program."""
    P, make, arr, cat = PKG[pkg]
    prg = make()
    x = prg.variable("x", 3)
    t = prg.variable("t")
    th = prg.parameter("theta", 1.0)
    prg.add_constraint(
        "ball", lambda tv, xv: [P.soc(cat([tv.reshape(1), xv]))], (t, x))
    prg.add_constraint("bound", lambda xv, tt: [P.nonpos(tt - xv)],
                       (x, th))
    prg.add_cost(lambda tv: tv.sum(), (t,))
    return prg


def test_introspection_matches_jax():
    pj, pt = _introspected("jax"), _introspected("torch")
    assert repr(pt) == pt.describe() == pj.describe()       # unbuilt
    pj.build()
    pt.build()
    for pat in (".*", "bo", "^ball$", "x"):
        assert pt.constraints(pat) == pj.constraints(pat), pat
    for pat in (".*", "^x$", "t"):
        assert pt.variables(pat) == pj.variables(pat), pat
    assert pt.parameters("theta") == pj.parameters("theta") == [
        ("theta", ())]
    text = pt.describe()
    assert text == pj.describe() and repr(pt) == text
    assert "ConicProgram (built): 4 variables, 7 rows" in text
    assert pt.constraints("bo") == [("bound", ("NONPOS",), (3,))]


def test_constraint_structure_matches_jax():
    def cons(P, cat, x, t):
        return [P.zero(x[:2]), P.soc(cat([t, x])), P.geom(cat([t, x])),
                P.nonpos(x), P.exp_cone(x)]

    x = np.asarray([1.0, 2.0, 3.0])
    t = np.asarray([4.0])
    kt, dt = tprob.constraint_structure(
        lambda *a: cons(tprob, torch.cat, *a), torch.as_tensor(x),
        torch.as_tensor(t))
    kj, dj = jprob.constraint_structure(
        lambda *a: cons(jprob, jnp.concatenate, *a), jnp.asarray(x),
        jnp.asarray(t))
    assert [k.name for k in kt] == [k.name for k in kj]
    assert dt == dj == (2, 4, 4, 3, 3)


# ---- the KKT variational program (tests/test_variation.py) ----


def _bound_program(pkg, theta, n=1):
    """min sum (x - 2)^2 s.t. x >= theta elementwise."""
    P, make, arr, cat = PKG[pkg]
    prg = make()
    x = prg.variable("x", n)
    th = prg.parameter("theta", theta)
    prg.add_constraint("bound", lambda xv, t: [P.nonpos(t - xv)], (x, th))
    prg.add_cost(lambda xv: ((xv - 2.0) ** 2).sum(), (x,))
    prg.build()
    return prg


def _ball_program(pkg):
    """min c'x s.t. ||x|| <= theta."""
    P, make, arr, cat = PKG[pkg]
    prg = make()
    x = prg.variable("x", 2)
    th = prg.parameter("theta", 2.0)
    c = arr(np.asarray([3.0, -4.0]))
    prg.add_constraint(
        "ball", lambda xv, t: [P.soc(cat([t.reshape(1), xv]))], (x, th))
    prg.add_cost(lambda xv: (c * xv).sum(), (x,))
    prg.build()
    return prg


def _plane_program(pkg):
    """min ||x||^2 s.t. a'x = theta."""
    P, make, arr, cat = PKG[pkg]
    prg = make()
    x = prg.variable("x", 3)
    th = prg.parameter("theta", 4.0)
    a = arr(np.asarray([1.0, 2.0, -1.0]))
    prg.add_constraint("plane", lambda xv, t: [P.zero(
        ((a * xv).sum() - t).reshape(1))], (x, th))
    prg.add_cost(lambda xv: (xv * xv).sum(), (x,))
    prg.build()
    return prg


A_PLANE = np.asarray([1.0, 2.0, -1.0])
C_BALL = np.asarray([3.0, -4.0])
# (program, theta, x*, dx/dtheta, tolerance of dx): tests/test_variation.py
CASES = {
    "active_bound": (lambda p: _bound_program(p, 3.0), 3.0, [3.0], [1.0],
                     1e-4),
    "inactive_bound": (lambda p: _bound_program(p, 1.0), 1.0, [2.0], [0.0],
                       1e-4),
    "soc_radius": (_ball_program, 2.0, -2.0 * C_BALL / 5.0, -C_BALL / 5.0,
                   1e-3),
    "equality_rhs": (_plane_program, 4.0, 4.0 * A_PLANE / 6.0, A_PLANE / 6.0,
                     1e-4),
}


def _jax_solution(sol):
    """A JAX ProgramSolution carrying the port's (x, z): the JAX
    Variation reads only those."""
    return JSolution(values=None, obj=None, status=None, duals=None,
                     x=jnp.asarray(sol.x.numpy()),
                     z=jnp.asarray(sol.z.numpy()), iters=None)


def _tangents(pkg, prg, x, z, theta):
    """d(b - A x) and d(A' z + c) in the direction d(theta) = 1: the
    tangents every row of the variational program is built from (the port
    takes them by torch.func.jvp through ConicProgram._assemble, the JAX
    package by jax.jvp, jitted here)."""
    if pkg == "torch":
        T = lambda v: torch.as_tensor(v, dtype=torch.float64)
        fn = lambda p: (lambda A, b, c, _: (b - A @ T(x), A.T @ T(z) + c))(
            *prg._assemble(p))
        out = torch.func.jvp(fn, ({"theta": T(theta)},),
                             ({"theta": T(1.0)},))[1]
        return [o.numpy() for o in out]
    fn = lambda p: (lambda A, b, c, _: (b - A @ x, A.T @ z + c))(
        *prg._assemble(p))
    out = jax.jit(lambda p, d: jax.jvp(fn, (p,), (d,))[1])(
        {"theta": jnp.asarray(theta)}, {"theta": jnp.asarray(1.0)})
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize("case", list(CASES))
def test_variation_matches_jax_and_closed_form(case):
    """The solution and its sensitivity against the closed forms at
    tests/test_variation.py's tolerances, and the parameter tangents of
    the lowered data against the JAX package's at the port's solution
    (one whole variational program is compared with the JAX package's in
    test_variation_perturbation_bounds: each JAX one takes several seconds
    of eager tracing on the CPU)."""
    build, theta, x_star, dx, tol = CASES[case]
    pt = build("torch")
    sol = pt.solve()
    np.testing.assert_allclose(sol.values["x"].numpy(), x_star, rtol=1e-5,
                               atol=1e-5)
    xhat = ((sol.x - pt._c_full) / pt._S_full).numpy()
    z = sol.z.numpy()
    got = _tangents("torch", pt, xhat, z, theta)
    want = _tangents("jax", build("jax"), xhat, z, theta)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12)
    d = tvariation(pt, sol, {"theta": theta}).solve({"theta": 1.0})
    np.testing.assert_allclose(d.dvalues["x"].numpy(), dx, rtol=1e-5,
                               atol=tol)


def test_variation_perturbation_bounds():
    """tests/test_variation.py:95-139: FIXED pins element 0's delta, FREE
    keeps element 1's tangent (relax=True; this variational program lowers
    to the JAX package's, built from the port's solution); ABSOLUTE 0.25
    clips both."""
    pt = _bound_program("torch", 3.0, n=2)
    sol = pt.solve()
    np.testing.assert_allclose(tvariation(pt, sol, {"theta": 3.0}).solve(
        {"theta": 1.0}).dvalues["x"].numpy(), 1.0, atol=1e-4)
    fix = [tpert.FIXED, tpert.FREE]
    vt = tvariation(pt, sol, {"theta": 3.0}, relax=True, perturbations={
        "x": tpert.Perturbation.make((2,), fix)})
    vj = jvariation(_bound_program("jax", 3.0, n=2), _jax_solution(sol),
                    {"theta": 3.0}, relax=True, perturbations={
                        "x": jpert.Perturbation.make(
                            (2,), [getattr(jpert, k.name) for k in fix])})
    _same_data(vj.kkt, vt.kkt, {"d_theta": 1.0}, tol=1e-10)
    dxv = vt.solve({"theta": 1.0}).dvalues["x"].numpy()
    assert abs(dxv[0]) < 1e-4
    assert dxv[1] == pytest.approx(1.0, abs=1e-3)
    vt = tvariation(pt, sol, {"theta": 3.0}, relax=True, perturbations={
        "x": tpert.Perturbation.make((2,), tpert.ABSOLUTE, 0.25)})
    dxv = vt.solve({"theta": 1.0}).dvalues["x"].numpy()
    assert np.all(np.abs(dxv) < 0.25 + 1e-4)


@pytest.mark.parametrize("shape,kind,amount", [
    ((2, 3), ["FIXED", "FREE", "ABSOLUTE"] * 2, 1.5),
    ((2, 2), "FIXED", None),
    ((3,), "RELATIVE", [0.1, 0.2, 0.3]),
    ((2, 2), ["FREE", "ABSOLUTE"], 2.0),
    ((), "ABSOLUTE", 0.5)])
def test_perturbation_spec_matches_jax(shape, kind, amount):
    pick = lambda mod, k: (getattr(mod, k) if isinstance(k, str)
                           else [getattr(mod, i) for i in k])
    pt = tpert.perturbation(shape, pick(tpert, kind), amount)
    pj = jpert.perturbation(shape, pick(jpert, kind), amount)
    assert [k.name for k in pt.kind.reshape(-1)] == [
        k.name for k in pj.kind.reshape(-1)]
    assert pt.kind.shape == pj.kind.shape
    np.testing.assert_array_equal(pt.amount, pj.amount)


def test_perturbation_spec_requires_amount():
    for mod in (tpert, jpert):
        with pytest.raises(ValueError):
            mod.Perturbation.make((3,), mod.ABSOLUTE)
