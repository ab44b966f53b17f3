"""The exponential cone of the port against the JAX package on the CPU
(float64): the cone functions on seeded blocks, ipm.solve on GuSTO's
softplus program on the dense Schur KKT and the QR-Cholesky KKT, and
GuSTO's structured running cost. The other small exp programs of
tests/test_exp_cone.py and ConicProgram with an exp_cone constraint are
held to their closed forms or scipy, as the JAX package's own tests hold
it: a JAX IPM compile takes ~5 s a spec (ROADMAP's test-time budget)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, hessian

from scptoolbox_torch.ops import cones as tcn
from scptoolbox_torch.ops import ipm as tipm
from scptoolbox_torch.parser import problem as tprob
from scptoolbox_torch.parser.program import ConicProgram as TProgram
from scptoolbox_tpu.ops import cones as jcn
from scptoolbox_tpu.ops import ipm as jipm
from scptoolbox_tpu.parser import problem as jprob
from tests import torch_refs as refs

torch.set_num_threads(1)
T64 = lambda a: torch.tensor(np.asarray(a), dtype=torch.float64)


def _close(b, a, rtol, what=""):
    """b within rtol of a, relative to a's largest entry."""
    a = np.asarray(a, dtype=float)
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_allclose(b, a, rtol=rtol,
                               atol=rtol * np.abs(a).max(initial=0.0),
                               err_msg=what)


def _primal_interior(rng, k):
    """k blocks strictly inside K_exp: y, z > 0, x < y log(z/y)."""
    y = rng.uniform(0.2, 2.0, k)
    z = rng.uniform(0.2, 2.0, k)
    return np.stack([y * np.log(z / y) - rng.uniform(0.05, 1.0, k), y, z], 1)


def _dual_interior(rng, k):
    """k blocks strictly inside K_exp*: u < 0, w > 0, u log(-u/w) + v - u
    > 0."""
    u = -rng.uniform(0.2, 2.0, k)
    w = rng.uniform(0.2, 2.0, k)
    v = u - u * np.log(-u / w) + rng.uniform(0.05, 1.0, k)
    return np.stack([u, v, w], 1)


SPEC = dict(nz=2, nl=3, socs=(3, 4), nexp=4)


def _interior_point(rng, dual):
    """A strictly interior point of SPEC (zero rows 0; the exp blocks in
    K_exp, or K_exp* when dual)."""
    spec = jcn.ConeSpec(**SPEC)
    v = refs.interior(jcn.ConeSpec(nz=2, nl=3, socs=(3, 4)), rng)
    e = (_dual_interior if dual else _primal_interior)(rng, spec.nexp)
    return np.concatenate([v, e.reshape(-1)])


@pytest.mark.parametrize("dual", [False, True], ids=["primal", "dual"])
def test_exp_interior_and_violation_match_jax(dual):
    """exp_interior on seeded blocks in and out of the cone (equal), and
    exp_violation (to 1e-12) on the same blocks and its branches."""
    rng = np.random.default_rng(3)
    vb = np.concatenate([
        (_dual_interior if dual else _primal_interior)(rng, 20),
        rng.standard_normal((40, 3)),
        [[-1.0, 1.0, 0.0], [-1.0, 0.0, 0.5], [0.5, 1.0, -0.2]]])
    got = tcn.exp_interior(T64(vb), dual=dual).numpy()
    want = np.asarray(jax.jit(lambda v: jcn.exp_interior(v, dual=dual))(
        jnp.asarray(vb)))
    assert got.tolist() == want.tolist()
    assert got[:20].all() and not got.all()
    _close(tcn.exp_violation(T64(vb)),
           jax.jit(jcn.exp_violation)(jnp.asarray(vb)), 1e-12)


def test_dual_barrier_gradient_and_hessian_match_jax():
    """The closed-form gradient and Hessian of the dual barrier against
    JAX's autodiff, on seeded interior blocks, to 1e-12; grad F*(e*) = -e*
    at the central point."""
    zb = _dual_interior(np.random.default_rng(4), 30)
    g, H = tcn.exp_dual_grad_hess(T64(zb))
    gj, Hj = jax.jit(jcn.exp_dual_grad_hess)(jnp.asarray(zb))
    _close(g, gj, 1e-12, "grad")
    _close(H, Hj, 1e-12, "hess")
    gc, _ = tcn.exp_dual_grad_hess(T64([tcn.EXP_DUAL_CENTRAL]))
    _close(gc[0], -np.asarray(tcn.EXP_DUAL_CENTRAL), 1e-9)


@pytest.mark.parametrize("dual", [False, True], ids=["primal", "dual"])
@pytest.mark.parametrize("seed", [0, 1])
def test_max_step_with_exp_blocks_matches_jax(seed, dual):
    """max_step on a batch of interior points of a mixed spec and seeded
    directions (the exp part: 90 bisection steps), against JAX's per point,
    to 1e-12."""
    rng = np.random.default_rng(seed)
    spec_j, spec_t = jcn.ConeSpec(**SPEC), tcn.ConeSpec(**SPEC)
    u = np.stack([_interior_point(rng, dual) for _ in range(4)])
    du = rng.standard_normal(u.shape)
    du[:, :2] = 0.0
    du[3] = 0.0                                  # stays inside: the cap
    got = tcn.max_step(spec_t, T64(u), T64(du), dual=dual)
    want = jax.jit(jax.vmap(lambda a, d: jcn.max_step(spec_j, a, d,
                                                      dual=dual)))(
        jnp.asarray(u), jnp.asarray(du))
    _close(got, want, 1e-12)
    assert float(got[3]) == 1e12 and float(got[:3].max()) < 1e12


@pytest.fixture(scope="module")
def scaled():
    """(JAX scaling, port scaling, s, z) at seeded interior points of the
    mixed spec, with mu = s'z / (degree + 1)."""
    rng = np.random.default_rng(5)
    s = _interior_point(rng, False)
    z = _interior_point(rng, True)
    spec_j, spec_t = jcn.ConeSpec(**SPEC), tcn.ConeSpec(**SPEC)
    mu = float(s @ z) / (spec_j.degree + 1)
    Wj = jax.jit(lambda a, b: jcn.nt_scaling(spec_j, a, b, mu=mu))(
        jnp.asarray(s), jnp.asarray(z))
    Wt = tcn.nt_scaling(spec_t, T64(s)[None], T64(z)[None],
                        mu=torch.tensor([mu], dtype=torch.float64))
    return Wj, Wt, s, z


@pytest.mark.parametrize("field,tol", [("exp_g", 1e-12), ("exp_H", 1e-12),
                                       ("exp_W", 1e-10), ("exp_Winv", 1e-10)])
def test_nt_scaling_exp_fields_match_jax(scaled, field, tol):
    """The BFGS scaling's fields: the barrier gradient and W^2 to 1e-12, the
    eigh-based square root and its inverse to 1e-10; W^2 z = s (the
    secant) holds."""
    Wj, Wt, s, z = scaled
    _close(getattr(Wt, field)[0], getattr(Wj, field), tol, field)
    idx = jcn.ConeSpec(**SPEC).exp_indices()
    Wz = torch.einsum("kij,kj->ki", Wt.exp_H[0], T64(z[idx]))
    _close(Wz, s[idx], 1e-12, "secant")


def test_scale_w2_lambda_match_jax(scaled):
    """scale (both ways), w2_dense and lambda_vec with exp blocks, to
    1e-10; lambda is 0 on the exp rows."""
    Wj, Wt, s, z = scaled
    spec_j, spec_t = jcn.ConeSpec(**SPEC), tcn.ConeSpec(**SPEC)
    v = np.random.default_rng(6).standard_normal(spec_j.m)
    mu = float(s @ z) / (spec_j.degree + 1)

    def jax_side(a, b, vv):
        W = jcn.nt_scaling(spec_j, a, b, mu=mu)
        return (jcn.scale(spec_j, W, vv), jcn.scale(spec_j, W, vv, True),
                jcn.w2_dense(spec_j, W), jcn.lambda_vec(spec_j, W, b))

    fwd, inv, w2, lam_j = jax.jit(jax_side)(jnp.asarray(s), jnp.asarray(z),
                                            jnp.asarray(v))
    for inverse, want in ((False, fwd), (True, inv)):
        _close(tcn.scale(spec_t, Wt, T64(v)[None], inverse=inverse)[0],
               want, 1e-10, f"scale inverse={inverse}")
    _close(tcn.w2_dense(spec_t, Wt)[0], w2, 1e-10)
    lam = tcn.lambda_vec(spec_t, Wt, T64(z)[None])[0]
    _close(lam, lam_j, 1e-10)
    assert not lam[spec_t.exp_indices()].any()


def test_violation_with_exp_blocks_matches_jax():
    """violation of seeded vectors of the mixed spec, to 1e-12."""
    rng = np.random.default_rng(7)
    spec_j, spec_t = jcn.ConeSpec(**SPEC), tcn.ConeSpec(**SPEC)
    v = rng.standard_normal((5, spec_j.m))
    v[0] = _interior_point(rng, False)
    got = tcn.violation(spec_t, T64(v))
    want = jax.jit(jax.vmap(lambda a: jcn.violation(spec_j, a)))(
        jnp.asarray(v))
    _close(got, want, 1e-12)
    assert float(got[0]) == 0.0


def _epigraph(a):
    """min t s.t. (a, 1, t) in K_exp: t* = e^a."""
    return (np.array([[0.0], [0.0], [-1.0]]), np.array([a, 1.0, 0.0]),
            np.array([1.0]), dict(nexp=1))


def _softplus(hf):
    """GuSTO's softplus lowering: min w s.t. e^{-w} <= u, e^{hf - w} <= v,
    u + v <= 1: w* = log(1 + e^{hf})."""
    A = np.zeros((7, 3))
    b = np.zeros(7)
    A[0, 1] = A[0, 2] = 1.0
    b[0] = 1.0
    A[1, 0] = 1.0
    b[2] = 1.0
    A[3, 1] = -1.0
    A[4, 0] = 1.0
    b[4] = hf
    b[5] = 1.0
    A[6, 2] = -1.0
    return A, b, np.array([1.0, 0.0, 0.0]), dict(nl=1, nexp=2)


def _mixed_soc():
    """min t + r s.t. e^x <= t, ||(x - 1, 2)|| <= r."""
    A = np.zeros((6, 3))
    b = np.zeros(6)
    A[0, 2] = -1.0
    A[1, 0] = -1.0
    b[1] = -1.0
    b[2] = 2.0
    A[3, 0] = -1.0
    b[4] = 1.0
    A[5, 1] = -1.0
    return A, b, np.array([0.0, 1.0, 1.0]), dict(socs=(3,), nexp=1)


HF = (-2.0, 0.0, 1.5, 4.0)
OK = (int(tipm.IPMStatus.OPTIMAL), int(tipm.IPMStatus.ALMOST_OPTIMAL))


def _solve_t(A, b, c, cone, kkt, tol=1e-8):
    return tipm.solve(T64(A), T64(b), T64(c), tcn.ConeSpec(**cone), tol=tol,
                      max_iter=80, kkt_method=kkt)


@pytest.mark.parametrize("kkt", ["schur", "qrchol"])
@pytest.mark.parametrize("hf", HF)
def test_ipm_softplus_program_matches_jax(hf, kkt):
    """ipm.solve on GuSTO's softplus lowering (tests/test_exp_cone.py:105:
    one nonneg row, two exp blocks) against JAX's ipm.solve on the same KKT
    (the dense Schur KKT, and _QRCholKKT): both OPTIMAL or ALMOST_OPTIMAL
    (the JAX test's own acceptance; near the stopping threshold the two
    paths' roundoff may end one iteration apart), the objective and x to
    1e-8 relative to max(1, their size) (the IPM's own gap measure), and
    w* = log(1 + e^hf) to 1e-6."""
    A, b, c, cone = _softplus(hf)
    sj = jipm.solve(jnp.asarray(A), jnp.asarray(b), jnp.asarray(c),
                    jcn.ConeSpec(**cone), tol=1e-8, max_iter=80,
                    kkt_method=kkt)
    st = _solve_t(A, b, c, cone, kkt)
    assert int(sj.status) in OK and int(st.status) in OK
    assert float(st.obj) == pytest.approx(float(sj.obj), rel=1e-8,
                                          abs=1e-8)
    scale = max(1.0, float(np.abs(np.asarray(sj.x)).max()))
    np.testing.assert_allclose(st.x.numpy(), np.asarray(sj.x), rtol=0,
                               atol=1e-8 * scale)
    assert float(st.x[0]) == pytest.approx(np.log1p(np.exp(hf)), rel=1e-6)


@pytest.mark.parametrize("kkt", ["schur", "qrchol"])
@pytest.mark.parametrize("a", [-1.0, 0.0, 0.7, 2.0])
def test_ipm_exp_epigraph(a, kkt):
    """min t s.t. (a, 1, t) in K_exp (tests/test_exp_cone.py:92) on both
    KKTs: (almost) optimal, t* = e^a to 1e-7 (the closed form in place of
    a JAX run: each JAX spec costs a 5 s compile, ROADMAP's test-time
    budget)."""
    st = _solve_t(*_epigraph(a), kkt)
    assert int(st.status) in OK
    assert float(st.x[0]) == pytest.approx(np.exp(a), rel=1e-7)


@pytest.mark.parametrize("kkt", ["schur", "qrchol"])
def test_ipm_exp_mixed_soc(kkt):
    """min e^x + ||(x - 1, 2)|| through one SOC and one exp block
    (tests/test_exp_cone.py:185) on both KKTs, against scipy's bounded
    scalar minimum: the objective to 1e-7, x to 1e-4 (the objective is flat
    at the optimum, as the JAX test allows)."""
    from scipy.optimize import minimize_scalar

    st = _solve_t(*_mixed_soc(), kkt)
    assert int(st.status) in OK
    res = minimize_scalar(lambda x: np.exp(x) + np.hypot(x - 1.0, 2.0),
                          bounds=(-5.0, 5.0), method="bounded",
                          options={"xatol": 1e-12})
    assert float(st.x[1] + st.x[2]) == pytest.approx(res.fun, rel=1e-7)
    assert float(st.x[0]) == pytest.approx(res.x, abs=1e-4)


def _entropy(n=4, seed=7, mtar=0.1):
    """Entropy over the simplex with a moment row (tests/test_exp_cone.py:
    123): two zero rows, n nonneg rows, n exp blocks (t_i, p_i, 1)."""
    a_vec = np.random.default_rng(seed).standard_normal(n)
    A = np.zeros((2 + 4 * n, 2 * n))
    b = np.zeros(2 + 4 * n)
    A[0, :n] = 1.0
    b[0] = 1.0
    A[1, :n] = a_vec
    b[1] = mtar
    A[2:2 + n, :n] = -np.eye(n)
    for i in range(n):
        A[2 + n + 3 * i, n + i] = -1.0
        A[2 + n + 3 * i + 1, i] = -1.0
        b[2 + n + 3 * i + 2] = 1.0
    c = np.concatenate([np.zeros(n), -np.ones(n)])
    return A, b, c, dict(nz=2, nl=n, nexp=n)


def test_qrchol_matches_schur_with_equality_rows():
    """On a program with equality rows (the entropy program), _QRCholKKT's
    null-space solve (the QR of A_E' once, the reduced factor and both
    solves with R on the ladder's plain versions) gives the dense Schur
    KKT's solution: both (almost) optimal, the objective to 1e-8 and the
    probabilities to 1e-5 (the objective is flat at the optimum)."""
    prog = _entropy()
    s1 = _solve_t(*prog, "schur")
    s2 = _solve_t(*prog, "qrchol")
    assert int(s1.status) in OK and int(s2.status) in OK
    assert float(s2.obj) == pytest.approx(float(s1.obj), abs=1e-8)
    np.testing.assert_allclose(s2.x[:4].numpy(), s1.x[:4].numpy(), atol=1e-5)
    np.testing.assert_allclose(s1.x[:4].sum().item(), 1.0, atol=1e-8)


def test_conic_program_exp_cone():
    """ConicProgram with exp_cone constraints (tests/test_exp_cone.py:216):
    min c'x + sum x_i log x_i over the simplex has the optimum softmax(-c)
    and the value -log(sum e^{-c_i}) (closed forms, as the JAX test holds
    its package to): x to 2e-4 as there, the value to 1e-6; each exp
    dual has three entries."""
    n = 4
    c_vec = np.asarray([0.3, -0.2, 0.8, 0.0])
    prg = TProgram(device="cpu")
    x = prg.variable("x", n)
    t = prg.variable("t", n)
    prg.add_constraint("simplex", lambda xv: [tprob.zero(xv.sum() - 1.0)],
                       (x,))
    prg.add_constraint("entropy", lambda xv, tv: [
        tprob.exp_cone(torch.stack([-tv[i], xv[i], torch.ones_like(xv[i])]))
        for i in range(n)], (x, t))
    prg.add_cost(lambda xv, tv: T64(c_vec) @ xv + tv.sum(), (x, t))
    prg.build()
    sol = prg.solve(tol=1e-9, max_iter=80)
    assert int(sol.status) in OK
    x_star = np.exp(-c_vec) / np.exp(-c_vec).sum()
    np.testing.assert_allclose(sol.values["x"].numpy(), x_star, atol=2e-4)
    assert float(sol.obj) == pytest.approx(-np.log(np.exp(-c_vec).sum()),
                                           abs=1e-6)
    assert prg.spec.nexp == n and sol.duals["entropy0"].shape == (3,)


S0 = np.array([[2.0, 0.5], [0.5, 1.0]])


def _gusto_cost(prob, xp, flags):
    """tests/test_gusto_cost.py:26-29's structured cost, with S, ell and g
    flagged convex or not by `flags`."""
    S0x = xp.asarray(S0) if xp is jnp else T64(S0)
    spec = prob.GuSTORunningCost(
        S=lambda t, k, p: S0x * (1.0 + p[0]),
        ell=lambda t, k, x, p: xp.stack([x[0] ** 2, x[1]]),
        g=lambda t, k, x, p: x[0] ** 2 + 3.0 * x[1],
        S_cvx=flags[0], ell_cvx=flags[1], g_cvx=flags[2])
    run = prob.make_gusto_running_cost(spec, 2, 2)
    return lambda d: run(0.3, 2, d[:2], d[2:4], d[4:])


@pytest.mark.parametrize("flags", [(True, True, True), (False, False, False),
                                   (False, False, True)],
                         ids=["convex", "nonconvex", "g_convex"])
def test_gusto_running_cost_matches_jax(flags):
    """make_gusto_running_cost: value, gradient and Hessian at seeded points
    against JAX's to 1e-12, every *_cvx flag both ways; a term flagged
    nonconvex keeps its value and gradient and loses its curvature (detach
    stops the tangent, as JAX's stop_gradient)."""
    fj = _gusto_cost(jprob, jnp, flags)
    ft = _gusto_cost(tprob, torch, flags)
    jax_side = jax.jit(lambda d: (fj(d), jax.grad(fj)(d),
                                  jax.hessian(fj)(d)))
    rng = np.random.default_rng(8)
    for _ in range(2):
        d = rng.standard_normal(5)
        vj, gj, Hj = jax_side(jnp.asarray(d))
        dt = T64(d)
        assert float(ft(dt)) == pytest.approx(float(vj), rel=1e-12)
        _close(grad(ft)(dt), gj, 1e-12, "grad")
        _close(hessian(ft)(dt), Hj, 1e-12, "hess")
    if not any(flags):
        assert not hessian(ft)(dt).any()
