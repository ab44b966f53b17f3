"""GuSTO and its soft state set in the port against the JAX package on the
CPU (float64): the template with indicator variables on the oscillator at
N=6, one GuSTO step on the quadrotor at N=8, the serial history, the
batched solve against the serial one; and, on the port alone, the softplus
step's exp-cone epigraphs, the QR-Cholesky step against the dense Schur
one, the structured running cost inside a step, and the KKT path of the
softplus template at its full size.

One JAX solver (torch_refs.quadrotor_gusto_pair(), the quad penalty, N=8):
its jitted step serves the step test and its serial solve, so JAX compiles
one step and one reference cost. A second JAX GuSTO (softplus) and the
free-flyer's JAX template would cost ~20 s and ~17 s of compiles on the
CPU (ROADMAP's test-time budget); chip_smoke.py holds both paths to the
JAX package on the card (the softplus cost, the free-flyer step)."""

import dataclasses
import functools
from importlib import import_module

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scptoolbox_torch.config import SCPStatus
from scptoolbox_torch.ops.discretize import DLTV as TDLTV
from scptoolbox_torch.parser.problem import GuSTORunningCost
from scptoolbox_torch.solvers import gusto as tgusto
from scptoolbox_torch.solvers.subproblem import Assembler as TAssembler
from scptoolbox_torch.solvers.template import SCPTemplate as TTemplate
from scptoolbox_tpu.ops.discretize import DLTV as JDLTV
from scptoolbox_tpu.parser.problem import bind_consts as jbind
from scptoolbox_tpu.solvers.subproblem import Assembler as JAssembler
from scptoolbox_tpu.solvers.template import SCPTemplate as JTemplate
from tests import torch_refs as refs

# both models packages re-export functions under the module names
josc = import_module("scptoolbox_tpu.models.oscillator")
tdi = import_module("scptoolbox_torch.models.double_integrator")
tosc = import_module("scptoolbox_torch.models.oscillator")
torch.set_num_threads(1)
T64 = lambda a: torch.tensor(np.asarray(a), dtype=torch.float64)


def _close(b, a, rtol, what="", floor=0.0):
    """b within rtol of a, relative to max(a's largest entry, floor)."""
    a = np.asarray(a, dtype=float)
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_allclose(
        b, a, rtol=rtol, atol=rtol * max(np.abs(a).max(initial=0.0), floor),
        err_msg=what)


@pytest.fixture(scope="module")
def soft_templates():
    """(JAX template, port template, JAX (A, b, c, const, X indicators)) of
    the oscillator at N=6 with soft_X (its X an L1 block, the indicator
    shifting its head) and without vs >= 0 (the softplus penalty's
    template), assembled from a seeded reference and DLTV (no solver, so no
    LP auto-scaling)."""
    jpbm, tpbm, vs_nonneg = josc.oscillator(6), tosc.oscillator(6), False
    N = 6
    t = np.linspace(0.0, 1.0, N)
    kw = dict(relax_dynamics=False, relax_bcs=False, soft_X=True,
              vs_nonneg=vs_nonneg)
    J = JTemplate(jpbm, N, t, dtype=jnp.float64, **kw)
    T = TTemplate(tpbm, N, t, dtype=torch.float64, device="cpu", **kw)
    J.freeze()
    T.freeze()
    rng = np.random.default_rng(11)
    xg, ug, pg = (np.asarray(a)
                  for a in jbind(jpbm.guess, jpbm.consts)(N))
    x = xg + 0.1 * rng.standard_normal(xg.shape)
    u = ug + 0.1 * rng.standard_normal(ug.shape)
    p = pg * (1.0 + 0.05 * rng.standard_normal(pg.shape))
    nx, nu, npp = jpbm.nx, jpbm.nu, jpbm.np
    d = {k: rng.standard_normal((N - 1,) + sh) for k, sh in (
        ("A", (nx, nx)), ("Bm", (nx, nu)), ("Bp", (nx, nu)),
        ("F", (nx, npp)), ("r", (nx,)), ("E", (nx, nx)),
        ("defects", (nx,)), ("xprop", (nx,)))}

    @jax.jit
    def jax_side(x, u, p, dl):
        asm = JAssembler(J.m, J.n, jnp.float64)
        J.assemble_core(asm, x, u, p, dl)
        return asm.A, asm.b, asm.c, asm.const, J.X_indicators(x, p)

    want = jax_side(jnp.asarray(x), jnp.asarray(u), jnp.asarray(p),
                    JDLTV(**{k: jnp.asarray(v) for k, v in d.items()}))
    inputs = (T64(x)[None], T64(u)[None], T64(p)[None],
              TDLTV(**{k: T64(v)[None] for k, v in d.items()}))
    return J, T, want, inputs


def test_soft_state_set_layout_matches_jax(soft_templates):
    """The cone spec, the variable count and the indicator slots a node
    equal JAX's."""
    J, T, _, _ = soft_templates
    assert T.soft_X and J.soft_X and T.n_qX == J.n_qX > 0
    assert (T.spec.nz, T.spec.nl, T.spec.socs, T.spec.nexp) == (
        J.spec.nz, J.spec.nl, J.spec.socs, J.spec.nexp)
    assert T.n == J.n and T.m == J.m
    assert T.vs_nonneg == J.vs_nonneg


def test_soft_state_set_assembly_matches_jax(soft_templates):
    """assemble_core with the indicator columns (A, b, c, const before the
    decision scaling) and X_indicators at the seeded reference, to 1e-12
    (const relative to max(|const|, 1): the oscillator's is roundoff,
    ~1e-17)."""
    J, T, want, (x, u, p, dl) = soft_templates
    asm = TAssembler(T.m, T.n, 1, torch.float64, "cpu")
    T.assemble_core(asm, x, u, p, dl)
    for name, got, w in zip(("A", "b", "c", "const"),
                            (asm.A[0], asm.b[0], asm.c[0], asm.const[0]),
                            want):
        _close(got, w, 1e-12, name, floor=1.0 if name == "const" else 0.0)
    _close(T.X_indicators(x, p)[0], want[4], 1e-12, "X_indicators")


def test_softplus_template_takes_dense_schur():
    """The softplus quadrotor at N=30 (n = 752 >= 600 in float64, 180 exp
    blocks): resolve_kkt gives the dense Schur KKT, as the JAX package's
    does (solvers/structure.py:102-103 returns no block sweep for exp
    cones)."""
    T = tgusto.GuSTO(refs.tquad.quadrotor(), tgusto.GuSTOParameters(
        N=30, Nsub=15, **refs.GUSTO_SOFTPLUS), device="cpu")
    assert (T.tmpl.n, T.spec.nexp) == (752, 180)
    assert T._kkt_method is None and T.kkt_builder is None


def test_one_step_matches_jax():
    """One step from the guess at eta_init and lam_init: the IPM status and
    iterations equal, the solution, L, L_aug, J_aug, rho, tr_lhs_max, viol,
    the deviation and the defect norm to 1e-7 relative (the defect norm is
    roundoff, ~1e-15, for the quadrotor's exact discretization: it is held
    to 1e-7 of the feasibility tolerance). The JAX step is the jitted one
    its solve runs."""
    J, T = refs.quadrotor_gusto_pair()
    pars = T.pars
    lam, eta = pars.lam_init, pars.eta_init
    _, dl = J._ref_J_aug(*J._guess, jnp.asarray(lam, J.dtype), J.consts)
    oj = J._step(*J._guess, dl, jnp.asarray(eta, J.dtype),
                 jnp.asarray(lam, J.dtype), J.consts)
    ref = tuple(a[None] for a in T._guess)
    one = lambda v: torch.tensor([v], dtype=torch.float64)
    _, dl = T._ref_J_aug_impl(*ref, one(lam), T.consts)
    out = T._step_impl(*ref, dl, one(eta), one(lam), T.consts)
    assert int(out["ipm_status"][0]) == int(oj["ipm_status"])
    assert int(out["ipm_iters"][0]) == int(oj["ipm_iters"])
    for k in ("x", "u", "p", "L", "L_aug", "J_aug", "rho", "tr_lhs_max",
              "viol", "deviation"):
        _close(out[k][0], oj[k], 1e-7, k)
    _close(out["defect_norm"][0], oj["defect_norm"], 1e-7, "defect_norm",
           floor=pars.feas_tol)


@pytest.fixture(scope="module")
def serial():
    J, T = refs.quadrotor_gusto_pair()
    return J.solve(), T.solve()


@pytest.mark.parametrize("key", ["rho", "eta", "lam", "reject", "J_aug"])
def test_serial_history_matches_jax(serial, key):
    """Each iteration's rho, eta, lambda, reject flag and J_aug equal JAX's
    history, to 1e-6 relative (rho to 1e-6 absolute once it is below 1:
    near convergence it is |J_aug - L_aug| / |L_aug| of two costs equal to
    ~1e-6, so the packages' 1e-8 agreement on each cost leaves its relative
    value free to ~1e-2, while the update bands sit at 0.1 and 0.9); the
    same iterations, status and cost."""
    sj, st = serial
    assert st.iterations == sj.iterations == len(st.history)
    assert int(st.status) == int(sj.status)
    assert st.cost == pytest.approx(sj.cost, rel=1e-6)
    for hj, ht in zip(sj.history, st.history):
        a = hj.J_aug if key == "J_aug" else hj.extras[key]
        b = ht.J_aug if key == "J_aug" else ht.extras[key]
        if key == "reject":
            assert a == b, hj.iteration
        else:
            assert b == pytest.approx(a, rel=1e-6,
                                      abs=1e-6 if key == "rho" else 0.0), (
                hj.iteration, key)


def test_batched_matches_serial(serial):
    """solve_batched at B=2 from identical guesses repeats the port's serial
    solve from the same guess: the same iterations, eta and lambda traces,
    x to 1e-6."""
    _, T = refs.quadrotor_gusto_pair()
    _, st = serial
    B = 2
    bx, bu, bp = (a[None].expand(B, *a.shape).clone() for a in T._guess)
    out = T.solve_batched(bx, bu, bp, T.pars.iter_max)
    assert out["iters"].tolist() == [st.iterations] * B
    assert out["status"].tolist() == [int(st.status)] * B
    for key in ("eta", "lam"):
        trace = torch.stack([t[key] for t in out["traces"]])
        for b in range(B):
            assert trace[:, b].tolist() == pytest.approx(
                [h.extras[key] for h in st.history], rel=1e-12), key
    for b in range(B):
        _close(out["x"][b], st.xd, 1e-6, "x")
    assert [bool(t["accept"][0]) for t in out["traces"]] == [
        not h.extras["reject"] for h in st.history]


@functools.cache
def _port_step(**over):
    """(solver, step output, the step's physical decision vector) of the
    port's quadrotor GuSTO at torch_refs.GUSTO_PARS with `over`, one step
    from the guess at eta_init and lam_init."""
    G = tgusto.GuSTO(refs.tquad.quadrotor(), tgusto.GuSTOParameters(
        **dict(refs.GUSTO_PARS, **over)), device="cpu")
    ref = tuple(a[None] for a in G._guess)
    eta, lam = (torch.tensor([v], dtype=torch.float64)
                for v in (G.pars.eta_init, G.pars.lam_init))
    _, dl = G._ref_J_aug_impl(*ref, lam, G.consts)
    A, b, c, const = G._assemble(*ref, dl, eta, lam, G.consts)
    sol = G._solve_sub(A, b, c)
    out = G._post_solve(sol, const, *ref, eta, lam, G.consts)
    return G, out, (G._S_full * sol.x + G._c_full)[0]


def test_softplus_step_epigraphs_are_tight():
    """The softplus step (48 exp blocks): IPM (almost) optimal, and at its
    solution every penalized scalar f (the trust-region slacks v_tr, the
    keep-out slacks vs) has its epigraph variable on the softplus curve,
    sp_w = log(1 + e^{hom f}), to 1e-5 relative to max(1, sp_w): the
    exp rows e^{-w} <= u, e^{hom f - w} <= v and u + v <= 1 are posted with
    their signs and hom, and the weighted cost lam w / hom pushes w down
    onto the curve."""
    G, out, d = _port_step(**refs.GUSTO_SOFTPLUS)
    assert G.spec.nexp == 2 * G._n_pen
    assert int(out["ipm_status"][0]) in (0, 4)
    lay, hom = G.tmpl.layout, G.pars.hom
    f = torch.cat([d[lay.sl("v_tr")], d[lay.sl("vs")]])
    curve = torch.logaddexp(torch.zeros_like(f), hom * f)
    _close(d[lay.sl("sp_w")], curve, 1e-5, "sp_w", floor=1.0)


def test_qrchol_step_matches_schur():
    """The quadrotor step on kkt_method="qrchol" (186 equality rows in the
    null-space QR, the reduced 297-wide factor at N=8 on the ladder's plain
    versions) lands on the dense Schur KKT's: both (almost) optimal, the
    solution, L_aug and J_aug to 1e-6 relative."""
    _, a, _ = _port_step()
    G, b, _ = _port_step(kkt_method="qrchol")
    assert G._kkt_method == "qrchol"
    assert int(a["ipm_status"][0]) in (0, 4)
    assert int(b["ipm_status"][0]) in (0, 4)
    for k in ("x", "u", "p", "L_aug", "J_aug"):
        _close(b[k], a[k], 1e-6, k)


def test_structured_cost_step_equals_plain():
    """The port's twin of tests/test_gusto_cost.py:82-99, one step instead
    of a solve: the double integrator with its running cost T u'u given as
    GuSTORunningCost(S=T I) takes the same step as with the plain running
    cost, to 1e-10."""
    mdl = tdi.DoubleIntegratorParameters()
    plain = tdi.double_integrator(mdl)
    structured = dataclasses.replace(
        plain, running_cost=None, gusto_cost=GuSTORunningCost(
            S=lambda t, k, p: mdl.T * torch.eye(1, dtype=p.dtype,
                                                device=p.device)))
    pars = tgusto.GuSTOParameters(N=8, Nsub=5, eta_init=5.0,
                                  project_guess=False)
    outs = []
    for pbm in (plain, structured):
        G = tgusto.GuSTO(pbm, pars, device="cpu")
        ref = tuple(a[None] for a in G._guess)
        lam = torch.tensor([pars.lam_init], dtype=torch.float64)
        _, dl = G._ref_J_aug_impl(*ref, lam, G.consts)
        outs.append(G._step_impl(*ref, dl, torch.tensor(
            [pars.eta_init], dtype=torch.float64), lam, G.consts))
    assert int(outs[0]["ipm_status"][0]) == 0
    for k in ("x", "u", "L", "L_aug", "J_aug", "rho"):
        _close(outs[1][k], outs[0][k], 1e-10, k)


def test_entry_points_need_a_card_unless_told():
    """Without device= the solver asks for the card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgusto.GuSTO(refs.tquad.quadrotor(), tgusto.GuSTOParameters(N=8))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgusto.solve(refs.tquad.quadrotor(), tgusto.GuSTOParameters(N=8))
