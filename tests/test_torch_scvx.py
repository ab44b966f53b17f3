"""SCvx and the guess projection of the port against the JAX package on the
CPU (float64), on the quadrotor at N=8, Nsub=5 (tests/test_quadrotor.py's
configuration cut to size; torch_refs.QUAD_PARS).

Two JAX solvers, on the dense Schur KKT and on the block sweep: the dense
one's jitted step serves its single-step test and its serial solve, so JAX
compiles two structure probes, two steps, the reference cost and one
projection program. (Across the two KKT paths a step's IPM solution
agrees only to a few 1e-7, so each path is held to its JAX twin.) The
batched solve is held to the port's own serial solve."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scptoolbox_torch.config import SCPStatus
from scptoolbox_torch.solvers import projection as tproj
from scptoolbox_torch.solvers import scvx as tscvx
from scptoolbox_tpu.solvers import projection as jproj
from tests import torch_refs as refs

torch.set_num_threads(1)


def _close(b, a, rtol, what=""):
    """b within rtol of a, relative to a's largest entry."""
    a = np.asarray(a, dtype=float)
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_allclose(b, a, rtol=rtol,
                               atol=rtol * np.abs(a).max(initial=0.0),
                               err_msg=what)


@pytest.fixture(scope="module")
def pair():
    return refs.quadrotor_scvx_pair()


@pytest.fixture(scope="module")
def projected(pair):
    """The quadrotor guess at N=8 projected by both packages."""
    J, T = pair
    xj = jproj.project_convex(J.pbm, J.scaling, *J._guess, t_grid=J.t_np)
    xt = tproj.project_convex(T.pbm, T.scaling, *T._guess, t_grid=T.t_np,
                              device="cpu")
    return xj, xt


@pytest.mark.parametrize("i", [0, 1, 2], ids=["x", "u", "p"])
def test_project_convex_matches_jax(projected, i):
    """project_convex on the guess, to 1e-6 relative."""
    xj, xt = projected
    _close(xt[i], xj[i], 1e-6)


def test_project_convex_lands_in_the_input_set(pair):
    """A guess far outside U (sigma below u_min, tilted past the cone,
    duration past its box) is moved into it."""
    _, T = pair
    mdl = refs.tquad.QuadrotorParameters()
    x, u, p = (a.clone() for a in T._guess)
    u[:, :3] = torch.tensor([3.0, -2.0, 0.1], dtype=torch.float64)
    u[:, 3] = 0.1
    p[0] = 4.0
    x2, u2, p2 = tproj.project_convex(T.pbm, T.scaling, x, u, p,
                                      t_grid=T.t_np, device="cpu")
    sig, a = u2[:, 3], u2[:, :3]
    tol = 1e-6
    assert torch.all(sig >= mdl.u_min - tol) and torch.all(
        sig <= mdl.u_max + tol)
    assert torch.all(sig >= torch.linalg.vector_norm(a, dim=1) - tol)
    cos_tilt = math.cos(math.radians(mdl.tilt_max_deg))
    assert torch.all(sig * cos_tilt - a[:, 2] <= tol)
    assert mdl.tf_min - tol <= float(p2[0]) <= mdl.tf_max + tol
    _close(x2, x, 1e-6)     # X is free: the states stay where they were


def test_project_convex_failure_raises(pair):
    """An empty input set ends the projection IPM short of OPTIMAL, which
    raises SCPError(GUESS_PROJECTION_FAILED)."""
    _, T = pair
    pbm = refs.tquad.quadrotor(refs.tquad.QuadrotorParameters(
        u_min=30.0, u_max=1.0))
    with pytest.raises(tscvx.SCPError) as e:
        tproj.project_convex(pbm, T.scaling, *T._guess, t_grid=T.t_np,
                             device="cpu")
    assert e.value.status == SCPStatus.GUESS_PROJECTION_FAILED


@pytest.mark.parametrize("kkt", ["schur", "block"])
def test_one_step_matches_jax(pair, kkt):
    """One step from the guess at eta = 0.8 on the dense Schur KKT and on
    the block sweep (forced in both packages): the IPM solution, L, J_aug,
    the deviation and the defect norm to 1e-7 relative. The JAX step is
    the jitted one its solve runs."""
    J, T = pair if kkt == "schur" else refs.quadrotor_scvx_pair(True)
    assert (T.kkt_builder is not None) == (kkt == "block")
    assert (J._kkt_builder is not None) == (kkt == "block")
    _, dl = J._ref_J_aug(*J._guess, J.consts)
    oj = J._step(*J._guess, dl, jnp.asarray(0.8, J.dtype), J.consts)
    ref = tuple(a[None] for a in T._guess)
    _, dl = T._ref_J_aug_impl(*ref, T.consts)
    out = T._step_impl(*ref, dl, torch.tensor([0.8], dtype=torch.float64),
                       T.consts)
    assert int(out["ipm_status"][0]) == int(oj["ipm_status"])
    assert int(out["ipm_iters"][0]) == int(oj["ipm_iters"])
    for k in ("x", "u", "p", "L", "L_aug", "J_aug", "deviation",
              "defect_norm"):
        _close(out[k][0], oj[k], 1e-7, k)


@pytest.fixture(scope="module")
def serial(pair):
    J, T = pair
    return J.solve(), T.solve()


@pytest.mark.parametrize("key", ["rho", "eta", "reject", "J_aug"])
def test_serial_history_matches_jax(serial, key):
    """Each iteration's rho, eta, reject flag and J_aug equal JAX's, to
    1e-6 relative; the same iterations, status and cost."""
    sj, st = serial
    assert st.iterations == sj.iterations == len(st.history)
    assert st.status == SCPStatus.SOLVED and int(sj.status) == int(st.status)
    assert st.cost == pytest.approx(sj.cost, rel=1e-6)
    for hj, ht in zip(sj.history, st.history):
        a = hj.J_aug if key == "J_aug" else hj.extras[key]
        b = ht.J_aug if key == "J_aug" else ht.extras[key]
        if key == "reject":
            assert a == b
        else:
            assert b == pytest.approx(a, rel=1e-6), (hj.iteration, key)
    assert any(h.extras["reject"] for h in st.history)


def test_warm_start_from_a_jax_solution(pair, serial):
    """solve(warm=) takes the JAX package's SCPSolution (numpy arrays): the
    port goes on from the JAX result, feasible from its first iteration,
    and ends below the JAX cost."""
    _, T = pair
    sj, st = serial
    sol = T.solve(warm=sj)
    assert sol.status == SCPStatus.SOLVED and sol.feas
    assert sol.history[0].feas and not st.history[0].feas
    assert sol.cost < sj.cost
    assert sol.x_cont.shape == ((T.pars.N - 1) * 2 * T.pars.Nsub + 1,
                                T.pbm.nx)


def test_batched_matches_serial(pair, serial):
    """solve_batched at B=2 from identical guesses repeats the serial solve
    from the same guess: the same iterations and eta trace, x to 1e-6."""
    _, T = pair
    _, st = serial
    B = 2
    bx, bu, bp = (a[None].expand(B, *a.shape).clone() for a in T._guess)
    out = T.solve_batched(bx, bu, bp, T.pars.iter_max)
    assert out["status"].tolist() == [int(SCPStatus.SOLVED)] * B
    assert out["feas"].tolist() == [st.feas] * B
    assert out["iters"].tolist() == [st.iterations] * B
    etas = torch.stack([t["eta"] for t in out["traces"]])
    for b in range(B):
        assert etas[:, b].tolist() == pytest.approx(
            [h.extras["eta"] for h in st.history], rel=1e-12)
        _close(out["x"][b], st.xd, 1e-6, "x")
    accepted = [h for h in st.history if not h.extras["reject"]]
    assert float(out["J_aug"][0]) == pytest.approx(accepted[-1].J_aug,
                                                   rel=1e-6)
    assert float(out["defect_norm"][0]) == pytest.approx(
        accepted[-1].defect_norm, rel=1e-6)
    assert [bool(t["accept"][0]) for t in out["traces"]] == [
        not h.extras["reject"] for h in st.history]


def test_entry_points_need_a_card_unless_told(pair):
    """Without device= the solver and the projection ask for the card."""
    _, T = pair
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tscvx.SCvx(T.pbm, T.pars)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tproj.project_convex(T.pbm, T.scaling, *T._guess, t_grid=T.t_np)
