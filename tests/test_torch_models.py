"""The port's oscillator, LCvx double integrator and LCvx rocket landing
(scptoolbox_torch/models/) against the JAX package's models on the CPU
(float64), and against the pinned costs of tests/reference_costs.json.

The JAX references are cut to small grids (each JAX model compiles its own
PTR step or conic program, seconds each on the CPU); the port alone is held
to the pins at the pins' own sizes, except the rocket's golden search."""

import json
import math
import os
from importlib import import_module

import numpy as np
import pytest
import torch

from scptoolbox_torch.config import SCPStatus
from scptoolbox_torch.ops.ipm import IPMStatus

torch.set_num_threads(1)

jo = import_module("scptoolbox_tpu.models.oscillator")
to = import_module("scptoolbox_torch.models.oscillator")
jl = import_module("scptoolbox_tpu.models.double_integrator_lcvx")
tl = import_module("scptoolbox_torch.models.double_integrator_lcvx")
jr = import_module("scptoolbox_tpu.models.rocket_landing")
tr = import_module("scptoolbox_torch.models.rocket_landing")

with open(os.path.join(os.path.dirname(__file__),
                       "reference_costs.json")) as f:
    PINS = json.load(f)
OK = (int(IPMStatus.OPTIMAL), int(IPMStatus.ALMOST_OPTIMAL))


def test_oscillator_matches_jax():
    """Two homotopy rungs at N=8: same status and iterations, every
    history cost within a relative 1e-8, the same deadband trajectory."""
    sj = jo.solve_oscillator(N=8, n_hom=2)
    st = to.solve_oscillator(N=8, n_hom=2, device="cpu")
    assert st.status == sj.status == SCPStatus.SOLVED
    assert st.iterations == sj.iterations
    for hj, ht in zip(sj.history, st.history):
        assert ht.J_aug == pytest.approx(hj.J_aug, rel=1e-8)
    np.testing.assert_allclose(st.ud, sj.ud, rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(st.xd, sj.xd, rtol=1e-7, atol=1e-9)
    assert st.cost == pytest.approx(sj.cost, rel=1e-8)


@pytest.mark.parametrize("choice", [1, 2])
def test_lcvx_double_integrator_matches_jax_and_pin(choice):
    """At N=10 against JAX (the two IPMs may end one at OPTIMAL and one at
    ALMOST_OPTIMAL: the last iterations of this problem amplify roundoff);
    at the pin's N=50 against the pin, lossless (|u| = sigma)."""
    sj = jl.solve_lcvx(jl.LCvxDoubleIntegratorParameters(choice=choice,
                                                         N=10))
    st = tl.solve_lcvx(tl.LCvxDoubleIntegratorParameters(choice=choice,
                                                         N=10), device="cpu")
    assert st.status in OK and sj.status in OK
    assert st.cost == pytest.approx(sj.cost, rel=1e-8)
    np.testing.assert_allclose(st.x, sj.x, rtol=1e-6, atol=1e-6)
    mdl = tl.LCvxDoubleIntegratorParameters(choice=choice)
    sol = tl.solve_lcvx(mdl, device="cpu")
    assert sol.status in OK
    pin = PINS[f"lcvx_double_integrator_{choice}"]["cost"]
    assert sol.cost == pytest.approx(pin, rel=1e-4)
    assert np.max(np.abs(np.abs(sol.u) - sol.sigma)) < 1e-4
    assert np.allclose(sol.x[-1], [mdl.s, 0.0], atol=1e-5)


def test_lcvx_pontryagin_helpers_match_jax():
    for p in (-5.0, -3.0, -1.0, 0.5, 3.0, 5.0):
        assert tl.mp_input(p) == jl.mp_input(p)
    a = tl._mp_sim(10.0, 0.1, 47.0, -2.0, 5.0, n_sub=20)
    b = jl._mp_sim(10.0, 0.1, 47.0, -2.0, 5.0, n_sub=20)
    assert a[0] == b[0]
    np.testing.assert_array_equal(a[2], b[2])


def test_rocket_landing_probe_matches_jax():
    """One fixed-flight-time probe at N=10, a feasible tf: same status,
    cost within a relative 1e-8, the same trajectory; the replay lands."""
    tf = 75.0
    rj, rt = jr.Rocket(), tr.Rocket()
    assert rt.tf_bounds == rj.tf_bounds
    np.testing.assert_allclose(rt.continuous_dynamics()[0],
                               rj.continuous_dynamics()[0], rtol=0, atol=0)
    sj = jr.solve_pdg(jr.build_program(rj, 10), rj, tf, 10)
    st = tr.solve_pdg(tr.build_program(rt, 10, device="cpu"), rt, tf, 10)
    assert st.status == sj.status == int(IPMStatus.OPTIMAL)
    assert math.isfinite(st.cost)
    assert st.cost == pytest.approx(sj.cost, rel=1e-8)
    np.testing.assert_allclose(st.r, sj.r, rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(st.m, sj.m, rtol=1e-8)
    ts, X = tr.simulate(rt, st, dt=0.5)
    tsj, Xj = jr.simulate(rj, sj, dt=0.5)
    np.testing.assert_allclose(X, Xj, rtol=1e-6, atol=1e-3)
