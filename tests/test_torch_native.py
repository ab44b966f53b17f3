"""The port's host C++ IPM backend (scptoolbox_torch/native.py) and
`ConicProgram.solve(backend=...)`, on the CPU.

The random LP / SOCP / mixed problems and the infeasibility certificates of
tests/test_native.py go through the port's wrapper and the port's device
IPM (ops/ipm.py) and are held to each other as that file holds the JAX
package's pair; the wrapper also returns exactly what the JAX package's
wrapper returns (the same C++ on the same data). One parser program is
solved with backend="native" in both packages."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scptoolbox_torch import interop
from scptoolbox_torch import native as tnative
from scptoolbox_torch.ops import ipm as tipm
from scptoolbox_torch.ops.cones import ConeSpec
from scptoolbox_torch.parser.problem import exp_cone, nonpos, soc
from scptoolbox_torch.parser.program import ConicProgram
from scptoolbox_tpu import native as jnative
from tests.test_native import _random_cone_problem

torch.set_num_threads(1)


def _spec(jspec):
    return interop.cone_spec(jspec.nz, jspec.nl, jspec.socs)


def _ipm(A, b, c, spec, **kw):
    return tipm.solve(*(torch.as_tensor(a) for a in (A, b, c)), spec, **kw)


@pytest.mark.parametrize("seed,n,nz,nl,socs", [
    (0, 6, 0, 10, ()),          # pure LP
    (1, 8, 3, 6, (4,)),         # mixed with equalities + SOC
    (2, 10, 2, 5, (3, 5)),      # two SOC blocks
    (3, 5, 0, 0, (4, 3)),       # cone-only
])
def test_native_matches_device_ipm_and_jax_wrapper(seed, n, nz, nl, socs):
    A, b, c, jspec = _random_cone_problem(np.random.default_rng(seed), n,
                                          nz, nl, socs)
    spec = _spec(jspec)
    sol_t = _ipm(A, b, c, spec, tol=1e-9, max_iter=60)
    sol_n = tnative.solve(A, b, c, spec, tol=1e-9, max_iter=60)
    assert int(sol_t.status) == int(tipm.IPMStatus.OPTIMAL)
    assert sol_n.status == tipm.IPMStatus.OPTIMAL
    assert sol_n.obj == pytest.approx(float(sol_t.obj), abs=1e-6)
    np.testing.assert_allclose(sol_n.x, sol_t.x.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(sol_n.z, sol_t.z.numpy(), rtol=1e-4,
                               atol=1e-5)
    sol_j = jnative.solve(A, b, c, jspec, tol=1e-9, max_iter=60)
    for k in ("x", "s", "z"):
        np.testing.assert_array_equal(getattr(sol_n, k), getattr(sol_j, k))
    assert (int(sol_n.status), sol_n.iters, sol_n.obj) == (
        int(sol_j.status), sol_j.iters, sol_j.obj)
    # tensors are taken as well as arrays
    sol_tt = tnative.solve(*(torch.as_tensor(a) for a in (A, b, c)), spec,
                           tol=1e-9, max_iter=60)
    np.testing.assert_array_equal(sol_tt.x, sol_n.x)


@pytest.mark.parametrize("A,b,c,nl,status", [
    # x <= -1 and x >= 1: primal infeasible
    ([[1.0], [-1.0]], [-1.0, -1.0], [0.0], 2,
     tipm.IPMStatus.PRIMAL_INFEASIBLE),
    # min -x s.t. x >= 0: unbounded below
    ([[-1.0]], [0.0], [-1.0], 1, tipm.IPMStatus.DUAL_INFEASIBLE),
])
def test_native_infeasibility_certificates(A, b, c, nl, status):
    A, b, c = (np.asarray(a) for a in (A, b, c))
    spec = ConeSpec(nz=0, nl=nl, socs=())
    assert tnative.solve(A, b, c, spec).status == status
    assert int(_ipm(A, b, c, spec).status) == int(status)


def _ball_program(pkg):
    """tests/test_native.py's SOCP (x in the unit ball, x0 >= 0.5, a
    linear cost), in either package."""
    if pkg == "jax":
        from scptoolbox_tpu.parser.problem import nonpos as jnonpos
        from scptoolbox_tpu.parser.problem import soc as jsoc
        from scptoolbox_tpu.parser.program import ConicProgram as JProgram

        prg = JProgram()
        x = prg.variable("x", 3)
        prg.add_constraint("ball", lambda xv: [jsoc(jnp.concatenate(
            [jnp.ones(1), xv]))], (x,))
        prg.add_constraint("half", lambda xv: [jnonpos(0.5 - xv[0:1])],
                           (x,))
        prg.add_cost(lambda xv: xv[0] + 0.3 * xv[1] - 0.2 * xv[2], (x,))
        prg.build()
        return prg
    prg = ConicProgram(device="cpu")
    x = prg.variable("x", 3)
    prg.add_constraint("ball", lambda xv: [soc(torch.cat(
        [torch.ones(1, dtype=xv.dtype), xv]))], (x,))
    prg.add_constraint("half", lambda xv: [nonpos(0.5 - xv[0:1])], (x,))
    prg.add_cost(lambda xv: xv[0] + 0.3 * xv[1] - 0.2 * xv[2], (x,))
    prg.build()
    return prg


def test_conic_program_native_backend_in_both_packages():
    prg_t, prg_j = _ball_program("torch"), _ball_program("jax")
    nat_t = prg_t.solve(backend="native")
    nat_j = prg_j.solve(backend="native")
    np.testing.assert_allclose(nat_t.values["x"].numpy(),
                               np.asarray(nat_j.values["x"]), rtol=0,
                               atol=1e-10)
    assert float(nat_t.obj) == pytest.approx(float(nat_j.obj), abs=1e-10)
    assert int(nat_t.status) == int(nat_j.status) == 0
    for k in nat_j.duals:
        np.testing.assert_allclose(nat_t.duals[k].numpy(),
                                   np.asarray(nat_j.duals[k]), atol=1e-10)
    # the device path ("torch", the default) agrees with it
    dev = prg_t.solve()
    assert float(dev.obj) == pytest.approx(float(nat_t.obj), abs=1e-7)
    np.testing.assert_allclose(dev.values["x"].numpy(),
                               nat_t.values["x"].numpy(), rtol=1e-5,
                               atol=1e-6)


def test_backend_errors(monkeypatch):
    prg = _ball_program("torch")
    with pytest.raises(ValueError, match="unknown backend"):
        prg.solve(backend="jax")
    # an exp-cone program: ipm.cpp has no exponential cone
    ep = ConicProgram(device="cpu")
    v = ep.variable("v", 3)
    ep.add_constraint("e", lambda vv: [exp_cone(vv)], (v,))
    ep.add_cost(lambda vv: vv[2], (v,))
    ep.build()
    with pytest.raises(ValueError, match="exponential cone"):
        ep.solve(backend="native")
    with pytest.raises(ValueError, match="exponential cone"):
        tnative.solve(np.zeros((3, 1)), np.zeros(3), np.zeros(1),
                      ConeSpec(nexp=1))
    # an unavailable library raises; the device path is not taken instead
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_build_error", "g++ missing")
    with pytest.raises(RuntimeError, match="g\\+\\+ missing"):
        prg.solve(backend="native")


def test_build_goes_to_the_port_build_dir(tmp_path, monkeypatch):
    """A fresh build lands in the given build directory (the package's
    git-ignored _build/ by default) and writes nothing under native/."""
    native_dir = tnative.SOURCE.parent
    listing = lambda d: sorted(
        os.path.relpath(os.path.join(r, f), d)
        for r, _, fs in os.walk(d) for f in fs)
    before = listing(native_dir)
    assert tnative.BUILD_DIR == tnative._PKG / "_build"
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_build_error", None)
    assert tnative.available(), tnative.build_error()
    assert listing(tmp_path) == [
        os.path.join("_build", tnative.library_path().name)]
    assert listing(native_dir) == before
