"""The slice as a whole: the port's batched PTR (scptoolbox_torch/solvers/ptr.py)
against the JAX package's, on the same numpy inputs (float64 on the CPU).

* Double integrator (the parameters of bench.py:33-36 at N=15, Nsub=8), B=4
  perturbed guesses, 3 SCP iterations: the port on "staged_crpl" (the LU
  kernels' plain versions here) against JAX `solve_batched` on "staged_cr"
  (the same algebra and pivot rule; the Pallas kernels in interpret mode
  would be far too slow for a whole PTR run).
* Starship flip at N=31, without an SCP solve: the initial guess, the
  assembled subproblem (A, b, c) at the guess, and one float32 staged KKT
  solve on it. Both sides are built with "staged_cr", so that JAX never
  probes its block_kkt sweep.
* The entry points' device policy, and what importing the package does."""

import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scptoolbox_torch import interop
from scptoolbox_torch.config import SCPStatus
from scptoolbox_torch.ops import aug_kkt as taug
from scptoolbox_torch.ops import cones as tcn
from scptoolbox_torch.ops import cuda_lib
from scptoolbox_torch.solvers import ptr as tptr
from scptoolbox_tpu.ops import aug_kkt as jaug
from scptoolbox_tpu.ops import cones as jcn
from scptoolbox_tpu.solvers import ptr as jptr
from tests import torch_refs as refs

torch.set_num_threads(1)

B, N_ITERS = 4, 3


@pytest.fixture(scope="module")
def di_runs():
    J = refs.jax_di_ptr()
    T = tptr.PTR(refs.tdi.double_integrator(
        refs.tdi.DoubleIntegratorParameters(**refs.DI_MODEL)),
        tptr.PTRParameters(**refs.DI_PARS, kkt_method="staged_crpl"),
        device="cpu")
    gx, gu, gp = (np.asarray(a) for a in J._guess)
    scale = (1.0 + 0.1 * (np.arange(B) / B - 0.5))[:, None, None]
    bx = gx[None] * scale
    bu = np.broadcast_to(gu, (B,) + gu.shape).copy()
    bp = np.broadcast_to(gp, (B,) + gp.shape).copy()
    oj = jax.device_get(J.solve_batched(jnp.asarray(bx), jnp.asarray(bu),
                                        jnp.asarray(bp), N_ITERS))
    ot = T.solve_batched(*interop.trajectory(bx, bu, bp, torch.float64,
                                             "cpu"), N_ITERS)
    return J, T, oj, ot


def test_double_integrator_staged_probe_succeeds(di_runs):
    # a failed probe would fall back to the dense LU KKT on both sides
    J, T, _, _ = di_runs
    assert J._kkt_builder is not None and T.kkt_builder is not None
    assert T._kkt_method == "staged_crpl"


def test_double_integrator_batched_ptr_matches_jax(di_runs):
    _, _, oj, ot = di_runs
    for i in range(B):
        for k in ("x", "u", "p"):
            a, b = np.asarray(oj[k][i]), ot[k][i].numpy()
            np.testing.assert_allclose(b, a, rtol=1e-6,
                                       atol=1e-6 * np.abs(a).max(initial=1.0),
                                       err_msg=f"{k}[{i}]")
    for k in ("status", "iters", "feas"):
        np.testing.assert_array_equal(ot[k].numpy(), np.asarray(oj[k]),
                                      err_msg=k)
    np.testing.assert_allclose(ot["J_aug"].numpy(), np.asarray(oj["J_aug"]),
                               rtol=1e-6)
    # the run this test pins: every scenario converges and is feasible
    assert (ot["status"] == int(SCPStatus.SOLVED)).all()
    assert ot["feas"].all()


@pytest.fixture(scope="module")
def starship_solvers():
    pj, pt = refs.starship_pair()
    J = jptr.PTR(pj, jptr.PTRParameters(**refs.SS_PARS))
    T = tptr.PTR(pt, tptr.PTRParameters(**refs.SS_PARS), device="cpu")
    return J, T


def test_starship_guess_matches_jax(starship_solvers):
    J, T = starship_solvers
    for name, a, b in zip("xup", J._guess, T._guess):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-8,
                                   atol=1e-8 * np.abs(a).max(initial=1.0),
                                   err_msg=name)


@pytest.fixture(scope="module")
def starship_subproblem(starship_solvers):
    """The Starship subproblem at the JAX guess from both packages: the JAX
    assembly jitted (eagerly it takes over ten times as long on the CPU)."""
    J, T = starship_solvers
    jax_abck = jax.jit(lambda x, u, p: J._assemble(
        x, u, p, J._discretize(x, u, p), J.consts))(*J._guess)
    gx, gu, gp = (np.asarray(a) for a in J._guess)
    x, u, p = interop.trajectory(gx[None], gu[None], gp[None], torch.float64,
                                 "cpu")
    return ([np.asarray(a) for a in jax_abck],
            T._assemble(x, u, p, T._discretize(x, u, p), None))


def test_starship_subproblem_matches_jax(starship_solvers,
                                        starship_subproblem):
    J, T = starship_solvers
    assert T.tmpl.n == J.tmpl.n and T.tmpl.m == J.tmpl.m
    assert (T.spec.nz, T.spec.nl, T.spec.socs) == (J.spec.nz, J.spec.nl,
                                                   J.spec.socs)
    # the same reference (the JAX guess) on both sides
    (A_j, b_j, c_j, k_j), (A_t, b_t, c_t, k_t) = starship_subproblem
    for name, a, b in (("A", A_j, A_t), ("b", b_j, b_t), ("c", c_j, c_t)):
        np.testing.assert_allclose(b[0].numpy(), a, rtol=1e-10,
                                   atol=1e-10 * np.abs(a).max(initial=1.0),
                                   err_msg=name)
    np.testing.assert_allclose(float(k_t[0]), float(k_j), rtol=1e-10,
                               atol=1e-10)


def test_starship_kkt_float32_matches_jax_float32(starship_solvers,
                                                  starship_subproblem):
    """The card's working type on the Starship guess subproblem: the staged
    CR factor and its plain solve (Jacobi equilibration, the IPM's float32
    regularization 1e-7, the CR levels, the arrow Schur complement; no
    FGMRES) at an interior NT scaling, in float32 by the JAX StagedCR and by
    the port's StagedCRPL and StagedCR (library LU, two intra-op threads).
    All are held to a relative 1e-5 of the port's float64 solve of the same
    system, whose parity with the JAX float64 solve test_torch_aug_kkt.py
    holds."""
    J, T = starship_solvers
    A = starship_subproblem[0][0]
    spec = J.spec
    st_j = J._kkt_builder(spec, jnp.asarray(A), 1e-7,
                          jnp.asarray(spec.cone_mask(), A.dtype)).st
    rng = np.random.default_rng(0)
    s, z = refs.interior(spec, rng), refs.interior(spec, rng)
    rhs = rng.standard_normal((A.shape[0] + A.shape[1], 2))

    @jax.jit
    def run_jax(A, s, z, rhs):
        kkt = jaug.StagedCR(spec, A, 1e-7, jnp.asarray(spec.cone_mask(),
                                                       A.dtype), st_j)
        W = jcn.nt_scaling(spec, s, z)
        return kkt._post_sol(W, kkt._solve_once(kkt.factor(W),
                                                kkt._pre_rhs(W, rhs)))

    def run_port(dt, cls=taug.StagedCRPL):
        f = lambda a: torch.as_tensor(a, dtype=dt)[None]
        kkt = cls(T.spec, f(A), 1e-7, torch.as_tensor(
            T.spec.cone_mask(), dtype=dt), T.kkt_builder.structure)
        W = tcn.nt_scaling(T.spec, f(s), f(z))
        x = kkt._post_sol(W, kkt._solve_once(kkt.factor(W),
                                             kkt._pre_rhs(W, f(rhs))))[0]
        assert x.dtype == dt
        return x.double().numpy()

    ref = run_port(torch.float64)
    jax32 = run_jax(*(jnp.asarray(v, jnp.float32) for v in (A, s, z, rhs)))
    assert jax32.dtype == jnp.float32
    err = lambda x: np.abs(np.asarray(x, np.float64) - ref).max(0) / \
        np.abs(ref).max(0)
    assert (err(jax32) <= 1e-5).all(), err(jax32)
    assert (err(run_port(torch.float32)) <= 1e-5).all()
    # the port's StagedCR on the library LU, under two intra-op threads,
    # where a batched CPU getrf of these 158-wide blocks never returned
    assert (err(refs.with_threads(2, lambda: run_port(
        torch.float32, taug.StagedCR))) <= 1e-5).all()


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pbm = refs.tdi.double_integrator()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tptr.PTR(pbm, tptr.PTRParameters(N=5, Nsub=2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        refs.tss.starship(refs.tss.StarshipParameters(), N=5)


def test_import_builds_nothing_and_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import scptoolbox_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "from scptoolbox_torch.ops import chol_kernels, lu_kernels\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'scptoolbox_tpu'))\n"
        "assert not bad, bad\n"
        "assert lu_kernels.LIB.lib is None and chol_kernels.LIB.lib is None\n"
        "print(len([m for m in sys.modules if m.startswith(pkg.__name__)]))\n")
    listing = lambda: (sorted(cuda_lib.BUILD_DIR.iterdir())
                       if cuda_lib.BUILD_DIR.exists() else None)
    before = listing()
    res = subprocess.run([sys.executable, "-c", code],
                         cwd=cuda_lib.BUILD_DIR.parent.parent,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) > 20        # every module was imported
    assert listing() == before


def test_no_port_source_imports_jax():
    """No file of the package, and not chip_smoke.py, imports JAX or the
    JAX package, whether or not the import would run."""
    root = cuda_lib.BUILD_DIR.parent.parent
    files = sorted((root / "scptoolbox_torch").rglob("*.py")) + [
        root / "chip_smoke.py"]
    pat = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|scptoolbox_tpu)\b",
                     re.M)
    assert len(files) > 20
    bad = [str(f.relative_to(root)) for f in files
           if pat.search(f.read_text())]
    assert not bad, bad


def test_interop_consts_tree_keeps_structure_and_types():
    tree = {"g": 9.81, "box": [np.arange(3.0), (2, None)],
            "mask": np.array([1, 0])}
    t = interop.consts_tree(tree, torch.float32, "cpu")
    assert t["g"].dtype == torch.float32 and float(t["g"]) == pytest.approx(9.81)
    assert isinstance(t["box"], list) and isinstance(t["box"][1], tuple)
    assert t["box"][0].dtype == torch.float32 and t["box"][1][1] is None
    assert t["box"][1][0].dtype == t["mask"].dtype == torch.int64
