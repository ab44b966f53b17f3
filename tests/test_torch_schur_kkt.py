"""The dense Schur KKT's Cholesky ladder (scptoolbox_torch/ops/ipm.py
`_SchurKKT` with use_lu = False: chol(H), H^-1 A_E', chol(S) and cho_solve
against both, on the plain versions of ops/chol_kernels.py here) against the
JAX package's `_SchurKKT` with use_lu = False (jnp.linalg.cholesky and
cho_solve), on the same numpy inputs: one KKT solve at an NT scaling (the
pattern of test_pallas_kernels.py:83-119) and one whole IPM solve of the
double integrator's first PTR subproblem through builders that force the
ladder on both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scptoolbox_torch import interop
from scptoolbox_torch.ops import cones as tcn
from scptoolbox_torch.ops import ipm as tipm
from scptoolbox_torch.solvers import ptr as tptr
from scptoolbox_tpu.ops import cones as jcn
from scptoolbox_tpu.ops import ipm as jipm
from tests import torch_refs as refs

torch.set_num_threads(1)


def _ladder(mod):
    def build(spec, A, reg_eps, cone_mask):
        kkt = mod._SchurKKT(spec, A, reg_eps, cone_mask)
        kkt.use_lu = False
        return kkt
    return build


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-10),
                                       (np.float32, 2e-4)])
def test_ladder_solve_matches_jax(dtype, tol):
    """One factor and solve at an interior NT scaling, two right-hand sides;
    the port's ladder also against its own LU branch."""
    rng = np.random.default_rng(21)
    nz, nl, socs, n = 3, 8, (5, 4), 10
    spec_j = jcn.ConeSpec(nz=nz, nl=nl, socs=socs)
    spec_t = interop.cone_spec(nz, nl, socs)
    A = rng.standard_normal((spec_j.m, n)).astype(dtype)
    s, z = refs.interior(spec_j, rng), refs.interior(spec_j, rng)
    rhs = rng.standard_normal((n + spec_j.m, 2)).astype(dtype)
    reg = 1e-10 if dtype == np.float64 else 1e-7
    mask = spec_j.cone_mask().astype(dtype)

    @jax.jit
    def run_jax(A, s, z, rhs):
        kj = _ladder(jipm)(spec_j, A, reg, jnp.asarray(mask))
        return kj.solve(kj.factor(jcn.nt_scaling(spec_j, s, z)), rhs)

    sol_j = np.asarray(run_jax(*(jnp.asarray(v, dtype) for v in
                                 (A, s, z, rhs))))

    T = lambda a: torch.as_tensor(a)[None]
    kt = _ladder(tipm)(spec_t, T(A), reg, torch.as_tensor(mask))
    Wt = tcn.nt_scaling(spec_t, T(s.astype(dtype)), T(z.astype(dtype)))
    fac = kt.factor(Wt)
    assert fac[0] == "chol"
    sol_t = kt.solve(fac, T(rhs))[0].numpy()
    assert sol_t.dtype == dtype
    scale = np.abs(sol_j).max()
    assert np.abs(sol_t - sol_j).max() <= tol * scale
    kt.use_lu = True
    sol_lu = kt.solve(kt.factor(Wt), T(rhs))[0].numpy()
    assert np.abs(sol_t - sol_lu).max() <= tol * scale


def test_ladder_ipm_matches_jax_on_double_integrator():
    """A whole IPM solve of the double integrator's first PTR subproblem
    (bench.py's model at N=15, float64, assembled by the port at its guess)
    on the ladder: same status and iterations, objective within a relative
    1e-8."""
    T = tptr.PTR(refs.tdi.double_integrator(
        refs.tdi.DoubleIntegratorParameters(**refs.DI_MODEL)),
        tptr.PTRParameters(**refs.DI_PARS), device="cpu")
    x, u, p = (a[None] for a in T._guess)
    A, b, c, _ = (a[0].numpy() for a in T._assemble(
        x, u, p, T._discretize(x, u, p), None))
    spec_t = T.spec
    spec_j = jcn.ConeSpec(nz=spec_t.nz, nl=spec_t.nl, socs=spec_t.socs)
    sj = jipm.solve(jnp.asarray(A), jnp.asarray(b), jnp.asarray(c), spec_j,
                    tol=3e-6, max_iter=30, kkt_builder=_ladder(jipm))
    st = tipm.solve(*interop.conic_data(A, b, c, torch.float64, "cpu"),
                    spec_t, tol=3e-6, max_iter=30, kkt_builder=_ladder(tipm))
    assert int(st.status) == int(sj.status) == int(tipm.IPMStatus.OPTIMAL)
    assert int(st.iters) == int(sj.iters)
    assert float(st.obj) == pytest.approx(float(sj.obj), rel=1e-8)
