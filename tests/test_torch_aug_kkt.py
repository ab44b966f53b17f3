"""The port's staged cyclic-reduction KKT (scptoolbox_torch/ops/aug_kkt.py)
against the JAX package's StagedCR, on the real double-integrator PTR
subproblem at its guess (N=15, float64): the port's StagedCRPL (plain LU
engine on the CPU) and StagedCR (torch.linalg LU) both reproduce the JAX
StagedCR solve (the pattern of test_pallas_kernels.py:174-215)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scptoolbox_torch import interop
from scptoolbox_torch.ops import aug_kkt as taug
from scptoolbox_torch.ops import cones as tcn
from scptoolbox_torch.solvers import ptr as tptr
from scptoolbox_tpu.ops import aug_kkt as jaug
from scptoolbox_tpu.ops import cones as jcn
from tests import torch_refs as refs

torch.set_num_threads(1)

REG = 1e-10


@pytest.fixture(scope="module")
def subproblem():
    J = refs.jax_di_ptr()
    T = tptr.PTR(refs.tdi.double_integrator(
        refs.tdi.DoubleIntegratorParameters(**refs.DI_MODEL)),
        tptr.PTRParameters(**refs.DI_PARS, kkt_method="staged_crpl"),
        device="cpu")
    A = refs.di_subproblem()[0]
    spec = J.spec
    cone_mask = jnp.asarray(spec.cone_mask(), A.dtype)
    st_j = J._kkt_builder(spec, jnp.asarray(A), REG, cone_mask).st
    st_t = T.kkt_builder.structure
    rng = np.random.default_rng(0)
    s, z = refs.interior(spec, rng), refs.interior(spec, rng)
    rhs = rng.standard_normal((A.shape[0] + A.shape[1], 2))
    sp = dict(A=A, spec=spec, st_j=st_j, st_t=st_t, s=s, z=z, rhs=rhs)
    sp["jax"] = {W_on: _jax_solve(sp, W_on) for W_on in (True, False)}
    return sp


def test_stage_structure_matches_jax(subproblem):
    st_j, st_t = subproblem["st_j"], subproblem["st_t"]
    for name in ("ns", "rmax", "ng", "mg", "N"):
        assert getattr(st_t, name) == getattr(st_j, name), name
    for name in ("scols", "scols_next", "rows_pad", "g_cols", "global_rows",
                 "blk_stage", "blk_global"):
        np.testing.assert_array_equal(getattr(st_t, name),
                                      getattr(st_j, name), err_msg=name)


def _jax_solve(sp, W_on):
    """The JAX StagedCR solve, jitted (eagerly it takes several times as
    long on the CPU)."""
    spec = sp["spec"]

    def run(A, s, z, rhs):
        cone_mask = jnp.asarray(spec.cone_mask(), A.dtype)
        kkt = jaug.StagedCR(spec, A, REG, cone_mask, sp["st_j"])
        W = jcn.nt_scaling(spec, s, z) if W_on else None
        return kkt.solve(kkt.factor(W), rhs)

    return np.asarray(jax.jit(run)(*(jnp.asarray(sp[k]) for k in
                                     ("A", "s", "z", "rhs"))))


@pytest.mark.parametrize("cls", ["StagedCRPL", "StagedCR"])
@pytest.mark.parametrize("W_on", [True, False])
def test_staged_solve_matches_jax_staged_cr(subproblem, cls, W_on):
    sp = subproblem
    spec_t = interop.cone_spec(sp["spec"].nz, sp["spec"].nl, sp["spec"].socs)
    T = lambda a: torch.as_tensor(a, dtype=torch.float64)[None]
    A = T(sp["A"])
    kkt = getattr(taug, cls)(spec_t, A, REG,
                             torch.as_tensor(spec_t.cone_mask()), sp["st_t"])
    W = tcn.nt_scaling(spec_t, T(sp["s"]), T(sp["z"])) if W_on else None
    sol = kkt.solve(kkt.factor(W), T(sp["rhs"]))[0].numpy()
    np.testing.assert_allclose(sol, sp["jax"][W_on], rtol=1e-6,
                               atol=1e-7)


def test_staged_crpl_batch_equals_singles(subproblem):
    sp = subproblem
    spec_t = interop.cone_spec(sp["spec"].nz, sp["spec"].nl, sp["spec"].socs)
    rng = np.random.default_rng(1)
    A = torch.as_tensor(np.stack([sp["A"], sp["A"] * (
        1.0 + 0.1 * rng.standard_normal(sp["A"].shape) * (sp["A"] != 0))]))
    s = torch.as_tensor(np.stack([sp["s"], 1.5 * sp["s"]]))
    z = torch.as_tensor(np.stack([sp["z"], 0.5 * sp["z"]]))
    rhs = torch.as_tensor(np.stack([sp["rhs"], -sp["rhs"]]))
    mask = torch.as_tensor(spec_t.cone_mask())

    def run(i):
        kkt = taug.StagedCRPL(spec_t, A[i], REG, mask, sp["st_t"])
        W = tcn.nt_scaling(spec_t, s[i], z[i])
        return kkt.solve(kkt.factor(W), rhs[i])

    both = run(slice(0, 2))
    for i in range(2):
        np.testing.assert_allclose(both[i].numpy(),
                                   run(slice(i, i + 1))[0].numpy(),
                                   rtol=1e-10, atol=1e-12)


def test_staged_crpl_float32_matches_jax(subproblem):
    # the card's working type: the deeper float32 FGMRES keeps the solve
    # within a few float32 roundings of the float64 answer
    sp = subproblem
    spec_t = interop.cone_spec(sp["spec"].nz, sp["spec"].nl, sp["spec"].socs)
    T = lambda a: torch.as_tensor(a, dtype=torch.float32)[None]
    A = T(sp["A"])
    kkt = taug.StagedCRPL(spec_t, A, 1e-7,
                          torch.as_tensor(spec_t.cone_mask(),
                                          dtype=torch.float32), sp["st_t"])
    assert kkt.gmres_iters == taug.StagedCR.GMRES_ITERS[torch.float32]
    W = tcn.nt_scaling(spec_t, T(sp["s"]), T(sp["z"]))
    sol = kkt.solve(kkt.factor(W), T(sp["rhs"]))[0].double().numpy()
    ref = sp["jax"][True]
    np.testing.assert_allclose(sol, ref, rtol=1e-3,
                               atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("k", [8, 16])
def test_fgmres_least_squares_matches_jax_float32(k):
    # FGMRES's small least squares min ||beta e1 - H y|| in float32: the
    # port's Givens rotations against the JAX StagedCR's reduced QR and
    # triangular solve (scptoolbox_tpu/ops/aug_kkt.py:888-891), both held
    # to the float64 solution; each of the 4 systems has its own Hessenberg H
    rng = np.random.default_rng(k)
    H = np.triu(rng.standard_normal((4, k + 1, k)), -1)
    H[:, np.arange(k) + 1, np.arange(k)] = np.abs(
        H[:, np.arange(k) + 1, np.arange(k)]) + 0.1
    beta = np.abs(rng.standard_normal(4)) + 0.5
    rhs = np.zeros((4, k + 1))
    rhs[:, 0] = beta
    ref = np.stack([np.linalg.lstsq(H[i], rhs[i], rcond=None)[0]
                    for i in range(4)])

    def jax_lstsq(H, beta):
        Qh, Rh = jnp.linalg.qr(H)
        e1 = jnp.zeros(k + 1, H.dtype).at[0].set(beta)
        return jax.scipy.linalg.solve_triangular(Rh, Qh.T @ e1, lower=False)

    y_j = np.asarray(jax.vmap(jax_lstsq)(jnp.asarray(H, jnp.float32),
                                         jnp.asarray(beta, jnp.float32)))
    y_t = taug._hessenberg_lstsq(torch.as_tensor(H, dtype=torch.float32),
                                 torch.as_tensor(beta, dtype=torch.float32))
    assert y_j.dtype == np.float32 and y_t.dtype == torch.float32
    scale = np.abs(ref).max(axis=1, keepdims=True)
    err_j = np.abs(y_j - ref) / scale
    err_t = np.abs(y_t.numpy() - ref) / scale
    assert err_j.max() <= 1e-5, err_j.max()
    assert err_t.max() <= 1e-5, err_t.max()
