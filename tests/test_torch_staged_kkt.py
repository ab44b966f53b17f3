"""The port's stage sweeps StagedLU, StagedQR and StagedCRQD
(scptoolbox_torch/ops/aug_kkt.py) against the JAX package's on identical
numpy inputs (float64, the kernels' plain versions on the CPU): the
double-integrator PTR subproblem at N=15 (bench.py's model; the JAX
assembly of tests/torch_refs.py) with W and with W=None, and the Starship
template at N=15 after the IPM's Ruiz equilibration with W
(tests/test_aug_kkt.py:142-190); StagedCRQD's robust inverse Cholesky
factor and block inverse on random blocks, indefinite ones included; the
exp blocks of the softplus GuSTO template in both packages' stage probes,
and the float32 auto policy that takes them; the softplus subproblem on the
staged sweeps against the dense path (tests/test_exp_cone.py:253-286); PTR
end to end on "staged_lu" and "staged_qr" against the JAX dense default's
cost (tests/test_aug_kkt.py:126-139).

JAX compiles here: the staged solves of each subproblem, one jitted function
each, with StagedCRQD's FGMRES at depth 4 on both sides (16 unrolled
Krylov steps take the JAX package ~14 s to compile on the CPU; the depth is
an attribute of the instance). The double-integrator PTR, its subproblem
and its dense solve are shared with other files through tests/torch_refs.py.
The softplus subproblem (N=8) is held at one factor and solve of the QR
and CR sweeps against the dense path, and of the QR sweep against the JAX
package's (one more compile), not a whole IPM: on the CPU the plain
back-substitution makes an IPM on the QR sweep take ~30 s."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scptoolbox_torch import interop
from scptoolbox_torch.ops import aug_kkt as taug
from scptoolbox_torch.ops import chol_kernels
from scptoolbox_torch.ops import cones as tcn
from scptoolbox_torch.ops import ipm as tipm
from scptoolbox_torch.solvers import gusto as tgusto
from scptoolbox_torch.solvers import ptr as tptr
from scptoolbox_torch.solvers import structure as tstruct
from scptoolbox_tpu.ops import aug_kkt as jaug
from scptoolbox_tpu.ops import cones as jcn
from scptoolbox_tpu.ops.cones import ConeSpec as JConeSpec
from scptoolbox_tpu.solvers import structure as jstruct
from scptoolbox_tpu.solvers.subproblem import VarLayout as JVarLayout
from tests import torch_refs as refs

torch.set_num_threads(1)

REG = 1e-10
VARIANTS = {"lu": (taug.StagedLU, jaug.StagedLU),
            "qr": (taug.StagedQR, jaug.StagedQR),
            "crqd": (taug.StagedCRQD, jaug.StagedCRQD)}
GMRES = 4
# (variant, W given): the JAX package compiles each in ~1.5 s, StagedCRQD's
# in ~5 s (its factor's 30 Cholesky factors at N=15)
DI_RUNS = (("lu", True), ("lu", False), ("qr", True), ("qr", False),
           ("crqd", True))
STARSHIP_RUNS = (("lu", True), ("qr", True))
T64 = lambda a: torch.as_tensor(np.array(a), dtype=torch.float64)


def _jax_layout(layout):
    """A JAX VarLayout with the port layout's blocks, in its order."""
    jl = JVarLayout()
    for name, (off, shape) in layout._blocks.items():
        jl.add(name, *shape)
        assert jl._blocks[name][0] == off, name
    return jl


def _structures(layout, N, spec_t, probe):
    """(JAX, port) AugStageStructure of one template from one probe."""
    spec_j = JConeSpec(nz=spec_t.nz, nl=spec_t.nl, socs=spec_t.socs,
                       nexp=spec_t.nexp)
    return (jaug.AugStageStructure(_jax_layout(layout), N, spec_j, probe),
            taug.AugStageStructure(layout, N, spec_t, probe)), spec_j


def _same_partition(st_j, st_t):
    for name in ("N", "ns", "rmax", "ng", "mg"):
        assert getattr(st_t, name) == getattr(st_j, name), name
    for name in ("scols", "scols_next", "rows_pad", "g_cols", "global_rows",
                 "blk_stage", "blk_global"):
        np.testing.assert_array_equal(getattr(st_t, name),
                                      getattr(st_j, name), err_msg=name)


def _case(layout, N, spec_t, A, rng, runs):
    """The staged-KKT inputs of one subproblem matrix A (numpy): both
    packages' structures from A's own sparsity, an interior NT point, two
    right-hand sides, and the JAX solves of every variant (jitted)."""
    (st_j, st_t), spec_j = _structures(layout, N, spec_t, A)
    _same_partition(st_j, st_t)
    s, z = refs.interior(spec_j, rng), refs.interior(spec_j, rng)
    rhs = rng.standard_normal((A.shape[0] + A.shape[1], 2))

    def run(A, s, z, rhs):
        cm = jnp.asarray(spec_j.cone_mask(), A.dtype)
        out = {}
        for name, W_on in runs:
            kkt = VARIANTS[name][1](spec_j, A, REG, cm, st_j)
            kkt.gmres_iters = GMRES
            W = jcn.nt_scaling(spec_j, s, z) if W_on else None
            out[name, W_on] = kkt.solve(kkt.factor(W), rhs)
        return out

    jax_sol = jax.jit(run)(*(jnp.asarray(a) for a in (A, s, z, rhs)))
    return types.SimpleNamespace(
        A=A, spec=spec_t, st=st_t, s=s, z=z, rhs=rhs,
        jax={k: np.asarray(v) for k, v in jax_sol.items()})


def _port_solve(case, name, W_on):
    spec = case.spec
    kkt = VARIANTS[name][0](spec, T64(case.A)[None], REG,
                            T64(spec.cone_mask()), case.st)
    kkt.gmres_iters = GMRES
    W = (tcn.nt_scaling(spec, T64(case.s)[None], T64(case.z)[None])
         if W_on else None)
    return kkt.solve(kkt.factor(W), T64(case.rhs)[None])[0].numpy()


@pytest.fixture(scope="module")
def di():
    """The double integrator's first PTR subproblem at its guess (the JAX
    assembly at N=15; the template's layout serves both structures)."""
    J = refs.jax_di_ptr()
    spec_t = interop.cone_spec(J.spec.nz, J.spec.nl, J.spec.socs)
    return _case(J.tmpl.layout, 15, spec_t, refs.di_subproblem()[0],
                 np.random.default_rng(0), DI_RUNS)


@pytest.fixture(scope="module")
def starship():
    """The Starship template at N=15 assembled at its guess by the port and
    Ruiz-equilibrated as ipm.solve does before any KKT sees it."""
    pbm = refs.tss.starship(refs.tss.StarshipParameters(), N=15,
                            device="cpu")
    T = tptr.PTR(pbm, tptr.PTRParameters(N=15, Nsub=10, iter_max=2,
                                         kkt_method="staged_lu"),
                 device="cpu")
    assert T.kkt_builder is not None, "starship aug probe failed"
    x, u, p = (a[None] for a in T._guess)
    A = T._assemble(x, u, p, T._discretize(x, u, p), T.consts)[0]
    R, D = tipm._equilibrate(T.spec, A)
    A = (R[:, :, None] * A * D[:, None, :])[0].numpy()
    return _case(T.tmpl.layout, 15, T.spec, A, np.random.default_rng(1),
                 STARSHIP_RUNS)


@pytest.mark.parametrize("name,W_on", DI_RUNS)
def test_double_integrator_matches_jax(di, name, W_on):
    ref = di.jax[name, W_on]
    np.testing.assert_allclose(_port_solve(di, name, W_on), ref, rtol=1e-9,
                               atol=1e-9 * np.abs(ref).max())


@pytest.mark.parametrize("name", [r[0] for r in STARSHIP_RUNS])
def test_starship_matches_jax(starship, name):
    """At this random scaling the Starship system is near-singular (both
    packages' solutions carry ~1e10 null components, tests/test_aug_kkt.py
    :178-190). The port's KKT residual is held to 10x the JAX solve's, and
    each component below 1e6 to 1e-6 (1 + |JAX's|)."""
    c = starship
    ref = c.jax[name, True]
    sol = _port_solve(c, name, True)
    spec, A = c.spec, T64(c.A)[None]
    W = tcn.nt_scaling(spec, T64(c.s)[None], T64(c.z)[None])
    n = c.A.shape[1]

    def resid(v):
        v = T64(v)[None]
        w2 = tipm._w2_matvec(spec, W, v[:, n:], T64(spec.cone_mask()))
        r = T64(c.rhs)[None] - torch.cat(
            [A.transpose(1, 2) @ v[:, n:], A @ v[:, :n] - w2], dim=1)
        return float(torch.linalg.vector_norm(r) / np.linalg.norm(c.rhs))

    assert resid(sol) <= 10.0 * max(resid(ref), 1e-13), resid(ref)
    sane = np.abs(ref) < 1e6
    assert sane.mean() > 0.95
    assert np.all(np.abs(sol - ref)[sane] <= 1e-6 * (1.0 + np.abs(ref[sane])))


def _ladder_blocks(rng, n=7):
    """An SPD block, two indefinite ones that the robust inverse factor
    takes at its second and third rung (smallest eigenvalue moved to about
    -4e-4 and -1.7e-3 of the Jacobi-normalized block), and a negative
    definite one that only the identity backstop takes."""
    G = rng.standard_normal((n, n))
    spd = G @ G.T + n * np.eye(n)
    lam = np.linalg.eigvalsh(spd)[0]
    return np.stack([spd, spd - 1.0005 * lam * np.eye(n),
                     spd - 1.002 * lam * np.eye(n), -spd])


def _rungs(M):
    """The rung (0-2, or 3 for the identity) each block of M takes."""
    dg = np.einsum("bii->bi", M)
    sc = np.where(dg > 0, 1.0 / np.sqrt(np.abs(dg) + 1e-30), 1.0)
    Mh = M * sc[:, :, None] * sc[:, None, :]
    out = []
    for m in Mh:
        for i, r in enumerate((10 * np.sqrt(np.finfo(float).eps), 1e-3,
                               3e-1, None)):
            if r is None or np.linalg.eigvalsh(m)[0] + r > 1e-12:
                out.append(i)
                break
    return out


def test_chol_inv_robust_matches_jax():
    M = _ladder_blocks(np.random.default_rng(4))
    assert _rungs(M) == [0, 1, 2, 3]
    got = taug.StagedCRQD._chol_inv_robust(T64(M)).numpy()
    ref = np.asarray(jax.jit(jaug.StagedCRQD._chol_inv_robust)(
        jnp.asarray(M)))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=1e-9,
                               atol=1e-9 * np.abs(ref).max())
    # the negative definite block took the identity backstop in both
    np.testing.assert_array_equal(got[3], np.eye(M.shape[-1]))


def test_cholesky_plain_indefinite_gives_non_finite():
    """The kernels' plain Cholesky neither raises nor returns a finite
    factor on a non-SPD block, as JAX's cholesky gives NaN: the ladder
    reads its rungs by finiteness."""
    M = _ladder_blocks(np.random.default_rng(5))
    L = chol_kernels.cholesky_plain(T64(M))
    ok = torch.isfinite(L).all(dim=-1).all(dim=-1)
    ok_j = np.isfinite(np.asarray(jax.jit(jnp.linalg.cholesky)(
        jnp.asarray(M)))).all(
        axis=(-1, -2))
    assert ok.tolist() == ok_j.tolist() == [True, False, False, False]


def test_qd_inverse_matches_jax():
    rng = np.random.default_rng(6)
    nx, nz, nb = 5, 4, 3
    G = rng.standard_normal((nb, nx, nx))
    H = rng.standard_normal((nb, nz, nz))
    X = G @ G.transpose(0, 2, 1) + nx * np.eye(nx)
    Z = H @ H.transpose(0, 2, 1) + 0.5 * np.eye(nz)
    B = rng.standard_normal((nb, nz, nx))
    Z[2] = -Z[2]                  # an indefinite Z: the ladder's last rungs
    got = taug.StagedCRQD._qd_inverse(taug.StagedCRQD, T64(X), T64(B),
                                      T64(Z)).numpy()
    ref = np.asarray(jax.jit(lambda *a: jaug.StagedCRQD._qd_inverse(
        jaug.StagedCRQD, *a))(*(jnp.asarray(a) for a in (X, B, Z))))
    np.testing.assert_allclose(got, ref, rtol=1e-9,
                               atol=1e-9 * np.abs(ref).max())
    K = np.block([[X, B.transpose(0, 2, 1)], [B, -Z]])
    # the SPD blocks: the exact inverse up to the first rung's ridge
    np.testing.assert_allclose(got[:2], np.linalg.inv(K[:2]), rtol=1e-5,
                               atol=1e-5)


def _guess_subproblem(G, lam=1e3):
    x, u, p = (a[None] for a in G._guess)
    T = lambda v: torch.full((1,), v, dtype=G.dtype)
    return G._assemble(x, u, p, G._discretize(x, u, p), T(1.0), T(lam),
                       G.consts)


def test_exp_units_partition_matches_jax():
    """The softplus template (N=12, 72 exp blocks): one probe matrix, both
    packages' stage structures, the same partition, exp rows whole and
    the port's own probe resolving a builder."""
    G = tgusto.GuSTO(refs.tquad.quadrotor(), tgusto.GuSTOParameters(
        N=12, Nsub=6, kkt_method="staged_qr", **refs.GUSTO_SOFTPLUS),
        device="cpu")
    assert G.spec.nexp > 0 and G.kkt_builder is not None
    A = _guess_subproblem(G)[0][0].numpy()
    (st_j, st_t), _ = _structures(G.tmpl.layout, 12, G.spec, A)
    _same_partition(st_j, st_t)
    e0 = G.spec.m - 3 * G.spec.nexp
    where = {int(r): k for k, rows in enumerate(st_t.rows_pad)
             for r in rows}
    for b in range(G.spec.nexp):
        first = e0 + 3 * b
        assert where.get(first) == where.get(first + 1) == where.get(
            first + 2)


def test_float32_softplus_auto_policy_takes_staged_cr():
    """The float32 softplus quadrotor at N=30 (n = 752, 180 exp blocks)
    builds and resolves "staged_cr" with a builder, as the JAX package
    does; both packages' resolve_kkt give the same method and partition on
    one probe."""
    G = tgusto.GuSTO(refs.tquad.quadrotor(), tgusto.GuSTOParameters(
        N=30, Nsub=15, **refs.GUSTO_SOFTPLUS), dtype=torch.float32,
        device="cpu")
    assert (G.tmpl.n, G.spec.nexp) == (752, 180)
    assert G._kkt_method == "staged_cr" and G.kkt_builder is not None
    A = _guess_subproblem(G)[0][0].numpy()
    probe = lambda seed: A
    spec_j = JConeSpec(nz=G.spec.nz, nl=G.spec.nl, socs=G.spec.socs,
                       nexp=G.spec.nexp)
    jl = _jax_layout(G.tmpl.layout)
    picks = []
    for mod, layout, spec, dt in (
            (jstruct, jl, spec_j, jnp.float32),
            (tstruct, G.tmpl.layout, G.spec, torch.float32)):
        view = types.SimpleNamespace(n=G.tmpl.n, dtype=dt, N=30, spec=spec,
                                     layout=layout)
        picks.append(mod.resolve_kkt(view, probe, None, None))
    assert picks[0][0] == picks[1][0] == "staged_cr"
    st_j = picks[0][1](spec_j, jnp.asarray(A, jnp.float32), 1e-7,
                       jnp.asarray(spec_j.cone_mask(), jnp.float32)).st
    _same_partition(st_j, picks[1][1].structure)
    # "staged_lu" takes no exp cones in either package: the dense LU
    for mod, layout, spec, dt in (
            (jstruct, jl, spec_j, jnp.float32),
            (tstruct, G.tmpl.layout, G.spec, torch.float32)):
        view = types.SimpleNamespace(n=G.tmpl.n, dtype=dt, N=30, spec=spec,
                                     layout=layout)
        method, builder = mod.resolve_kkt(view, probe, "staged_lu", None)
        assert (method, builder) == ("staged_lu", None)
        assert mod.ipm_kkt_kwargs(method, builder) == dict(
            kkt_builder=None, kkt_method="lu")


@pytest.fixture(scope="module")
def softplus():
    """The softplus GuSTO subproblem (N=8, 48 exp blocks) at the guess (eta
    1, lambda 1e3) with its "staged_qr" and "staged_cr" builders, an
    interior point with the exp blocks' BFGS scaling, and the dense
    augmented LU's solve there."""
    G = {m: tgusto.GuSTO(refs.tquad.quadrotor(), tgusto.GuSTOParameters(
        N=8, Nsub=6, kkt_method=m, **refs.GUSTO_SOFTPLUS), device="cpu")
        for m in ("staged_qr", "staged_cr")}
    A = _guess_subproblem(G["staged_qr"])[0]
    spec = G["staged_qr"].spec
    rng = np.random.default_rng(7)
    s, z = (T64(refs.interior(spec, rng))[None] for _ in range(2))
    eidx = tcn.exp_idx(spec, "cpu")
    for v, c in ((s, tcn.EXP_PRIMAL_CENTRAL), (z, tcn.EXP_DUAL_CENTRAL)):
        v[:, eidx] = T64(c) * T64(1.0 + 0.2 * rng.random((spec.nexp, 1)))
    W = tcn.nt_scaling(spec, s, z, mu=torch.ones(1, dtype=torch.float64))
    mask = T64(spec.cone_mask())
    rhs = T64(rng.standard_normal((1, A.shape[1] + A.shape[2], 2)))
    dense = tipm._LUKKT(spec, A, REG, mask)
    # the JAX package's StagedQR on the same inputs (its structure from the
    # same probe matrix)
    (st_j, _), spec_j = _structures(G["staged_qr"].tmpl.layout, 8, spec,
                                    A[0].numpy())

    def jax_qr(A, s, z, rhs):
        kkt = jaug.StagedQR(spec_j, A, REG,
                            jnp.asarray(spec_j.cone_mask(), A.dtype), st_j)
        W = jcn.nt_scaling(spec_j, s, z, mu=jnp.asarray(1.0, A.dtype))
        return kkt.solve(kkt.factor(W), rhs)

    jax_ref = np.asarray(jax.jit(jax_qr)(*(jnp.asarray(a[0].numpy()) for a
                                           in (A, s, z, rhs))))
    return types.SimpleNamespace(G=G, A=A, spec=spec, W=W, mask=mask,
                                 rhs=rhs, jax_qr=jax_ref,
                                 ref=dense.solve(dense.factor(W), rhs))


@pytest.mark.parametrize("method,cls", [("staged_qr", "StagedQR"),
                                        ("staged_cr", "StagedCR")])
def test_softplus_staged_solve_matches_dense(softplus, method, cls):
    """One factor and solve of the softplus subproblem on the NT-scaled
    staged sweep (exp rows scaled by the BFGS W^-1, the cone block -I)
    against the dense augmented LU, to 1e-8 of the solution (the IPM on
    both paths: tests/test_exp_cone.py:253-286; here at its KKT solve, as
    the whole IPM on the plain QR back-substitution takes ~30 s on the
    CPU; chip_smoke.py runs the softplus GuSTO on the staged CR sweeps)."""
    sp = softplus
    kkt = sp.G[method].kkt_builder(sp.spec, sp.A, REG, sp.mask)
    assert type(kkt).__name__ == cls
    sol = kkt.solve(kkt.factor(sp.W), sp.rhs)
    scale = sp.ref.abs().max().item()
    np.testing.assert_allclose(sol.numpy(), sp.ref.numpy(), rtol=1e-8,
                               atol=1e-8 * scale)


def test_softplus_staged_qr_matches_jax(softplus):
    """The softplus subproblem's StagedQR factor and solve (exp rows scaled
    by the BFGS W^-1 through the cone map) against the JAX package's
    StagedQR on the same inputs, to 1e-9 of the solution."""
    sp = softplus
    kkt = sp.G["staged_qr"].kkt_builder(sp.spec, sp.A, REG, sp.mask)
    sol = kkt.solve(kkt.factor(sp.W), sp.rhs)[0].numpy()
    np.testing.assert_allclose(sol, sp.jax_qr, rtol=1e-9,
                               atol=1e-9 * np.abs(sp.jax_qr).max())


@pytest.fixture(scope="module")
def di_solver():
    return tptr.PTR(refs.tdi.double_integrator(
        refs.tdi.DoubleIntegratorParameters(**refs.DI_MODEL)),
        tptr.PTRParameters(**refs.DI_PARS, kkt_method="staged_lu"),
        device="cpu")


@pytest.mark.parametrize("method", ["staged_lu", "staged_qr"])
def test_ptr_staged_end_to_end_matches_jax_dense(di_solver, method):
    """Serial PTR on the double integrator (bench.py's model, N=15) on the
    staged sweep: SOLVED, its cost within rel 1e-5 of the JAX package's
    dense default solve (tests/test_aug_kkt.py:126-139). One solver serves
    both methods (its constructor's probes take seconds on the CPU): the
    "staged_qr" run takes its builder on the structure the constructor
    probed."""
    from scptoolbox_torch.config import SCPStatus

    T = di_solver
    make = {"staged_lu": taug.make_staged_lu_builder,
            "staged_qr": taug.make_staged_qr_builder}[method]
    T._kkt_method, T._kkt_builder = method, make(T.kkt_builder.structure)
    kkt = T.kkt_builder(T.spec, T64(np.zeros((1, T.tmpl.m, T.tmpl.n))),
                        REG, T64(T.spec.cone_mask()))
    assert type(kkt).__name__ == {"staged_lu": "StagedLU",
                                  "staged_qr": "StagedQR"}[method]
    sj = refs.jax_di_ptr_dense_solution()
    st = T.solve()
    assert st.status == sj.status == SCPStatus.SOLVED
    assert st.cost == pytest.approx(sj.cost, rel=1e-5)
