"""The port's stage-structured KKT (scptoolbox_torch/ops/block_kkt.py, its
block sweep on the plain versions of ops/chol_kernels.py here) against the
JAX package's (scptoolbox_tpu/ops/block_kkt.py), on the first PTR
subproblem of the default double integrator at N=15 with the block sweep
forced (tests/test_block_kkt.py:18-30), float64: the stage structure, KKT
solves at an NT scaling and at W = None, a batch of two scalings, a whole
IPM solve, and the KKT method policy of solvers/structure.py.

The JAX side is one jitted call (assembly, both KKT solves and the IPM), so
the file compiles twice: that and the JAX PTR's structure probe."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scptoolbox_torch.ops import block_kkt as tbk
from scptoolbox_torch.ops import cones as tcn
from scptoolbox_torch.ops import ipm as tipm
from scptoolbox_torch.solvers import structure as tstruct
from scptoolbox_tpu.ops import cones as jcn
from scptoolbox_tpu.ops import ipm as jipm
from scptoolbox_tpu.solvers import structure as jstruct
from tests import torch_refs as refs

torch.set_num_threads(1)

REG = 1e-10


@pytest.fixture(scope="module")
def case():
    """Both PTRs, the subproblem (A, b, c), two interior points, the
    right-hand sides, and the JAX results on them."""
    J, T = refs.di_block_pair()
    spec = J.spec
    n, m = J.tmpl.n, spec.m
    rng = np.random.default_rng(7)
    pts = [refs.interior(spec, rng) for _ in range(4)]
    rhs1 = rng.standard_normal(n + m)
    rhs2 = rng.standard_normal((n + m, 2))
    mask = jnp.asarray(spec.cone_mask())

    @jax.jit
    def run_jax(s, z, rhs1, rhs2):
        xg, ug, pg = J._guess
        A, b, c, _ = J._assemble(xg, ug, pg, J._discretize(xg, ug, pg),
                                 J.consts)
        kkt = J._kkt_builder(spec, A, REG, mask)
        fac = kkt.factor(jcn.nt_scaling(spec, s, z))
        fac0 = kkt.factor(None)
        sol = jipm.solve(A, b, c, spec, tol=1e-9, max_iter=60,
                         kkt_builder=J._kkt_builder)
        return dict(A=A, b=b, c=c, one=kkt.solve(fac, rhs1),
                    two=kkt.solve(fac, rhs2), init=kkt.solve(fac0, rhs2),
                    x=sol.x, status=sol.status)

    out = {k: np.asarray(v) for k, v in run_jax(
        *(jnp.asarray(a) for a in (pts[0], pts[1], rhs1, rhs2))).items()}
    return types.SimpleNamespace(J=J, T=T, pts=pts, rhs1=rhs1, rhs2=rhs2,
                                 jax=out, spec_t=T.spec)


def _t(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


def _port_kkt(case, A):
    mask = torch.as_tensor(case.spec_t.cone_mask(), dtype=torch.float64)
    return case.T.kkt_builder(case.spec_t, A, REG, mask)


STRUCTURE_FIELDS = ("N", "n", "m_C", "ns", "ng", "g_cols", "scols",
                    "scols_next", "col_pad", "rmax", "rows_pad",
                    "global_rows", "gmax", "gf_pad", "gf_cols")


@pytest.mark.parametrize("field", STRUCTURE_FIELDS)
def test_stage_structure_equals_jax(case, field):
    A = jnp.asarray(case.jax["A"])
    st_j = case.J._kkt_builder(case.J.spec, A, REG, jnp.asarray(
        case.J.spec.cone_mask())).st
    st_t = case.T.kkt_builder.structure
    assert isinstance(st_t, tbk.StageStructure)
    np.testing.assert_array_equal(np.asarray(getattr(st_t, field)),
                                  np.asarray(getattr(st_j, field)))


@pytest.mark.parametrize("which", ["one", "two", "init"])
def test_solve_matches_jax_and_dense(case, which):
    """One right-hand side and two at an NT scaling, and two at W = None
    (the initialization solve): the JAX block sweep within rtol 1e-9 /
    atol 1e-10, the port's dense Schur KKT within 1e-7."""
    A = _t(case.jax["A"])[None]
    spec = case.spec_t
    kkt = _port_kkt(case, A)
    dense = tipm._SchurKKT(spec, A, REG, kkt.cone_mask)
    W = (None if which == "init" else
         tcn.nt_scaling(spec, _t(case.pts[0])[None], _t(case.pts[1])[None]))
    rhs = _t(case.rhs1 if which == "one" else case.rhs2)[None]
    sol = kkt.solve(kkt.factor(W), rhs)[0].numpy()
    assert sol.shape == case.jax[which].shape
    np.testing.assert_allclose(sol, case.jax[which], rtol=1e-9, atol=1e-10)
    ref = dense.solve(dense.factor(W), rhs if rhs.dim() == 3
                      else rhs[..., None])[0].numpy().reshape(sol.shape)
    np.testing.assert_allclose(sol, ref, rtol=1e-7, atol=1e-7)


def test_batch_of_two_equals_single_solves(case):
    """B=2 scenarios, each with its own scaling, solve as each alone."""
    A = _t(case.jax["A"])[None]
    spec = case.spec_t
    s = torch.stack([_t(case.pts[0]), _t(case.pts[2])])
    z = torch.stack([_t(case.pts[1]), _t(case.pts[3])])
    rhs = _t(case.rhs2)[None].expand(2, -1, -1)
    kkt2 = _port_kkt(case, A.expand(2, -1, -1))
    both = kkt2.solve(kkt2.factor(tcn.nt_scaling(spec, s, z)), rhs)
    kkt1 = _port_kkt(case, A)
    for i in range(2):
        one = kkt1.solve(kkt1.factor(tcn.nt_scaling(spec, s[i:i + 1],
                                                    z[i:i + 1])), rhs[:1])
        scale = one.abs().max().item()
        np.testing.assert_allclose(both[i].numpy(), one[0].numpy(),
                                   rtol=1e-12, atol=1e-12 * scale)
    assert not torch.allclose(both[0], both[1])


def test_ipm_with_block_builder_matches_jax(case):
    A, b, c = (_t(case.jax[k]) for k in "Abc")
    sol = tipm.solve(A, b, c, case.spec_t, tol=1e-9, max_iter=60,
                     kkt_builder=case.T.kkt_builder)
    assert int(sol.status) == int(case.jax["status"]) == int(
        tipm.IPMStatus.OPTIMAL)
    x_j = case.jax["x"]
    np.testing.assert_allclose(sol.x.numpy(), x_j, rtol=1e-7,
                               atol=1e-7 * np.abs(x_j).max())


def _kind(builder, spec, A, mask):
    return None if builder is None else type(builder(spec, A, REG,
                                                     mask)).__name__


@pytest.mark.parametrize("n,dtype,structured", [
    (None, "float64", None), (None, "float64", True),
    (None, "float64", False), (700, "float64", None),
    (700, "float64", False), (700, "float32", None)])
def test_resolve_kkt_matches_jax(case, n, dtype, structured):
    """(method, kind of KKT built) of both packages' resolve_kkt, on the
    double integrator's template (n = 154) and on the same template
    presented as n = 700 (the auto policy's large side), probing the same
    assembled A."""
    A_np = case.jax["A"]
    probe = lambda seed: A_np
    picks = []
    for tmpl, dt, A, spec, mod in (
            (case.J.tmpl, {"float64": jnp.float64, "float32": jnp.float32},
             jnp.asarray(A_np), case.J.spec, jstruct),
            (case.T.tmpl, {"float64": torch.float64,
                           "float32": torch.float32},
             _t(A_np)[None], case.spec_t, tstruct)):
        view = types.SimpleNamespace(
            n=tmpl.n if n is None else n, dtype=dt[dtype], N=tmpl.N,
            spec=tmpl.spec, layout=tmpl.layout)
        method, builder = mod.resolve_kkt(view, probe, None, structured)
        mask = (jnp.asarray(spec.cone_mask()) if mod is jstruct else
                torch.as_tensor(spec.cone_mask(), dtype=torch.float64))
        picks.append((method, _kind(builder, spec, A, mask)))
    assert picks[0] == picks[1]
    expect_block = structured or (structured is None and n == 700
                                  and dtype == "float64")
    assert (picks[1][1] == "StructuredKKT") == bool(expect_block)
