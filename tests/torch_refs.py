"""References shared by the port's parity tests (tests/test_torch_*.py).

Each is built once per test process: the JAX Starship constructor alone takes
several seconds on the CPU, and the double-integrator PTR is the reference of
both the staged-KKT and the whole-slice tests."""

import copy
import dataclasses
import functools
import threading
from importlib import import_module

import jax
import numpy as np
import torch

from scptoolbox_torch import interop
from scptoolbox_torch.ops.discretize import DiscretizationType as TDisc
from scptoolbox_torch.solvers import gusto as tgusto
from scptoolbox_torch.solvers import ptr as tptr
from scptoolbox_torch.solvers import scvx as tscvx
from scptoolbox_tpu.ops.discretize import DiscretizationType as JDisc
from scptoolbox_tpu.solvers import gusto as jgusto
from scptoolbox_tpu.solvers import ptr as jptr
from scptoolbox_tpu.solvers import scvx as jscvx

# the JAX models package re-exports functions under the module names
jdi = import_module("scptoolbox_tpu.models.double_integrator")
jss = import_module("scptoolbox_tpu.models.starship_flip")
tdi = import_module("scptoolbox_torch.models.double_integrator")
tss = import_module("scptoolbox_torch.models.starship_flip")
jrp = import_module("scptoolbox_tpu.models.rendezvous_planar")
trp = import_module("scptoolbox_torch.models.rendezvous_planar")
jquad = import_module("scptoolbox_tpu.models.quadrotor")
tquad = import_module("scptoolbox_torch.models.quadrotor")
jff = import_module("scptoolbox_tpu.models.freeflyer")
tff = import_module("scptoolbox_torch.models.freeflyer")

# bench.py:33-36, cut to N=15, Nsub=8
DI_MODEL = dict(drag=True, g=0.01, s=30.0)
DI_PARS = dict(N=15, Nsub=8, iter_max=3, wvc=1e3, wtr=5e-3, ipm_tol=3e-6,
               ipm_max_iter=30)
# bench.py:95-104, on "staged_cr" so that JAX never probes block_kkt
SS_PARS = dict(N=31, Nsub=30, iter_max=15, wvc=1e3, wtr=0.1, eps_abs=1e-5,
               eps_rel=1e-4, feas_tol=5e-3, ipm_tol=3e-6, ipm_max_iter=60,
               kkt_method="staged_cr")


# tests/test_block_kkt.py:18-30: the default double integrator at N=15 with
# the block sweep forced
BLOCK_PARS = dict(N=15, Nsub=8, iter_max=3, structured_kkt=True)
# solve_rendezvous_planar's parameters at N=8, Nsub=5, the block sweep forced
PLANAR_PARS = dict(N=8, Nsub=5, iter_max=2, wvc=5e2, wtr=0.3,
                   eps_abs=-np.inf, eps_rel=1e-5, feas_tol=5e-3,
                   ipm_max_iter=40, structured_kkt=True)
# tests/test_quadrotor.py:22-26 cut to N=8, Nsub=5 and five iterations, on
# the guess as it is (the projection is held on its own)
QUAD_PARS = dict(N=8, Nsub=5, lam=30.0, iter_max=5, project_guess=False)
# tests/test_freeflyer.py:23-32 cut to N=6, Nsub=5, with the q = 4 trust
# region (its tr_w / tr_geom rows)
FF_PARS = dict(N=6, Nsub=5, lam=1e3, iter_max=30, eta_lb=1e-6, eps_abs=1e-5,
               eps_rel=1e-4, feas_tol=1e-3, q_tr=4.0)


# tests/test_quadrotor.py:30-33 (the quadrotor_gusto pin) cut to N=8,
# Nsub=5 and four iterations, on the guess as it is; softplus adds :69-70
GUSTO_PARS = dict(N=8, Nsub=5, iter_max=4, project_guess=False)
GUSTO_SOFTPLUS = dict(pen="softplus", hom=500.0, lam_init=1e3)


@functools.cache
def quadrotor_gusto_pair(pen="quad"):
    """(JAX GuSTO, port GuSTO) on the quadrotor at GUSTO_PARS with the quad
    or the softplus penalty, the port's on the CPU in float64 and built
    from the JAX model parameters."""
    mdl = jquad.QuadrotorParameters()
    pars = dict(GUSTO_PARS, **(GUSTO_SOFTPLUS if pen == "softplus" else {}))
    T = tgusto.GuSTO(tquad.quadrotor(interop.model_parameters(
        tquad.QuadrotorParameters, dataclasses.asdict(mdl))),
        tgusto.GuSTOParameters(**pars), device="cpu")
    return jgusto.GuSTO(jquad.quadrotor(mdl),
                        jgusto.GuSTOParameters(**pars)), T


@functools.cache
def quadrotor_scvx_pair(structured_kkt=None):
    """(JAX SCvx, port SCvx) on the quadrotor at QUAD_PARS (structured_kkt
    True: the block sweep forced in both), the port's on the CPU in float64
    and built from the JAX model parameters."""
    mdl = jquad.QuadrotorParameters()
    pars = dict(QUAD_PARS, structured_kkt=structured_kkt)
    T = tscvx.SCvx(tquad.quadrotor(interop.model_parameters(
        tquad.QuadrotorParameters, dataclasses.asdict(mdl))),
        tscvx.SCvxParameters(**pars), device="cpu")
    return jscvx.SCvx(jquad.quadrotor(mdl), jscvx.SCvxParameters(**pars)), T


@functools.cache
def freeflyer_scvx_pair():
    """(JAX SCvx, port SCvx) on the free-flyer at N=6 with FF_PARS (the JAX
    constructor's LP auto-scaling alone takes tens of seconds on the CPU)."""
    mdl = jff.FreeFlyerParameters()
    T = tscvx.SCvx(tff.freeflyer(interop.model_parameters(
        tff.FreeFlyerParameters, dataclasses.asdict(mdl)), N=6),
        tscvx.SCvxParameters(**FF_PARS), device="cpu")
    return jscvx.SCvx(jff.freeflyer(mdl, N=6),
                      jscvx.SCvxParameters(**FF_PARS)), T


@functools.cache
def di_block_pair():
    """(JAX PTR, port PTR) on the default double integrator with the block
    sweep forced, the port's on the CPU in float64."""
    J = jptr.PTR(jdi.double_integrator(), jptr.PTRParameters(**BLOCK_PARS))
    T = tptr.PTR(tdi.double_integrator(), tptr.PTRParameters(**BLOCK_PARS),
                 device="cpu")
    return J, T


@functools.cache
def planar_pair():
    """(JAX PTR, port PTR) on the planar rendezvous at N=8 under IMPULSE
    discretization, the block sweep forced, both at the first rung of
    solve_rendezvous_planar's homotopy (kappa from each package's own
    schedule); the port's on the CPU in float64."""
    J = jptr.PTR(jrp.rendezvous_planar(), jptr.PTRParameters(
        **PLANAR_PARS, disc_method=JDisc.IMPULSE))
    J.consts = {"kappa": jax.numpy.asarray(float(
        jrp.Homotopy(delta_min=1e-3, delta_max=5.0)(0.0)))}
    T = tptr.PTR(trp.rendezvous_planar(), tptr.PTRParameters(
        **PLANAR_PARS, disc_method=TDisc.IMPULSE), device="cpu")
    T.consts = {"kappa": torch.tensor(float(
        trp.Homotopy(delta_min=1e-3, delta_max=5.0)(0.0)),
        dtype=torch.float64)}
    return J, T


@functools.cache
def jax_di_ptr():
    """JAX PTR on the double integrator, "staged_cr" KKT."""
    return jptr.PTR(jdi.double_integrator(
        jdi.DoubleIntegratorParameters(**DI_MODEL)),
        jptr.PTRParameters(**DI_PARS, kkt_method="staged_cr"))


@functools.cache
def jax_di_ptr_dense():
    """jax_di_ptr() on the default dense Schur KKT: a copy that shares its
    template (whose construction takes seconds on the CPU) with a step of
    its own."""
    J = copy.copy(jax_di_ptr())
    J._kkt_method, J._kkt_builder = None, None
    J._step = jax.jit(lambda rx, ru, rp, dltv, Jr, consts: J._step_impl(
        rx, ru, rp, dltv, Jr, consts))
    return J


@functools.cache
def jax_di_ptr_dense_solution():
    """jax_di_ptr_dense()'s serial solve (its jitted step compiles once)."""
    return jax_di_ptr_dense().solve()


@functools.cache
def di_subproblem():
    """(A, b, c, const) of the JAX double-integrator PTR's first subproblem,
    at its guess, as numpy arrays (the assembly jitted: eagerly it takes ten
    times as long on the CPU)."""
    J = jax_di_ptr()
    return tuple(np.asarray(a) for a in jax.jit(lambda x, u, p: J._assemble(
        x, u, p, J._discretize(x, u, p), J.consts))(*J._guess))


@functools.cache
def starship_pair():
    """The Starship problem at N=31 from both packages, the port's built
    from the JAX model parameters, on the CPU."""
    mdl = jss.StarshipParameters()
    pt = tss.starship(interop.model_parameters(
        tss.StarshipParameters, dataclasses.asdict(mdl)), N=31, device="cpu")
    return jss.starship(mdl, N=31), pt


def interior(spec, rng):
    """A strictly interior cone point (zero on the zero-cone rows): the slack
    or dual an NT scaling is taken at."""
    v = np.abs(rng.standard_normal(spec.m)) + 0.5
    off = spec.nz + spec.nl
    for d in spec.socs:
        w = rng.standard_normal(d - 1) * 0.2
        v[off] = np.linalg.norm(w) + 1.0
        v[off + 1: off + d] = w
        off += d
    v[: spec.nz] = 0.0
    return v


def with_threads(n, fn, timeout=60.0):
    """fn() under n intra-op threads, in a daemon thread with a deadline."""
    out = {}

    def run():
        prev = torch.get_num_threads()
        torch.set_num_threads(n)
        try:
            out["value"] = fn()
        finally:
            torch.set_num_threads(prev)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), f"no result after {timeout} s at {n} threads"
    return out["value"]
