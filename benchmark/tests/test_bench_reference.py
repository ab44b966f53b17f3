"""The plain reference held against the port on the CPU at a small size,
the port in float64 on its plain kernel versions: the discretization, the
subproblem's optimal value and solution, the loop's outputs, the guess."""

import pytest
import torch

from benchmark.reference.check import disc_gap, judge
from benchmark.reference.model import load
from benchmark.reference.ptr_step import RefPTR
from bench_layout import ROOT

MODELS = ROOT / "benchmark" / "reference" / "models"


def _port(which, params, N):
    from scptoolbox_torch.solvers import ptr
    if which == "double_integrator":
        from scptoolbox_torch.models.double_integrator import (
            DoubleIntegratorParameters, double_integrator)
        pbm = double_integrator(DoubleIntegratorParameters(**params))
        pars = dict(N=N, Nsub=15, wvc=1e3, wtr=5e-3, ipm_tol=1e-9,
                    ipm_max_iter=80)
    else:
        from scptoolbox_torch.models.starship_flip import (
            StarshipParameters, starship)
        pbm = starship(StarshipParameters(), N=N, device="cpu")
        pars = dict(N=N, Nsub=30, wvc=1e3, wtr=0.1, eps_abs=1e-5,
                    eps_rel=1e-4, feas_tol=5e-3, ipm_tol=1e-9,
                    ipm_max_iter=80, kkt_method="lu")
    solver = ptr.PTR(pbm, ptr.PTRParameters(**pars), dtype=torch.float64,
                     device="cpu")
    return solver, load(MODELS, which, params, N)


@pytest.mark.parametrize("which,params,N,B,iters", [
    # the benchmark's configuration: linear friction
    ("double_integrator", dict(g=0.1, s=47.0, drag=False), 31, 3, 3),
    # quadratic drag: nonlinear dynamics
    ("double_integrator", dict(g=0.01, s=30.0, drag=True), 31, 3, 3),
    ("starship_flip", {}, 15, 1, 1)])
def test_reference_matches_port(which, params, N, B, iters):
    torch.set_num_threads(2)
    solver, model = _port(which, params, N)
    p = solver.pars
    ref = RefPTR(model, N, p.Nsub, p.wvc, p.wtr, "cpu")
    gx, gu, gp = solver._guess
    assert model.check_guess(gx.numpy(), gu.numpy(), gp.numpy()) < 1e-9
    m = torch.linspace(0.99, 1.01, B, dtype=torch.float64)
    state = solver._batched_start(gx[None] * m[:, None, None],
                                  gu[None].expand(B, *gu.shape).clone(),
                                  gp[None].expand(B, *gp.shape).clone())
    for it in range(iters):
        xb, ub, pb = (state[k].clone() for k in ("x", "u", "p"))
        dl = state["dltv"]
        J_in = state["J"].clone()
        d = ref.discretize(xb, ub, pb)
        assert disc_gap(dl._asdict(), d, ref.Sx).max() < 1e-10
        solver._batched_iteration(state, it)
        tr = state["traces"][-1]
        samples = dict(
            xb=xb, ub=ub, pb=pb, J_in=J_in, x=state["x"], u=state["u"],
            p=state["p"], J_aug=tr["J_aug"],
            J_orig=solver.tmpl.original_cost(state["x"], state["u"],
                                             state["p"]),
            defect_norm=torch.amax(torch.abs(state["dltv"].defects
                                             / ref.Sx), dim=(1, 2)),
            deviation=tr["deviation"], improv_rel=tr["improv_rel"],
            it=torch.full((B,), it), stopped=state["done"].clone(),
            disc_in=dl._asdict(), disc_out=state["dltv"]._asdict())
        pars = dict(eps_abs=p.eps_abs, eps_rel=p.eps_rel,
                    feas_tol=p.feas_tol)
        numbers, detail = judge(ref, samples, pars)
        assert detail["ref_converged"] == B
        assert numbers["cost"] < 1e-7, detail
        assert numbers["step"] < 1e-6, detail
        assert detail["step.disc_in"] < 1e-10, detail
