"""The comparison that decides `correct`: a sample of the window's PTR
iterations, each judged against the reference's own iteration from the same
reference trajectory.

Two numbers, each the largest over the sample:

* `cost`: the program's J_aug against the optimal value of the reference's
  subproblem, over max(|J*|, 1);
* `step`: every other output of the step, each gap normalized so that it
  reads at round-off in a sound run: the discretization the program used
  (at the step's reference) and the one it returned (at its solution),
  against the reference's (A, Bm, Bp, F, r, each block's largest gap over
  its largest entry, and the defects over the scaling); the start of the
  batch (the guess) as the reference model checks it; the solution: how
  far the least cost of the subproblem's points within `delta` (scaled)
  of the program's (x, u, p) lies above the optimum, over max(|J*|, 1), so
  0 where an optimal point lies that near (the optimum need not be
  unique); J_orig (over max(|J|, 1)); the defect norm (over itself or
  feas_tol, whichever is larger); and 1 for a stop decision that the
  stopping rule does not take on the reference's defect norm and
  deviation and the program's own J values (decisions within 1% of a
  threshold are not judged).

A non-finite output reads inf. The deviation's and improv_rel's own gaps
are reported beside them: in float32 they carry the cancellation of
x - x_ref, and they enter only through the stop decision.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.ptr_step import F64


def _block_gap(prog, ref):
    """Largest |prog - ref| over the largest |ref|, per sample (S,)."""
    S = ref.shape[0]
    if ref[0].numel() == 0:
        return torch.zeros(S, dtype=F64, device=ref.device)
    d = (prog - ref).abs().reshape(S, -1).amax(dim=1)
    return d / ref.abs().reshape(S, -1).amax(dim=1).clamp(min=1e-12)


def disc_gap(prog, ref, Sx):
    gaps = [_block_gap(prog[k], ref[k]) for k in ("A", "Bm", "Bp", "F", "r")]
    dd = (prog["defects"] - ref["defects"]).abs() / Sx
    gaps.append(dd.reshape(dd.shape[0], -1).amax(dim=1))
    return torch.stack(gaps, 1).amax(dim=1)


def judge(ref, samples, pars, start_gap=0.0, delta=1e-4):
    """samples: dict of float64 tensors stacked over the sample (see the
    harness's recorder); pars: eps_abs, eps_rel, feas_tol. Returns
    ({number: value}, {detail: value})."""
    s = samples
    xb, ub, pb = s["xb"], s["ub"], s["pb"]
    x, u, p = s["x"], s["u"], s["p"]
    d_in = ref.discretize(xb, ub, pb)
    d_out = ref.discretize(x, u, p)
    g_in = disc_gap(s["disc_in"], d_in, ref.Sx)
    g_out = disc_gap(s["disc_out"], d_out, ref.Sx)
    Jst, ok = ref.solve(xb, ub, pb, d_in)[3:]
    finite = torch.isfinite(s["J_aug"]) & torch.isfinite(
        x.reshape(x.shape[0], -1)).all(dim=1)
    inf = torch.full_like(Jst, math.inf)
    cost = torch.where(finite, (s["J_aug"] - Jst).abs()
                       / Jst.abs().clamp(min=1.0), inf)
    # the solution: the least cost of the subproblem's points within
    # `delta` (scaled) of the program's x, u, p, above the optimum; 0 when
    # an optimal point lies that near (the optimum need not be unique)
    Jnear, ok2 = ref.solve(xb, ub, pb, d_in, near=(x, u, p),
                           delta=delta)[3:]
    sol = (Jnear - Jst) / Jst.abs().clamp(min=1.0)
    J0 = ref.original_cost(x, u, p)
    orig = (s["J_orig"] - J0).abs() / J0.abs().clamp(min=1.0)
    dnorm = torch.amax(torch.abs(d_out["defects"] / ref.Sx), dim=(1, 2))
    defect = ((s["defect_norm"] - dnorm).abs()
              / dnorm.clamp(min=pars["feas_tol"]))
    dev_r = ref.deviation(x, p, xb, pb)
    dev = (s["deviation"] - dev_r).abs() / dev_r.clamp(min=pars["eps_abs"])
    improv_r = (s["J_in"] - s["J_aug"]) / s["J_in"].abs()
    first = ~torch.isfinite(s["J_in"])
    improv = torch.where(first, torch.zeros_like(improv_r),
                         (s["improv_rel"] - improv_r).abs())
    feas_r = dnorm <= pars["feas_tol"]
    conv_r = ((improv_r.abs() <= pars["eps_rel"])
              | (dev_r <= pars["eps_abs"]))
    stop_r = (s["it"] > 0) & feas_r & conv_r & ~first
    near = lambda v, t: (v - t).abs() <= 0.01 * t
    sharp = ~(near(dnorm, pars["feas_tol"]) | near(dev_r, pars["eps_abs"])
              | near(improv_r.abs(), pars["eps_rel"]))
    miss = ((stop_r != s["stopped"]) & sharp).to(F64)
    start = torch.full_like(sol, float(start_gap))
    parts = torch.stack([g_in, g_out, start, sol, orig, defect, miss], 1)
    step = torch.where(finite, parts.amax(dim=1), inf)
    numbers = dict(cost=float(cost.max()), step=float(step.max()))
    names = ("disc_in", "disc_out", "start", "sol", "orig", "defect",
             "stop")
    detail = {f"step.{k}": float(parts[:, i].max())
              for i, k in enumerate(names)}
    detail.update({"dev": float(dev.max()), "improv": float(improv.max()),
                   "ref_converged": int((ok & ok2).sum()),
                   "samples": int(ok.numel())})
    return numbers, detail
