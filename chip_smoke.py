#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (no JAX involved).

    python3 chip_smoke.py                          # the default phases
    python3 chip_smoke.py --phases oscillator,kernels
    python3 chip_smoke.py --phases gmres,profile   # measurements on demand

Builds csrc/lu_kernels.cu, csrc/chol_kernels.cu and csrc/gj_kernels.cu with
nvcc first (one process each, side by side). Phases (a failed phase exits
non-zero; nothing is caught and passed over):
  starship: the main path, batched Starship-flip PTR (B=32, N=31, Nsub=30,
     15 SCP iterations, float32, kkt_method="staged_crpl"): every scenario
     dynamically feasible, SOLVED costs within 2% of the float64 pin, both
     LU kernels launched on that run;
  starship_f64: the same path in float64 at B=4, SOLVED costs within the
     pin's own relative 1e-3, from a guess built on the CPU as the pin's was;
  starship_f64_block: the same float64 run without kkt_method, which the
     auto policy resolves to the block-tridiagonal normal-equations sweep
     (ops/block_kkt.py) on the three Cholesky-ladder kernels;
  double_integrator_crpl: batched PTR (B=128, N=31, 6 iterations,
     "staged_crpl"), every scenario feasible, LU kernels launched;
  double_integrator_schur: bench.py's double integrator exactly (B=128,
     float32, no kkt_method: the dense Schur KKT's Cholesky ladder), every
     scenario feasible, the three Cholesky-ladder kernels launched;
  starship_serial_lu: bench.py's serial float32 Starship PTR on the dense
     augmented LU, SOLVED, feasible, cost within 2% of the pin;
  oscillator: solve_oscillator(N=30, n_hom=10) in float64, SOLVED, cost
     within 1e-3 of its pin, the deadband logic exact;
  lcvx: the LCvx double integrator (choices 1 and 2) and the rocket
     landing's golden search (N=80) in float64, IPM (almost) optimal, costs
     within 1e-4 of their pins (the rocket's: the JAX package's own cost);
  rendezvous_planar, rendezvous_3d: the two IMPULSE rendezvous models at
     their pinned configurations in float64 (planar N=20 with 5 homotopy
     rungs, 3-D N=15 with 5), SOLVED, feasible, costs within 1e-3 of their
     pins, with the template size and the KKT path the auto policy took;
  quadrotor_scvx, freeflyer_scvx, starship_scvx: serial SCvx at the
     configurations of the JAX package's three SCvx cost pins (quadrotor
     N=30, free-flyer N=30, Starship N=31 from a guess built on the CPU),
     float64, the block sweep: SOLVED, feasible, costs within 1e-3 of their
     pins, the guess projection driven apart from the SCvx loop; the
     quadrotor's keep-out zones and the free-flyer's quaternion norm held;
  quadrotor_scvx_batched: SCvx.solve_batched at B=8 on the quadrotor, all
     SOLVED and feasible, its unscaled scenario repeating the serial solve;
  quadrotor_gusto, quadrotor_gusto_softplus, quadrotor_gusto_qrchol: serial
     GuSTO on the quadrotor (N=30, Nsub=15) in float64 on the dense Schur
     KKT's Cholesky ladder: the quad penalty at the quadrotor_gusto pin's
     configuration, the softplus penalty (180 exp-cone blocks a
     subproblem) and the quad penalty on the null-space QR-Cholesky KKT;
     SOLVED, feasible, costs within the pin's 1e-3 (softplus: 1e-2 of the
     pin and 1e-3 of the JAX package's own softplus cost), keep-out values
     >= 1 - 5e-3; the guess projection driven apart from the loop;
  freeflyer_gusto_step: one GuSTO step on the free-flyer (N=30, the soft
     state set's indicators; H 1593², S 403²) from its raw guess, IPM
     (almost) optimal, L_aug and J_aug held to the JAX package's values;
  quadrotor_gusto_batched: GuSTO.solve_batched at B=8 on the quadrotor, all
     SOLVED and feasible, its unscaled scenario repeating the serial solve
     (the same iterations, eta and lambda traces);
  starship_f64_staged_lu, starship_f64_staged_qr: the starship_f64 run on
     "staged_lu" (the forward stage sweep on the LU kernels: all feasible,
     every cost within 4% of the pin, the part of the JAX package's own
     record for this run that rounding does not move; statuses and the
     stopping rule's quantities recorded) and on "staged_qr" (the band-QR
     sweep, R_k on
     solve_lower_t, the arrow on the LU kernels: 4/4 SOLVED within the
     pin's 1e-3);
  double_integrator_staged: bench.py's double integrator (B=128, float32)
     on "staged_lu" and on "staged_qr": every scenario feasible, the SOLVED
     counts recorded;
  starship_crqd_kkt: one float32 Starship subproblem batch (B=32): a
     StagedCRQD factor and FGMRES solve at a random interior W beside
     StagedCRPL's, each relative KKT residual <= 1e-4, one IPM solve on
     CRQD (status and gap recorded), and the cholesky kernel on indefinite
     blocks against the plain version's NaN;
  quadrotor_gusto_softplus_staged: the softplus quadrotor (N=30, 180 exp
     blocks) in float64 on "staged_cr", "staged_crpl" and "staged_qr"
     (their 694-wide arrow on lu_factor's grid design and lu_solve's
     cluster design), each SOLVED within 1e-3 of the JAX package's
     softplus cost; and in float32
     on the auto policy's "staged_cr" (status and cost recorded);
  conic_parser: GEOM programs (n = 2, 3, 4, 5, 7 and AM-GM) and the four
     closed-form KKT sensitivities (parser/variation.py) in float64 on the
     card, held to their closed forms;
  parallel: scenario batches over torch.distributed at bench.py's double
     integrator (B=128, float32, 10 iterations), solve_batched_collective
     on "staged_crpl" and solve_batched_sharded on the dense Schur KKT: at
     world 1 (an NCCL group on a FileStore in the worker) each equal to
     solve_batched on the same scenarios; at world 2 (two spawned gloo
     ranks, both on the one card) 128/128 feasible, equal to solve_batched
     on the batch's two halves, the collective's J_aug within a relative
     1e-4 of world 1 (the sharded Schur run's distance recorded), the
     vote's outer_iters the largest iteration count and total_iters their
     sum; the ranks' launch shapes come back through files for the
     kernels phase;
  native_ipm: the host C++ IPM (native.py, built with g++ from
     native/ipm.cpp at first use) beside the card's IPM on the parser's
     programs, the LCvx double integrator and an infeasible LP (float64):
     statuses equal, objectives within 1e-6, primal within 1e-5, duals
     within 1e-4, the LP PRIMAL_INFEASIBLE on both;
  checkpoint: a serial float64 double-integrator solve on the card saved
     with save_solution, loaded, and resumed by PTR.solve(warm=) on the
     card: the same status, the cost within a relative 1e-6;
  kernels: every kernel against its plain PyTorch version at every
     (kernel, dtype, n, K) the phases above launched it with, at the
     group's smallest and largest batch (LU: identical pivot records; all:
     within a relative 1e-4 / 1e-10 in float32 / float64), each timed
     beside its bound and the torch.linalg call; and gj_inverse, which no
     path launches, at the Starship phases' lu_factor block shapes on
     Jacobi-equilibrated quasidefinite blocks, beside torch.linalg.inv;
  rendezvous_full (not default): both rendezvous models at the reference
     configurations (planar N=30 with 10 rungs, 3-D N=25 with 10), SOLVED
     and feasible, their costs and walls recorded;
  gmres (not default): FGMRES depth of the staged KKT against IPM
     convergence on the first Starship subproblems;
  profile (not default): the main path's first SCP step split by layer on
     the host clock, and three windows of ten of its IPM loops under
     torch.profiler for the device's busy share and its busiest kernels.
The path phases run in four worker processes side by side on the card
(--workers; 1 runs them one after another in this process), shared out by
their walls in PHASE_S: the paths are host-bound, so this keeps the whole
run well inside its time limit; each phase's launch counts and shapes are
its own process's, and its wall is taken beside the other workers'. The
kernels phase runs alone afterwards. After it, each path's kernel time
(its launches x the wrapper time of each group) stands beside its wall.
Prints one JSON line with every kernel's numbers, the card's name and power
limit, and as the last line {"ok": true, "device": {...}}. Writes the full
record to chiprun_out/chip_smoke.json.
"""

import argparse
import collections
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

STARSHIP_PIN = 0.652614          # tests/reference_costs.json, float64
OSCILLATOR_PIN = 0.12862352406944982             # the same file
RENDEZVOUS_PINS = {"rendezvous_planar": 1.1827842514296785,   # the same
                   "rendezvous_3d": 1.5265367217265537}       # file
# the double integrator's two pins (the same file), and for the rocket the
# JAX package's own solve_lcvx(N=80, tol=1e-3) (tests/rocket_lcvx_reference.py
# on the CPU): the file's rocket pin, 429.60033, is no run of the package's
# (its own test's configuration, N=60 at tol 0.5, gives 439.48852)
LCVX_PINS = {"di_1": 30.482272778280244, "di_2": 16.72312696206503,
             "rocket": 429.36347460004663}
ROCKET_FILE_PIN = 429.60033408957395
SCVX_PINS = {"quadrotor_scvx": 1.2512114705769732,      # the same file
             "freeflyer_scvx": 0.3497083909142046,
             "starship_scvx": 0.7731570211473755}
GUSTO_PIN = 1.2511192739246433                   # the same file
# The JAX package's own results on the CPU in float64, for what no pin
# covers: gusto.solve(quadrotor(), GuSTOParameters(N=30, Nsub=15,
# iter_max=20, pen="softplus", hom=500.0, lam_init=1e3)) (the configuration
# of tests/test_quadrotor.py:69-70), and GuSTO(freeflyer(mdl, N=30),
# GuSTOParameters(N=30, Nsub=10))._step from the model's raw guess at
# eta_init and lam_init (tests/gusto_reference.py prints both)
GUSTO_SOFTPLUS_JAX = 1.2547460934031234
FREEFLYER_STEP_JAX = dict(L_aug=155.55242036949812, J_aug=54.11570400304041,
                          L=0.7240815778539907, rho=0.6259215654484812,
                          viol=0.3198315048201782)
PEAK_FLOPS = {"float32": 67e12,  # H100 SXM, outside the tensor cores
              "float64": 67e12}  # on the FP64 tensor cores (data sheet)
PEAK_BYTES = 3.35e12             # HBM3, bytes/s
REPO = os.path.dirname(os.path.abspath(__file__))


def log(*a):
    print(*a, flush=True)


def phase_environment(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    _precise(torch)
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    log(f"[env] card: {card}")
    return card


def _time_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def _device_ms(torch, fn, reps):
    """ms per launch on the device alone: reps launches captured in one CUDA
    graph and replayed, so that the host's time per wrapper call, which
    _time_ms includes, drops out."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    graph.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def _factor_work(nb, s, isz):
    flops = nb * (2.0 / 3.0 * s ** 3 + 0.5 * s * s)
    nbytes = nb * (2 * s * s * isz + 4 * s)
    return flops, nbytes


def _solve_work(nb, s, K, isz):
    flops = nb * 2.0 * s * s * K
    nbytes = nb * (s * s * isz + 4 * s + 2 * s * K * isz)
    return flops, nbytes


def _chol_work(nb, n, isz):
    """n^3/3 flops; the lower triangle read, the whole factor written."""
    flops = nb * n ** 3 / 3.0
    nbytes = nb * (n * (n + 1) // 2 + n * n) * isz
    return flops, nbytes


def _trisolve_work(nb, n, K, isz):
    """n^2 K flops; the triangle read, the right-hand sides read and the
    solution written."""
    flops = nb * float(n) * n * K
    nbytes = nb * (n * (n + 1) // 2 + 2 * n * K) * isz
    return flops, nbytes


def _gj_work(nb, s, isz):
    """2 s^3 flops; the block read once and its inverse written once."""
    return nb * 2.0 * s ** 3, nb * 2 * s * s * isz


def _work(kernel, nb, n, K, isz):
    if kernel == "gj_inverse":
        return _gj_work(nb, n, isz)
    if kernel == "lu_factor":
        return _factor_work(nb, n, isz)
    if kernel == "lu_solve":
        return _solve_work(nb, n, K, isz)
    if kernel == "cholesky":
        return _chol_work(nb, n, isz)
    return _trisolve_work(nb, n, K, isz)


def _bound(flops, nbytes, dtname):
    t_ops = flops / PEAK_FLOPS[dtname] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _quasidefinite(torch, nb, s, dt, gen):
    """nb Jacobi-equilibrated quasidefinite blocks [[H, A'], [A, -D]] of
    size s (H = G G' + n1 I, D positive diagonal), the blocks the staged
    KKT's Gauss-Jordan inverse was written for."""
    n1 = s // 3 + 1
    n2 = s - n1
    G = torch.randn(nb, n1, n1, generator=gen, device="cuda", dtype=dt)
    A = torch.randn(nb, n2, n1, generator=gen, device="cuda", dtype=dt)
    D = torch.rand(nb, n2, generator=gen, device="cuda", dtype=dt) + 0.1
    K = torch.zeros(nb, s, s, device="cuda", dtype=dt)
    K[:, :n1, :n1] = G @ G.mT + n1 * torch.eye(n1, device="cuda", dtype=dt)
    K[:, n1:, :n1] = A
    K[:, :n1, n1:] = A.mT
    K[:, n1:, n1:] = -torch.diag_embed(D)
    sc = torch.diagonal(K, dim1=-2, dim2=-1).abs().rsqrt()
    return K * sc[:, :, None] * sc[:, None, :]


def _kernel_case(torch, lk, ck, gk, kernel, dt, nb, n, K, gen):
    """Inputs of one kernel at (nb, n, K) on the card, with the kernel, its
    plain version and the torch.linalg call on them. The LU blocks have
    their diagonals scaled by 1e-7, the size of the KKT blocks'
    regularization pivots, so every factor pivots; the Cholesky inputs are
    M M' + n I; the Gauss-Jordan inputs equilibrated quasidefinite blocks."""
    if kernel == "gj_inverse":
        Q = _quasidefinite(torch, nb, n, dt, gen)
        return (lambda: gk.gj_inverse(Q), lambda: gk.gj_inverse_plain(Q),
                lambda: torch.linalg.inv(Q))
    M = torch.randn(nb, n, n, generator=gen, device="cuda", dtype=dt)
    B = torch.randn(nb, n, K, generator=gen, device="cuda", dtype=dt)
    if kernel in ("lu_factor", "lu_solve"):
        M.diagonal(dim1=-2, dim2=-1).mul_(1e-7)
        if kernel == "lu_factor":
            return (lambda: lk.lu_factor(M), lambda: lk.lu_factor_plain(M),
                    lambda: torch.linalg.lu_factor(M))
        fac = lk.lu_factor_plain(M)
        lib_fac = torch.linalg.lu_factor(M)
        return (lambda: lk.lu_solve(fac, B),
                lambda: lk.lu_solve_plain(fac, B),
                lambda: torch.linalg.lu_solve(*lib_fac, B))
    H = M @ M.mT + n * torch.eye(n, dtype=dt, device="cuda")
    if kernel == "cholesky":
        return (lambda: ck.cholesky(H), lambda: ck.cholesky_plain(H),
                lambda: torch.linalg.cholesky(H))
    L = ck.cholesky_plain(H)
    if kernel == "solve_lower":
        return (lambda: ck.solve_lower(L, B),
                lambda: ck.solve_lower_plain(L, B),
                lambda: torch.linalg.solve_triangular(L, B, upper=False))
    Lt = L.mT
    return (lambda: ck.solve_lower_t(L, B),
            lambda: ck.solve_lower_t_plain(L, B),
            lambda: torch.linalg.solve_triangular(Lt, B, upper=True))


def _check(torch, kernel, run, plain, tol, what):
    """max |kernel - plain| on one input; LU pivot records must be equal."""
    out, ref = run(), plain()
    torch.cuda.synchronize()
    if kernel == "lu_factor":
        assert torch.equal(out[1], ref[1]), f"pivot records differ: {what}"
        out, ref = out[0], ref[0]
    err = (out - ref).abs().max().item() if ref.numel() else 0.0
    rel = err / max(ref.abs().max().item() if ref.numel() else 1.0, 1e-300)
    assert rel <= tol, f"{what}: relative error {rel} above {tol}"
    return err


def _design(torch, lk, ck, kernel, dt, nb, n, K):
    """The design a launcher takes at (nb, n, K), as the libraries'
    chol_design and lu_design exports report it (nothing is launched);
    None for the Gauss-Jordan kernel."""
    if kernel in ("lu_factor", "lu_solve"):
        which = int(kernel == "lu_solve")
        v = lk.LIB.load().lu_design(which, nb, n, K, 8 if dt == torch.float64
                                    else 4)
        assert v >= 0, (kernel, nb, n, K, v)
        names = (("warp", "panels", "grid panels"),
                 ("panels", "rows", "clusters", "clusters of 16"))
        return names[which][v]
    which = {"cholesky": 0, "solve_lower": 1, "solve_lower_t": 2}.get(kernel)
    if which is None:
        return None
    sfx = "f32" if dt == torch.float32 else "f64"
    query = getattr(ck.LIB.load(), f"chol_design_{sfx}")
    v = query(which, nb, n, K)
    assert v >= 0, (kernel, nb, n, K, v)
    if which == 0:
        if v >= 2:
            return f"spread over {v} blocks"
        variant = query(3, nb, n, K)
        assert variant in (0, 1, 2), (kernel, nb, n, variant)
        if variant == 0 and n == 1:
            return "thread a matrix"
        return ("warp a matrix", "one block, shared memory",
                "one block, device memory")[variant]
    return ("clusters", "panels", "one block (tri_solve)",
            "wide clusters", "wide clusters of 16")[v]


def _gj_shapes(shapes_by_path):
    """gj_inverse's shapes: no path launches it, so it takes the lu_factor
    groups of the Starship phases, the CR blocks it was written for."""
    out = collections.Counter()
    for path in ("starship", "starship_f64"):
        for (kernel, suffix, nb, n, K), cnt in shapes_by_path.get(
                path, {}).items():
            if kernel == "lu_factor":
                out[("gj_inverse", suffix, nb, n, K)] += cnt
    return out


def phase_kernels(torch, lk, ck, gk, shapes_by_path):
    """Each kernel against its plain version at every shape a path gave it.
    Launches are grouped by (kernel, dtype, n, K); each group is checked at
    its smallest and largest block count nb (identical LU pivot records,
    results within a relative 1e-4 in float32 and 1e-10 in float64) and
    timed at the largest beside its bound and the torch.linalg call
    (kernel_ms through the wrapper, host time included, as every earlier
    record; device_ms on the device alone, from a CUDA graph), with the
    design the ladder launchers take at both batches.
    gj_inverse, on no path, is checked and timed the same way at the
    Starship phases' lu_factor shapes (the path "kernels"); its launches
    are the ones this phase makes."""
    assert shapes_by_path, "the kernels phase checks the shapes of a path " \
        "phase"
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = []
    for path, shapes in (*shapes_by_path.items(),
                         ("kernels", _gj_shapes(shapes_by_path))):
        groups = {}
        for (kernel, suffix, nb, n, K), cnt in shapes.items():
            groups.setdefault((kernel, suffix, n, K), {})[nb] = cnt
        for (kernel, suffix, n, K), nbs in sorted(groups.items()):
            dt = {"f32": torch.float32, "f64": torch.float64}[suffix]
            dtname = str(dt).split(".")[-1]
            tol = 1e-4 if dt == torch.float32 else 1e-10
            err = 0.0
            launched = gk.gj_inverse.launches
            for nb in sorted({min(nbs), max(nbs)}):   # timed at the last
                run, plain, lib = _kernel_case(torch, lk, ck, gk, kernel, dt,
                                               nb, n, K, gen)
                err = max(err, _check(torch, kernel, run, plain, tol,
                                      f"{path} {kernel} {dtname} "
                                      f"nb={nb} n={n} K={K}"))
            isz = torch.tensor([], dtype=dt).element_size()
            bound_ms, bound_by = _bound(*_work(kernel, nb, n, K, isz),
                                        dtname)
            # gj_inverse: the launches of its checks just above
            launches = (gk.gj_inverse.launches - launched
                        if kernel == "gj_inverse" else sum(nbs.values()))
            row = dict(path=path, kernel=kernel, dtype=dtname, n=n, K=K,
                       nb_checked=sorted({min(nbs), max(nbs)}),
                       design={b: _design(torch, lk, ck, kernel, dt, b, n, K)
                               for b in sorted({min(nbs), max(nbs)})},
                       launches=launches, max_abs_err=err,
                       kernel_ms=_time_ms(torch, run, 20),
                       device_ms=_device_ms(torch, run, 20),
                       plain_ms=_time_ms(torch, plain, 2),
                       library_ms=_time_ms(torch, lib, 20),
                       bound_ms=bound_ms, bound_by=bound_by, bound_nb=nb)
            rows.append(row)
            log("[kernels] " + json.dumps(row))
    return rows


def _scenario_batch(torch, solver, B, spread):
    gx, gu, gp = solver._guess
    scale = (1.0 + spread * (torch.arange(B, dtype=solver.dtype,
                                          device=gx.device) / B - 0.5))
    bx = gx[None] * scale[:, None, None]
    bu = gu[None].expand(B, *gu.shape).clone()
    bp = gp[None].expand(B, *gp.shape).clone()
    return bx, bu, bp


STARSHIP_PARS = dict(N=31, Nsub=30, wvc=1e3, wtr=0.1, eps_abs=1e-5,
                     eps_rel=1e-4, feas_tol=5e-3, ipm_tol=3e-6,
                     ipm_max_iter=60, kkt_method="staged_crpl")  # bench.py


def _starship_solver(torch, dtype, n_iters, guess_device="cuda", **over):
    """The Starship PTR solver on the card; its guess program runs on
    guess_device (the card: the dense Schur KKT's Cholesky ladder; the CPU:
    its LU, the path the cost pin was made on)."""
    from scptoolbox_torch.models.starship_flip import (StarshipParameters,
                                                       starship)
    from scptoolbox_torch.solvers import ptr

    pbm = starship(StarshipParameters(), N=31, device=guess_device)
    pars = dict(STARSHIP_PARS, iter_max=n_iters, **over)
    return ptr.PTR(pbm, ptr.PTRParameters(**pars), dtype=dtype,
                   device="cuda")


def _counts(lk, ck):
    return {**lk.launch_counts(), **ck.launch_counts()}


def _drive(torch, lk, ck, fn):
    """Run fn with every launch count set to 0 and the launch shapes
    recorded: (fn's result, wall s, launch counts, launch shapes)."""
    from scptoolbox_torch.ops import cuda_lib

    torch.cuda.synchronize()
    lk.reset_launch_counts()
    ck.reset_launch_counts()
    cuda_lib.launch_shapes = collections.Counter()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    shapes, cuda_lib.launch_shapes = cuda_lib.launch_shapes, None
    return out, wall, _counts(lk, ck), shapes


def _ladder_launched(launches):
    return all(launches[k] > 0 for k in ("cholesky", "solve_lower",
                                         "solve_lower_t"))


def _kkt_path(solver):
    """The KKT path a solver resolved to: its kkt_method, "block" for the
    block sweep, or "schur" for the dense Schur KKT."""
    from scptoolbox_torch.ops.block_kkt import StageStructure

    if solver._kkt_method:
        return solver._kkt_method
    builder = solver.kkt_builder
    if builder is not None and isinstance(builder.structure,
                                          StageStructure):
        return "block"
    assert builder is None, builder
    return "schur"


def _block_ipm_loops(solver, launches):
    """IPM loops (initialization solves included) of a run on the block
    sweep: each loop factors once, with one cholesky launch per stage, one
    for the arrow block and one for the equality rows' Schur complement."""
    st = solver.kkt_builder.structure
    per = st.N + int(st.ng > 0) + int(solver.spec.nz > 0)
    assert launches["cholesky"] % per == 0, (launches, per)
    return launches["cholesky"] // per


def _run_starship(torch, lk, ck, tag, dtype, B, n_iters, cost_tol,
                  guess_device="cuda", kkt_method="staged_crpl",
                  all_solved=False, status_gated=True):
    """Batched Starship PTR from B guesses spread by 2% in x: every
    scenario dynamically feasible (and SOLVED where all_solved), every
    SOLVED cost within cost_tol of the float64 pin (where not
    status_gated: no SOLVED needed, and every cost within it), the path's
    kernels
    launched on the run (the staged sweeps: both LU kernels, and for
    "staged_qr" solve_lower_t, its back-substitution; the block sweep: the
    Cholesky ladder's, one factor per IPM loop). The set-up (the guess
    program, on the card on the Cholesky ladder) is recorded apart."""
    from scptoolbox_torch.config import SCPStatus

    solver, setup_s, setup_launches, setup_shapes = _drive(
        torch, lk, ck, lambda: _starship_solver(torch, dtype, n_iters,
                                                guess_device,
                                                kkt_method=kkt_method))
    assert solver.kkt_builder is not None, "stage probe failed"
    st = solver.kkt_builder.structure
    block = kkt_method is None
    if block:
        assert _kkt_path(solver) == "block", _kkt_path(solver)
        sizes = (f"ns={st.ns} ng={st.ng} nz={solver.spec.nz} "
                 f"rmax={st.rmax} gmax={st.gmax}")
    else:
        sizes = f"s={st.ns + st.rmax} ng={st.ng} mg={st.mg}"
    log(f"[{tag}] set-up {setup_s:.1f} s: n={solver.tmpl.n} "
        f"m={solver.tmpl.m} {sizes} "
        f"launches {json.dumps(setup_launches)}")
    bx, bu, bp = _scenario_batch(torch, solver, B, 0.02)
    out, wall, launches, shapes = _drive(
        torch, lk, ck, lambda: solver.solve_batched(bx, bu, bp, n_iters))
    status = out["status"].cpu().numpy()
    feas = out["feas"].cpu().numpy()
    cost = out["J_orig"].cpu().numpy()
    solved = status == int(SCPStatus.SOLVED)
    # the batched IPM loop runs until its slowest active scenario stops,
    # plus one initialization factor per subproblem
    ipm_loops = sum(int(t["ipm_iters"].max()) + 1 for t in out["traces"])
    rec = dict(B=B, N=31, Nsub=30, n_iters=n_iters,
               dtype=str(dtype).split(".")[-1], setup_s=setup_s,
               setup_launches=setup_launches, wall_s=wall,
               solves_per_s=B / wall, solved=int(solved.sum()),
               feasible=int(feas.sum()),
               iters=out["iters"].cpu().numpy().tolist(),
               status=status.tolist(), cost=cost.tolist(),
               scp_steps=len(out["traces"]), ipm_loops=ipm_loops,
               cost_min=float(cost.min()), cost_max=float(cost.max()),
               cost_max_rel_dev=float(np.max(np.abs(cost / STARSHIP_PIN
                                                    - 1.0))),
               cost_solved_max_rel_dev=float(
                   np.max(np.abs(cost[solved] / STARSHIP_PIN - 1.0))
                   if solved.any() else float("nan")),
               launches=launches,
               launches_per_ipm_loop={k: v / ipm_loops
                                      for k, v in launches.items()})
    if B <= 4:
        # the stopping rule's quantities, an iteration a row, a scenario a
        # column (NaN once a scenario has stopped)
        rec["trace"] = {k: torch.stack([t[k] for t in out["traces"]]).to(
            torch.float64).cpu().numpy().tolist()
            for k in ("deviation", "improv_rel", "feas")}
    if block:
        rec.update(kkt="block", n=solver.tmpl.n, ns=st.ns, ng=st.ng,
                   nz=solver.spec.nz)
    log(f"[{tag}] " + json.dumps(rec))
    assert feas.all(), f"only {int(feas.sum())}/{B} scenarios feasible"
    assert solved.any() or not status_gated, "no scenario SOLVED"
    assert solved.all() or not all_solved, f"only {int(solved.sum())}/{B} " \
        "scenarios SOLVED"
    assert np.all(np.isfinite(cost)), "non-finite cost"
    assert rec["cost_solved_max_rel_dev"] <= cost_tol or not solved.any(), rec
    assert status_gated or rec["cost_max_rel_dev"] <= cost_tol, rec
    if kkt_method == "staged_qr":
        assert launches["solve_lower_t"] > 0, launches
    if block:
        assert _ladder_launched(launches), launches
        assert _block_ipm_loops(solver, launches) == ipm_loops, (
            launches, ipm_loops)
    else:
        assert launches["lu_factor"] > 0 and launches["lu_solve"] > 0, \
            launches
    return rec, {tag: shapes, f"{tag}_setup": setup_shapes}


def phase_starship(torch, lk, ck):
    """The main path: float32, B=32, SOLVED costs within 2% of the pin."""
    return _run_starship(torch, lk, ck, "starship", torch.float32, 32, 15,
                         0.02)


def phase_starship_f64(torch, lk, ck):
    """The same path in float64 on a smaller batch, held to the pin's own
    tolerance (tests/reference_costs.json: rel 1e-3). The pin was made from
    the guess that the dense KKT's LU gives; its guess program fixes the
    guess only to a few percent, and the JAX package's own PTR from the
    Cholesky ladder's guess ends 1.5e-3 from the pin
    (tests/starship_ladder_reference.py). So this phase builds its guess on
    the CPU, as the pin was made; PTR runs on the card."""
    return _run_starship(torch, lk, ck, "starship_f64", torch.float64, 4,
                         15, 1e-3, guess_device="cpu")


def phase_starship_f64_block(torch, lk, ck):
    """The float64 run of starship_f64 without kkt_method: the auto policy
    takes the block sweep at n >= 600 in float64, as the JAX package's does
    (the path its Starship pin was made on)."""
    return _run_starship(torch, lk, ck, "starship_f64_block", torch.float64,
                         4, 15, 1e-3, guess_device="cpu", kkt_method=None)


def phase_starship_f64_staged_lu(torch, lk, ck):
    """The starship_f64 run on kkt_method="staged_lu": the forward stage
    sweep, its 31 stage LUs (158²), their E_k/F_k solves (K = s + nb = 303)
    and the border LU (145²) on the LU kernels. The LU sweep's unpivoted
    Schur chain loses digits on this template, in both packages: their
    first subproblems' steps (trace "deviation", iteration 0) miss the
    accurate sweeps' by up to 17% in different directions, and a 1e-12
    nudge of the guesses moves the JAX package's own by up to 9%
    (tests/staged_reference.py ptr_lu: all four FAILED at the 15-iteration
    limit; ptr_lu_nudged: two SOLVED, two FAILED; all feasible, costs
    1.7-3.1% below the pin). Which scenarios meet the stopping rule
    (|improv_rel| <= 1e-4 at a feasible iterate, while it wanders over
    1e-5..1e-2) is then chance. So the gate is the record's robust part:
    every scenario feasible and every cost within 4% of the pin; statuses
    and the stopping rule's quantities are recorded."""
    return _run_starship(torch, lk, ck, "starship_f64_staged_lu",
                         torch.float64, 4, 15, 0.04, guess_device="cpu",
                         kkt_method="staged_lu", status_gated=False)


def phase_starship_f64_staged_qr(torch, lk, ck):
    """The starship_f64 run on kkt_method="staged_qr": one QR a stage of the
    (316, 158) band stack (torch.linalg.qr), the back-substitution with R_k
    on solve_lower_t, the arrow's Schur complement on the LU kernels; 4/4
    SOLVED within the pin's 1e-3."""
    return _run_starship(torch, lk, ck, "starship_f64_staged_qr",
                         torch.float64, 4, 15, 1e-3, guess_device="cpu",
                         kkt_method="staged_qr", all_solved=True)


DI_PARS = dict(N=31, Nsub=15, wvc=1e3, wtr=5e-3, ipm_tol=3e-6,
               ipm_max_iter=30)                             # bench.py:33-36


def _run_double_integrator(torch, lk, ck, tag, kkt_method, B=128,
                           n_iters=6):
    from scptoolbox_torch.config import SCPStatus
    from scptoolbox_torch.models.double_integrator import (
        DoubleIntegratorParameters, double_integrator)
    from scptoolbox_torch.solvers import ptr

    pbm = double_integrator(DoubleIntegratorParameters(drag=True, g=0.01,
                                                       s=30.0))
    pars = ptr.PTRParameters(**DI_PARS, kkt_method=kkt_method)
    solver = ptr.PTR(pbm, pars, dtype=torch.float32, device="cuda")
    bx, bu, bp = _scenario_batch(torch, solver, B, 0.1)
    out, wall, launches, shapes = _drive(
        torch, lk, ck, lambda: solver.solve_batched(bx, bu, bp, n_iters))
    feas = out["feas"].cpu().numpy()
    cost = out["J_orig"].cpu().numpy()
    ipm_per_step = [int(t["ipm_iters"].max()) + 1 for t in out["traces"]]
    rec = dict(B=B, N=31, n_iters=n_iters, dtype="float32",
               kkt=solver._kkt_method or "schur", n=solver.tmpl.n,
               m=solver.tmpl.m, nz=solver.spec.nz, wall_s=wall,
               solves_per_s=B / wall, feasible=int(feas.sum()),
               solved=int((out["status"] == int(SCPStatus.SOLVED)).sum()),
               cost_min=float(cost.min()), cost_max=float(cost.max()),
               scp_steps=len(out["traces"]),
               ipm_loops_per_scp_step=ipm_per_step, launches=launches)
    log(f"[{tag}] " + json.dumps(rec))
    assert feas.all(), f"only {int(feas.sum())}/{B} scenarios feasible"
    assert np.all(np.isfinite(cost)), "non-finite cost"
    return rec, {tag: shapes}, solver, launches


def phase_double_integrator_crpl(torch, lk, ck):
    """B=128 on the staged CR KKT: the LU kernels at small blocks."""
    rec, shapes, solver, launches = _run_double_integrator(
        torch, lk, ck, "double_integrator_crpl", "staged_crpl")
    assert solver.kkt_builder is not None, "staged probe failed"
    assert launches["lu_factor"] > 0 and launches["lu_solve"] > 0, launches
    return rec, shapes


def phase_double_integrator_staged(torch, lk, ck):
    """bench.py's double integrator (B=128, float32) on "staged_lu", then on
    "staged_qr": every scenario feasible, the SOLVED counts recorded (beside
    double_integrator_crpl's), the sweeps' kernels launched."""
    rec, shapes = {}, {}
    for method in ("staged_lu", "staged_qr"):
        # the record's sub-key and the shapes' path agree (_path_launches)
        sub = method.split("_")[1]
        r, shp, solver, launches = _run_double_integrator(
            torch, lk, ck, f"double_integrator_staged_{sub}", method)
        assert solver.kkt_builder is not None, "staged probe failed"
        assert launches["lu_factor"] > 0 and launches["lu_solve"] > 0, \
            launches
        if method == "staged_qr":
            assert launches["solve_lower_t"] > 0, launches
        rec[sub] = r
        shapes.update(shp)
    return rec, shapes


def phase_double_integrator_schur(torch, lk, ck):
    """bench.py's headline configuration: no kkt_method, which resolves to
    the dense Schur KKT and on the card to its Cholesky ladder."""
    rec, shapes, solver, launches = _run_double_integrator(
        torch, lk, ck, "double_integrator_schur", None)
    assert solver._kkt_method is None and solver.kkt_builder is None
    assert _ladder_launched(launches), launches
    return rec, shapes


def phase_starship_serial_lu(torch, lk, ck):
    """bench.py:59-83: serial float32 PTR on the dense augmented LU."""
    from scptoolbox_torch.config import SCPStatus

    solver, setup_s, setup_launches, setup_shapes = _drive(
        torch, lk, ck, lambda: _starship_solver(torch, torch.float32, 15,
                                                kkt_method="lu"))
    sol, wall, launches, shapes = _drive(torch, lk, ck, solver.solve)
    rec = dict(N=31, Nsub=30, iter_max=15, dtype="float32", kkt="lu",
               setup_s=setup_s, setup_launches=setup_launches, wall_s=wall,
               status=str(sol.status), feasible=bool(sol.feas),
               iterations=sol.iterations, cost=sol.cost,
               cost_rel_dev=abs(sol.cost / STARSHIP_PIN - 1.0),
               ipm_iters=[h.ipm_iters for h in sol.history],
               launches=launches)
    log("[starship_serial_lu] " + json.dumps(rec))
    assert sol.status == SCPStatus.SOLVED and sol.feas, rec
    assert rec["cost_rel_dev"] <= 0.02, rec
    return rec, {"starship_serial_lu": shapes,
                 "starship_serial_lu_setup": setup_shapes}


def phase_oscillator(torch, lk, ck):
    """solve_oscillator(N=30, n_hom=10) in float64: SOLVED, the pinned cost
    within its relative 1e-3, the deadband logic exact at the last rung
    (tests/test_oscillator.py)."""
    from scptoolbox_torch.config import SCPStatus
    from scptoolbox_torch.models.oscillator import (OscillatorParameters,
                                                    solve_oscillator)

    sol, wall, launches, shapes = _drive(torch, lk, ck, lambda:
                                         solve_oscillator(
                                             N=30, n_hom=10,
                                             dtype=torch.float64))
    mdl = OscillatorParameters()
    aa, ar = sol.ud[:, 0], sol.ud[:, 1]
    inside = np.abs(ar) < mdl.a_db
    rec = dict(N=30, n_hom=10, dtype="float64", wall_s=wall,
               status=str(sol.status), iterations=sol.iterations,
               cost=sol.cost, cost_rel_dev=abs(sol.cost / OSCILLATOR_PIN
                                               - 1.0),
               deadband_inside_max=float(np.abs(aa[inside]).max()
                                         if inside.any() else 0.0),
               deadband_outside_max=float(np.abs((aa - ar)[~inside]).max()
                                          if (~inside).any() else 0.0),
               launches=launches)
    log("[oscillator] " + json.dumps(rec))
    assert sol.status == SCPStatus.SOLVED, rec
    assert rec["cost_rel_dev"] <= 1e-3, rec
    assert rec["deadband_inside_max"] <= 1e-6, rec
    assert rec["deadband_outside_max"] <= 1e-6, rec
    assert np.abs(aa).max() <= mdl.a_max + 1e-8, rec
    assert _ladder_launched(launches), launches
    return rec, {"oscillator": shapes}


def phase_lcvx(torch, lk, ck):
    """The two LCvx programs in float64: the double integrator at both
    parameter choices, and the rocket landing's golden search over the
    flight time (N=80); IPM OPTIMAL or ALMOST_OPTIMAL, costs within a
    relative 1e-4 of their pins."""
    from scptoolbox_torch.models import double_integrator_lcvx as dil
    from scptoolbox_torch.models import rocket_landing as rl
    from scptoolbox_torch.ops.ipm import IPMStatus

    ok = (int(IPMStatus.OPTIMAL), int(IPMStatus.ALMOST_OPTIMAL))
    runs = {
        "di_1": lambda: dil.solve_lcvx(dil.LCvxDoubleIntegratorParameters(
            choice=1), dtype=torch.float64),
        "di_2": lambda: dil.solve_lcvx(dil.LCvxDoubleIntegratorParameters(
            choice=2), dtype=torch.float64),
        "rocket": lambda: rl.solve_lcvx(rl.Rocket(), N=80,
                                        dtype=torch.float64)}
    rec, shapes = {}, {}
    for name, fn in runs.items():
        sol, wall, launches, shp = _drive(torch, lk, ck, fn)
        r = dict(wall_s=wall, status=int(sol.status), cost=sol.cost,
                 cost_rel_dev=abs(sol.cost / LCVX_PINS[name] - 1.0),
                 launches=launches)
        if name == "rocket":
            r["tf"] = float(sol.t[-1])
            r["file_pin_rel_dev"] = abs(sol.cost / ROCKET_FILE_PIN - 1.0)
        log(f"[lcvx] {name} " + json.dumps(r))
        assert sol.status in ok, (name, r)
        assert r["cost_rel_dev"] <= 1e-4, (name, r)
        assert _ladder_launched(launches), (name, launches)
        rec[name] = r
        shapes[f"lcvx_{name}"] = shp
    return rec, shapes


def _rendezvous(torch, model, N, rungs):
    """(a solver built for inspection, the solve) of the planar or the 3-D
    rendezvous model at N nodes and `rungs` homotopy rungs, float64 on the
    card."""
    from importlib import import_module

    from scptoolbox_torch.ops.discretize import DiscretizationType
    from scptoolbox_torch.solvers import ptr

    # the models package re-exports functions under the module names
    r3 = import_module("scptoolbox_torch.models.rendezvous_3d")
    rp = import_module("scptoolbox_torch.models.rendezvous_planar")
    pars = ptr.PTRParameters(N=N, Nsub=10,
                             disc_method=DiscretizationType.IMPULSE)
    f64 = dict(dtype=torch.float64)
    if model == "planar":
        return (lambda: ptr.PTR(rp.rendezvous_planar(), pars, device="cuda",
                                **f64),
                lambda: rp.solve_rendezvous_planar(N=N, n_hom=rungs, **f64))
    mdl = r3.Rendezvous3DParameters(hom_steps=rungs)
    return (lambda: ptr.PTR(r3.rendezvous_3d(mdl, N), pars, device="cuda",
                            **f64),
            lambda: r3.solve_rendezvous_3d(N=N, mdl=mdl, **f64))


def _run_rendezvous(torch, lk, ck, tag, inspect, solve, pin=None):
    """One rendezvous solve: SOLVED and feasible, the cost within 1e-3 of
    the pin where there is one; the template size and the KKT path the auto
    policy took come from a solver built for inspection, outside the driven
    run."""
    from scptoolbox_torch.config import SCPStatus

    solver = inspect()
    path = _kkt_path(solver)
    sol, wall, launches, shapes = _drive(torch, lk, ck, solve)
    rec = dict(N=solver.pars.N, n=solver.tmpl.n, m=solver.tmpl.m,
               nz=solver.spec.nz, kkt=path, dtype="float64", wall_s=wall,
               status=str(sol.status), feasible=bool(sol.feas),
               iterations=sol.iterations, cost=sol.cost,
               history=[dict(J_aug=h.J_aug, improv_rel=h.improv_rel,
                             ipm_iters=h.ipm_iters, ipm_status=h.ipm_status,
                             feas=h.feas) for h in sol.history],
               launches=launches)
    if path == "block":
        st = solver.kkt_builder.structure
        loops = _block_ipm_loops(solver, launches)
        rec.update(ns=st.ns, ng=st.ng, ipm_loops=loops,
                   launches_per_ipm_loop={
                       k: v / loops if loops else math.nan
                       for k, v in launches.items()})
    if pin is not None:
        rec["cost_rel_dev"] = abs(sol.cost / pin - 1.0)
    log(f"[{tag}] " + json.dumps(rec))
    assert sol.status == SCPStatus.SOLVED and sol.feas, rec
    assert pin is None or rec["cost_rel_dev"] <= 1e-3, rec
    assert np.isfinite(sol.cost), rec
    assert _ladder_launched(launches), launches
    return rec, shapes


def phase_rendezvous_planar(torch, lk, ck):
    """solve_rendezvous_planar(N=20, n_hom=5) in float64, the configuration
    of its pin (tests/test_rendezvous_planar.py)."""
    rec, shapes = _run_rendezvous(torch, lk, ck, "rendezvous_planar",
                                  *_rendezvous(torch, "planar", 20, 5),
                                  RENDEZVOUS_PINS["rendezvous_planar"])
    return rec, {"rendezvous_planar": shapes}


def phase_rendezvous_3d(torch, lk, ck):
    """solve_rendezvous_3d(N=15, hom_steps=5) in float64, the configuration
    of its pin (tests/test_rendezvous_3d.py)."""
    rec, shapes = _run_rendezvous(torch, lk, ck, "rendezvous_3d",
                                  *_rendezvous(torch, "3d", 15, 5),
                                  RENDEZVOUS_PINS["rendezvous_3d"])
    return rec, {"rendezvous_3d": shapes}


def phase_rendezvous_full(torch, lk, ck):
    """Both models at the reference configurations (planar N=30 with 10
    rungs, 3-D N=25 with 10; reference tests.jl), which no pin covers:
    SOLVED and feasible, cost and wall recorded. Not a default phase."""
    rec, shapes = {}, {}
    for name, N in (("planar", 30), ("3d", 25)):
        rec[name], shapes[f"rendezvous_full_{name}"] = _run_rendezvous(
            torch, lk, ck, f"rendezvous_full {name}",
            *_rendezvous(torch, name, N, 10))
    return rec, shapes


# the JAX package's SCvx tests: tests/test_quadrotor.py:22-26,
# tests/test_freeflyer.py:23-32, tests/test_starship.py:75-89
SCVX_PARS = {
    "quadrotor_scvx": dict(N=30, Nsub=15, lam=30.0, iter_max=15),
    "freeflyer_scvx": dict(N=30, Nsub=10, lam=1e3, iter_max=30, eta_lb=1e-6,
                           eps_abs=1e-5, eps_rel=1e-4, feas_tol=1e-3),
    "starship_scvx": dict(N=31, Nsub=30, iter_max=100, lam=5e2, eta_init=1.0,
                          eta_lb=1e-8, eps_abs=1e-5, eps_rel=1e-4,
                          feas_tol=5e-3)}


def _scvx_problem(tag):
    """The problem of an SCvx phase (the Starship's guess built on the CPU,
    as starship_f64 builds it)."""
    from scptoolbox_torch.models.freeflyer import freeflyer
    from scptoolbox_torch.models.quadrotor import quadrotor
    from scptoolbox_torch.models.starship_flip import starship

    return {"quadrotor_scvx": lambda: quadrotor(),
            "freeflyer_scvx": lambda: freeflyer(N=30),
            "starship_scvx": lambda: starship(N=31, device="cpu")}[tag]()


def _scvx_setup(torch, lk, ck, tag, **over):
    """(solver, record, shapes, projected guess or None) of an SCvx phase's
    set-up, float64 on the card: the constructor (the LP auto-scaling, the
    block sweep's probe), then the guess projection, each driven on its own
    so that the dense ladder launches of the projection's program stay out
    of the SCvx loop's count."""
    from scptoolbox_torch.solvers import scvx
    from scptoolbox_torch.solvers.projection import project_convex

    solver, setup_s, setup_launches, setup_shapes = _drive(
        torch, lk, ck, lambda: scvx.SCvx(
            _scvx_problem(tag), scvx.SCvxParameters(**SCVX_PARS[tag], **over),
            dtype=torch.float64, device="cuda"))
    assert _kkt_path(solver) == "block", _kkt_path(solver)
    st = solver.kkt_builder.structure
    rec = dict(kkt="block", n=solver.tmpl.n, m=solver.tmpl.m,
               nz=solver.spec.nz, ns=st.ns, ng=st.ng, rmax=st.rmax,
               gmax=st.gmax, dtype="float64", setup_s=setup_s,
               setup_launches=setup_launches)
    shapes = {f"{tag}_setup": setup_shapes}
    guess = None
    if solver.pars.project_guess:
        guess, proj_s, proj_launches, shapes[f"{tag}_projection"] = _drive(
            torch, lk, ck, lambda: project_convex(
                solver.pbm, solver.scaling, *solver._guess,
                t_grid=solver.t_np, dtype=torch.float64, device="cuda"))
        rec["projection"] = dict(wall_s=proj_s, launches=proj_launches,
                                 moved=float(max(
                                     (a - b).abs().max() for a, b in
                                     zip(guess, solver._guess))))
        assert _ladder_launched(proj_launches), proj_launches
    log(f"[{tag}] set-up {setup_s:.1f} s: " + json.dumps(rec))
    return solver, rec, shapes, guess


def _scvx_history(sol):
    return [dict(J_aug=h.J_aug, rho=h.extras["rho"], eta=h.extras["eta"],
                 accept=not h.extras["reject"], ipm_iters=h.ipm_iters,
                 ipm_status=h.ipm_status, feas=h.feas) for h in sol.history]


def _run_scvx(torch, lk, ck, tag):
    """One serial SCvx solve at the configuration of a cost pin, float64 on
    the card on the block sweep: SOLVED, feasible, the cost within the
    pin's relative 1e-3, the three ladder kernels launched, and one
    cholesky pass (N + 2 launches) for every IPM loop the history counts.
    The loop starts from the projected guess (solve(warm=) with the set-up's
    projection, which is what solve() computes first)."""
    from scptoolbox_torch.config import SCPStatus
    from scptoolbox_torch.solvers.solution import SCPSolution

    solver, rec, shapes, guess = _scvx_setup(torch, lk, ck, tag)
    x, u, p = (a.cpu().numpy() for a in guess)
    warm = SCPSolution(status=SCPStatus.FAILED, algorithm="projection",
                       iterations=0, xd=x, ud=u, p=p, cost=math.nan,
                       t_grid=solver.t_np, feas=False)
    sol, wall, launches, shapes[tag] = _drive(
        torch, lk, ck, lambda: solver.solve(warm=warm))
    loops = _block_ipm_loops(solver, launches)
    rec.update(wall_s=wall, status=str(sol.status), feasible=bool(sol.feas),
               iterations=sol.iterations, cost=sol.cost,
               cost_rel_dev=abs(sol.cost / SCVX_PINS[tag] - 1.0),
               history=_scvx_history(sol), ipm_loops=loops,
               launches=launches,
               launches_per_ipm_loop={k: v / loops
                                      for k, v in launches.items()})
    log(f"[{tag}] " + json.dumps(rec))
    assert sol.status == SCPStatus.SOLVED and sol.feas, rec
    assert rec["cost_rel_dev"] <= 1e-3, rec
    assert _ladder_launched(launches), launches
    assert loops == sum(h.ipm_iters + 1 for h in sol.history), (
        loops, rec["history"])
    return rec, shapes, sol


def _keep_out(torch, xd):
    """The smallest value of each quadrotor keep-out ellipsoid over the
    nodes of xd (>= 1 outside)."""
    from scptoolbox_torch.models.quadrotor import QuadrotorParameters

    return [min(float(E(torch.as_tensor(r))) for r in xd[:, :3])
            for E in QuadrotorParameters().obstacles()]


def phase_quadrotor_scvx(torch, lk, ck):
    """scvx.solve(quadrotor(), N=30, Nsub=15, lam=30, iter_max=15): the
    quadrotor_scvx pin, and both keep-out values >= 1 - 1e-5 at every
    node."""
    rec, shapes, sol = _run_scvx(torch, lk, ck, "quadrotor_scvx")
    keep = _keep_out(torch, sol.xd)
    rec["keep_out_min"] = keep
    log(f"[quadrotor_scvx] keep-out minima {keep}")
    assert min(keep) >= 1.0 - 1e-5, keep
    return rec, shapes


def phase_freeflyer_scvx(torch, lk, ck):
    """freeflyer(N=30) under tests/test_freeflyer.py's SCvx configuration:
    the freeflyer_scvx pin, the quaternion's norm within 1e-3 of 1 at the
    nodes and within 1e-6 on the replay, and the sweep's arrow (234 columns)
    and equality block (403 rows) as the JAX package's template has them."""
    rec, shapes, sol = _run_scvx(torch, lk, ck, "freeflyer_scvx")
    qn = np.linalg.norm(sol.xd[:, 6:10], axis=1)
    qc = np.linalg.norm(sol.x_cont[:, 6:10], axis=1)
    rec.update(q_norm_node_dev=float(np.abs(qn - 1.0).max()),
               q_norm_replay_dev=float(np.abs(qc - 1.0).max()))
    log(f"[freeflyer_scvx] quaternion norm deviation: nodes "
        f"{rec['q_norm_node_dev']:.3e}, replay {rec['q_norm_replay_dev']:.3e}")
    assert rec["q_norm_node_dev"] <= 1e-3, rec
    assert rec["q_norm_replay_dev"] <= 1e-6, rec
    assert (rec["ng"], rec["nz"]) == (234, 403), rec
    return rec, shapes


def phase_starship_scvx(torch, lk, ck):
    """starship(N=31) under tests/test_starship.py's SCvx configuration (up
    to 100 iterations), its guess built on the CPU: the starship_scvx
    pin."""
    rec, shapes, _ = _run_scvx(torch, lk, ck, "starship_scvx")
    return rec, shapes


def phase_quadrotor_scvx_batched(torch, lk, ck, B=8):
    """SCvx.solve_batched at B=8 on the quadrotor from _scenario_batch's
    guesses (2% spread; scenario B/2 is the guess itself), not projected:
    all SOLVED and feasible, the sweep's kernels at nb 8 -> 1 as scenarios
    freeze. The unscaled scenario repeats the serial solve from the same
    guess (driven apart): the same iterations and eta trace, each
    iteration's J_aug to 1e-6 relative (tests/test_batched.py:81)."""
    from scptoolbox_torch.config import SCPStatus

    tag = "quadrotor_scvx_batched"
    solver, rec, shapes, _ = _scvx_setup(torch, lk, ck, "quadrotor_scvx",
                                         project_guess=False)
    shapes = {f"{tag}_setup": shapes["quadrotor_scvx_setup"]}
    bx, bu, bp = _scenario_batch(torch, solver, B, 0.02)
    k = B // 2
    assert torch.equal(bx[k], solver._guess[0])
    n_iters = solver.pars.iter_max
    out, wall, launches, shapes[tag] = _drive(
        torch, lk, ck, lambda: solver.solve_batched(bx, bu, bp, n_iters))
    serial, serial_s, _, _ = _drive(torch, lk, ck, solver.solve)
    status = out["status"].cpu().numpy()
    feas = out["feas"].cpu().numpy()
    cost = out["J_orig"].cpu().numpy()
    loops = sum(int(t["ipm_iters"].max()) + 1 for t in out["traces"])
    col = lambda key: [float(t[key][k]) for t in out["traces"]
                       if bool(t["active"][k])]
    J_dev = max(abs(a / h.J_aug - 1.0) for a, h in zip(col("J_aug"),
                                                       serial.history))
    rec.update(B=B, wall_s=wall, solves_per_s=B / wall,
               solved=int((status == int(SCPStatus.SOLVED)).sum()),
               feasible=int(feas.sum()),
               iters=out["iters"].cpu().numpy().tolist(),
               scp_steps=len(out["traces"]), ipm_loops=loops,
               active=[int(t["active"].sum()) for t in out["traces"]],
               cost_min=float(cost.min()), cost_max=float(cost.max()),
               serial=dict(wall_s=serial_s, iterations=serial.iterations,
                           cost=serial.cost, history=_scvx_history(serial)),
               unscaled_eta=col("eta"), unscaled_J_aug_max_rel_dev=J_dev,
               launches=launches,
               launches_per_ipm_loop={k_: v / loops
                                      for k_, v in launches.items()})
    log(f"[{tag}] " + json.dumps(rec))
    assert (status == int(SCPStatus.SOLVED)).all(), rec
    assert feas.all(), rec
    assert _ladder_launched(launches), launches
    assert _block_ipm_loops(solver, launches) == loops, (launches, loops)
    assert int(out["iters"][k]) == serial.iterations, rec
    assert col("eta") == [h.extras["eta"] for h in serial.history], rec
    assert J_dev <= 1e-6, rec
    return rec, shapes


# tests/test_quadrotor.py:30-33 (the quadrotor_gusto pin) and :69-70
GUSTO_PARS = {
    "quadrotor_gusto": dict(N=30, Nsub=15, iter_max=15),
    "quadrotor_gusto_softplus": dict(N=30, Nsub=15, iter_max=20,
                                     pen="softplus", hom=500.0, lam_init=1e3),
    "quadrotor_gusto_qrchol": dict(N=30, Nsub=15, iter_max=15,
                                   kkt_method="qrchol")}


def _gusto_setup(torch, lk, ck, tag, pbm, pars, project=True, dtype=None):
    """(solver, record, shapes, projected guess or None) of a GuSTO phase's
    set-up, float64 on the card unless `dtype` says otherwise: the
    constructor, then the guess projection on its own, so that its ladder
    launches stay out of the loop's count."""
    from scptoolbox_torch.solvers import gusto
    from scptoolbox_torch.solvers.projection import project_convex

    dtype = dtype or torch.float64
    solver, setup_s, setup_launches, setup_shapes = _drive(
        torch, lk, ck, lambda: gusto.GuSTO(pbm, gusto.GuSTOParameters(**pars),
                                           dtype=dtype, device="cuda"))
    rec = dict(kkt=_kkt_path(solver), n=solver.tmpl.n, m=solver.tmpl.m,
               nz=solver.spec.nz, nexp=solver.spec.nexp,
               n_qX=solver.n_qX, dtype=str(dtype).split(".")[-1],
               setup_s=setup_s, setup_launches=setup_launches)
    shapes = {f"{tag}_setup": setup_shapes}
    guess = None
    if project:
        guess, proj_s, proj_launches, shapes[f"{tag}_projection"] = _drive(
            torch, lk, ck, lambda: project_convex(
                solver.pbm, solver.scaling, *solver._guess,
                t_grid=solver.t_np, dtype=dtype, device="cuda"))
        rec["projection"] = dict(wall_s=proj_s, launches=proj_launches)
        assert _ladder_launched(proj_launches), proj_launches
    log(f"[{tag}] set-up {setup_s:.1f} s: " + json.dumps(rec))
    return solver, rec, shapes, guess


def _gusto_history(sol):
    return [dict(J_aug=h.J_aug, J=h.J_orig, rho=h.extras["rho"],
                 eta=h.extras["eta"], lam=h.extras["lam"],
                 accept=not h.extras["reject"], ipm_iters=h.ipm_iters,
                 ipm_status=h.ipm_status, feas=h.feas,
                 defect=h.defect_norm) for h in sol.history]


def _ladder_loops(solver, launches):
    """IPM loops of a run on a dense ladder, from its cholesky launches:
    two a loop on the dense Schur KKT (H and the equality rows' S), one on
    the QR-Cholesky KKT (the reduced normal matrix)."""
    per = {"schur": 2, "qrchol": 1}[_kkt_path(solver)]
    assert launches["cholesky"] % per == 0, (launches, per)
    return launches["cholesky"] // per


def _run_gusto(torch, lk, ck, tag, kkt):
    """One serial GuSTO solve of the quadrotor in float64 on the card from
    the projected guess (solve(warm=) with the set-up's projection):
    SOLVED, feasible, keep-out values >= 1 - 5e-3 at every node (the JAX
    test's obstacle_tol, tests/test_quadrotor.py:78), the KKT path `kkt`
    with its ladder kernels launched, one factor for every IPM loop the
    history counts."""
    from scptoolbox_torch.config import SCPStatus
    from scptoolbox_torch.models.quadrotor import quadrotor
    from scptoolbox_torch.solvers.solution import SCPSolution

    solver, rec, shapes, guess = _gusto_setup(torch, lk, ck, tag,
                                              quadrotor(), GUSTO_PARS[tag])
    assert rec["kkt"] == kkt, rec
    x, u, p = (a.cpu().numpy() for a in guess)
    warm = SCPSolution(status=SCPStatus.FAILED, algorithm="projection",
                       iterations=0, xd=x, ud=u, p=p, cost=math.nan,
                       t_grid=solver.t_np, feas=False)
    sol, wall, launches, shapes[tag] = _drive(
        torch, lk, ck, lambda: solver.solve(warm=warm))
    loops = _ladder_loops(solver, launches)
    keep = _keep_out(torch, sol.xd)
    rec.update(wall_s=wall, status=str(sol.status), feasible=bool(sol.feas),
               iterations=sol.iterations, cost=sol.cost,
               cost_rel_dev=abs(sol.cost / GUSTO_PIN - 1.0),
               keep_out_min=keep, history=_gusto_history(sol),
               ipm_loops=loops, launches=launches,
               launches_per_ipm_loop={k: v / loops
                                      for k, v in launches.items()})
    log(f"[{tag}] " + json.dumps(rec))
    assert sol.status == SCPStatus.SOLVED and sol.feas, rec
    assert min(keep) >= 1.0 - 5e-3, keep
    assert _ladder_launched(launches), launches
    assert loops == sum(h.ipm_iters + 1 for h in sol.history), (
        loops, rec["history"])
    return rec, shapes


def phase_quadrotor_gusto(torch, lk, ck):
    """gusto.solve(quadrotor(), N=30, Nsub=15, iter_max=15): the
    quadrotor_gusto pin's configuration, on the dense Schur ladder (n=483
    < 600), the cost within the pin's relative 1e-3."""
    rec, shapes = _run_gusto(torch, lk, ck, "quadrotor_gusto", "schur")
    assert rec["cost_rel_dev"] <= 1e-3, rec
    return rec, shapes


def phase_quadrotor_gusto_softplus(torch, lk, ck):
    """The softplus penalty (tests/test_quadrotor.py:69-70): 180 exp blocks
    a subproblem, n=752 >= 600 in float64 but the dense Schur ladder (the
    block sweep takes no exp cones); the cost within 1e-2 of the
    quadrotor_gusto pin (the JAX test's gate) and 1e-3 of the JAX package's
    own softplus cost."""
    rec, shapes = _run_gusto(torch, lk, ck, "quadrotor_gusto_softplus",
                             "schur")
    rec["cost_rel_dev_jax"] = abs(rec["cost"] / GUSTO_SOFTPLUS_JAX - 1.0)
    log("[quadrotor_gusto_softplus] cost against the JAX package's: "
        f"{rec['cost_rel_dev_jax']:.3e}, IPM statuses "
        f"{[h['ipm_status'] for h in rec['history']]}")
    assert rec["nexp"] == 180, rec
    assert rec["cost_rel_dev"] <= 1e-2, rec
    assert rec["cost_rel_dev_jax"] <= 1e-3, rec
    return rec, shapes


def phase_quadrotor_gusto_qrchol(torch, lk, ck):
    """The quadrotor_gusto configuration on kkt_method="qrchol": the reduced
    (n - nz)² normal matrix on the ladder, both solves with R on the
    triangular kernels; the cost within the pin's 1e-3."""
    rec, shapes = _run_gusto(torch, lk, ck, "quadrotor_gusto_qrchol",
                             "qrchol")
    log("[quadrotor_gusto_qrchol] IPM statuses "
        f"{[h['ipm_status'] for h in rec['history']]}")
    assert rec["cost_rel_dev"] <= 1e-3, rec
    return rec, shapes


def phase_freeflyer_gusto_step(torch, lk, ck):
    """One GuSTO step on the free-flyer (N=30, Nsub=10, the quad penalty,
    the soft state set's 10 indicator slots a node) from the model's raw
    guess at eta_init and lam_init, the step the serial solve takes, on the
    dense Schur ladder (H 1593², S 403²): IPM OPTIMAL or ALMOST_OPTIMAL,
    L_aug within 1e-6 and J_aug within 1e-5 relative of the JAX package's
    values for the same step."""
    from scptoolbox_torch.models.freeflyer import freeflyer
    from scptoolbox_torch.ops.ipm import IPMStatus

    tag = "freeflyer_gusto_step"
    solver, rec, shapes, _ = _gusto_setup(
        torch, lk, ck, tag, freeflyer(N=30), dict(N=30, Nsub=10),
        project=False)
    assert rec["kkt"] == "schur", rec
    T1 = lambda v: torch.full((1,), v, dtype=torch.float64, device="cuda")
    pars = solver.pars
    ref = tuple(a[None] for a in solver._guess)

    def step():
        _, dltv = solver._ref_J_aug_impl(*ref, T1(pars.lam_init),
                                         solver.consts)
        return solver._step_impl(*ref, dltv, T1(pars.eta_init),
                                 T1(pars.lam_init), solver.consts)

    out, wall, launches, shapes[tag] = _drive(torch, lk, ck, step)
    loops = _ladder_loops(solver, launches)
    got = {k: float(out[k][0]) for k in ("L_aug", "J_aug", "L", "rho",
                                         "viol", "defect_norm")}
    dev = {k: abs(got[k] / v - 1.0) for k, v in FREEFLYER_STEP_JAX.items()}
    rec.update(wall_s=wall, ipm_status=int(out["ipm_status"][0]),
               ipm_iters=int(out["ipm_iters"][0]), values=got,
               jax=FREEFLYER_STEP_JAX, rel_dev=dev, ipm_loops=loops,
               launches=launches,
               launches_per_ipm_loop={k: v / loops
                                      for k, v in launches.items()})
    log(f"[{tag}] " + json.dumps(rec))
    assert rec["n_qX"] == 10 and rec["n"] == 1593, rec
    assert rec["ipm_status"] in (int(IPMStatus.OPTIMAL),
                                 int(IPMStatus.ALMOST_OPTIMAL)), rec
    assert dev["L_aug"] <= 1e-6 and dev["J_aug"] <= 1e-5, rec
    assert _ladder_launched(launches), launches
    assert loops == rec["ipm_iters"] + 1, rec
    return rec, shapes


def phase_quadrotor_gusto_batched(torch, lk, ck, B=8):
    """GuSTO.solve_batched at B=8 on the quadrotor from _scenario_batch's
    guesses (2% spread; scenario B/2 is the guess itself), not projected:
    all SOLVED and feasible, the ladder at nb 8 -> 1 as scenarios freeze.
    The unscaled scenario repeats the serial solve from the same guess
    (driven apart): the same iterations, eta and lambda traces, each
    iteration's J_aug to 1e-6 relative (tests/test_batched.py:81)."""
    from scptoolbox_torch.config import SCPStatus
    from scptoolbox_torch.models.quadrotor import quadrotor

    tag = "quadrotor_gusto_batched"
    solver, rec, shapes, _ = _gusto_setup(
        torch, lk, ck, tag, quadrotor(),
        dict(GUSTO_PARS["quadrotor_gusto"], project_guess=False),
        project=False)
    bx, bu, bp = _scenario_batch(torch, solver, B, 0.02)
    k = B // 2
    assert torch.equal(bx[k], solver._guess[0])
    n_iters = solver.pars.iter_max
    out, wall, launches, shapes[tag] = _drive(
        torch, lk, ck, lambda: solver.solve_batched(bx, bu, bp, n_iters))
    serial, serial_s, _, _ = _drive(torch, lk, ck, solver.solve)
    status = out["status"].cpu().numpy()
    feas = out["feas"].cpu().numpy()
    cost = out["J_orig"].cpu().numpy()
    loops = sum(int(t["ipm_iters"].max()) + 1 for t in out["traces"])
    col = lambda key: [float(t[key][k]) for t in out["traces"]
                       if bool(t["active"][k])]
    J_dev = max(abs(a / h.J_aug - 1.0) for a, h in zip(col("J_aug"),
                                                       serial.history))
    rec.update(B=B, wall_s=wall, solves_per_s=B / wall,
               solved=int((status == int(SCPStatus.SOLVED)).sum()),
               feasible=int(feas.sum()),
               iters=out["iters"].cpu().numpy().tolist(),
               scp_steps=len(out["traces"]), ipm_loops=loops,
               active=[int(t["active"].sum()) for t in out["traces"]],
               cost_min=float(cost.min()), cost_max=float(cost.max()),
               serial=dict(wall_s=serial_s, iterations=serial.iterations,
                           status=str(serial.status), cost=serial.cost,
                           history=_gusto_history(serial)),
               unscaled_eta=col("eta"), unscaled_lam=col("lam"),
               unscaled_J_aug_max_rel_dev=J_dev, launches=launches,
               launches_per_ipm_loop={k_: v / loops
                                      for k_, v in launches.items()})
    log(f"[{tag}] " + json.dumps(rec))
    assert (status == int(SCPStatus.SOLVED)).all(), rec
    assert feas.all(), rec
    assert _ladder_launched(launches), launches
    assert _ladder_loops(solver, launches) == loops, (launches, loops)
    assert int(out["iters"][k]) == serial.iterations, rec
    for key in ("eta", "lam"):
        assert col(key) == [h.extras[key] for h in serial.history], (key,
                                                                     rec)
    assert J_dev <= 1e-6, rec
    return rec, shapes


def _interior(torch, spec, B, gen, dtype):
    """B strictly interior cone points (zero on the zero-cone rows)."""
    v = torch.rand(B, spec.m, generator=gen, device="cuda",
                   dtype=dtype) + 0.5
    off = spec.nz + spec.nl
    for d in spec.socs:
        w = 0.2 * (torch.rand(B, d - 1, generator=gen, device="cuda",
                              dtype=dtype) - 0.5)
        v[:, off] = torch.linalg.vector_norm(w, dim=1) + 1.0
        v[:, off + 1:off + d] = w
        off += d
    v[:, :spec.nz] = 0.0
    return v


def _indefinite_cholesky(torch, ck, n, nb, gen):
    """cholesky on nb indefinite float32 blocks at n (the CRQD ladder's
    failing rungs): the kernel raises nothing, and each block's factor is
    non-finite, where the plain version's is, with the same non-finite
    entries; the finite blocks' entries agree bit for bit."""
    M = torch.randn(nb, n, n, generator=gen, device="cuda")
    H = M @ M.mT + n * torch.eye(n, device="cuda")
    H[: nb // 2] -= 1.5 * torch.linalg.eigvalsh(H[: nb // 2])[:, -1:, None] \
        * torch.eye(n, device="cuda")
    L, ref = ck.cholesky(H), ck.cholesky_plain(H)
    torch.cuda.synchronize()
    fin, fin_ref = torch.isfinite(L), torch.isfinite(ref)
    assert torch.equal(fin, fin_ref), f"n={n}: non-finite entries differ"
    bad = ~fin.all(dim=-1).all(dim=-1)
    assert bad[: nb // 2].all() and not bad[nb // 2:].any(), bad
    assert torch.equal(L[fin], ref[fin]), f"n={n}: finite entries differ"
    return dict(n=n, nb=nb, non_finite_blocks=int(bad.sum()))


def phase_starship_crqd_kkt(torch, lk, ck, B=32):
    """One Starship float32 subproblem batch (B=32, at the spread guesses,
    Ruiz-equilibrated as ipm.solve does): one StagedCRQD factor and FGMRES
    solve at a random interior W beside StagedCRPL's on the same system,
    each solve's relative KKT residual (against the unregularized
    operator, per right-hand side) at most 1e-4; then one IPM solve of the
    subproblems on CRQD, its status and gap recorded (the JAX package's own
    record is a 1.6e-3 stall). The CRQD run launches the Cholesky ladder's
    cholesky and solve_lower (its ridge ladder) and the LU kernels (the
    arrow); the kernel's indefinite blocks are held to the plain version's
    NaN."""
    from scptoolbox_torch.ops import aug_kkt, ipm
    from scptoolbox_torch.ops import cones as cn
    from scptoolbox_torch.ops.ipm import _equilibrate, _w2_matvec

    tag = "starship_crqd_kkt"
    dt = torch.float32
    solver = _starship_solver(torch, dt, 1)
    st = solver.kkt_builder.structure
    spec = solver.spec
    bx, bu, bp = _scenario_batch(torch, solver, B, 0.02)
    A, b, c, const = solver._assemble(bx, bu, bp,
                                      solver._discretize(bx, bu, bp),
                                      solver.consts)
    R, D = _equilibrate(spec, A)
    Aq = R[:, :, None] * A * D[:, None, :]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    W = cn.nt_scaling(spec, _interior(torch, spec, B, gen, dt),
                      _interior(torch, spec, B, gen, dt))
    mask = torch.as_tensor(spec.cone_mask(), dtype=dt, device="cuda")
    n = Aq.shape[2]
    rhs = torch.randn(B, n + Aq.shape[1], 2, generator=gen, device="cuda",
                      dtype=dt)

    def residual(sol):
        r = rhs - torch.cat([Aq.mT @ sol[:, n:], Aq @ sol[:, :n]
                             - _w2_matvec(spec, W, sol[:, n:], mask)], dim=1)
        return (torch.linalg.vector_norm(r, dim=1)
                / torch.linalg.vector_norm(rhs, dim=1)).max().item()

    rec, shapes = dict(B=B, s=st.ns + st.rmax, ns=st.ns, rmax=st.rmax,
                       ng=st.ng, mg=st.mg), {}
    for name, cls in (("crqd", aug_kkt.StagedCRQD),
                      ("crpl", aug_kkt.StagedCRPL)):
        kkt = cls(spec, Aq, 1e-7, mask, st)
        sol, wall, launches, shapes[f"{tag}_{name}"] = _drive(
            torch, lk, ck, lambda: kkt.solve(kkt.factor(W), rhs))
        rec[name] = dict(gmres_iters=kkt.gmres_iters, wall_s=wall,
                         rel_residual=residual(sol), launches=launches)
        log(f"[{tag}] {name} " + json.dumps(rec[name]))
    builder = aug_kkt.make_staged_crqd_builder(st)
    sol, wall, launches, shapes[tag] = _drive(
        torch, lk, ck, lambda: ipm.solve_batched(
            A, b, c, spec, tol=3e-6, tol_almost=1e-5, max_iter=60,
            kkt_builder=builder))
    rec["ipm"] = dict(wall_s=wall, status=sol.status.tolist(),
                      iters=sol.iters.tolist(), gap=sol.gap.tolist(),
                      objective=(sol.obj + const).tolist())
    rec["launches"] = launches
    rec["indefinite_cholesky"] = [
        _indefinite_cholesky(torch, ck, k, 2 * B, gen)
        for k in (st.rmax, st.ns)]
    log(f"[{tag}] " + json.dumps({k: rec[k] for k in (
        "ipm", "indefinite_cholesky")}))
    for name in ("crqd", "crpl"):
        assert rec[name]["rel_residual"] <= 1e-4, (name, rec[name])
    crqd = rec["crqd"]["launches"]
    assert crqd["cholesky"] > 0 and crqd["solve_lower"] > 0, crqd
    assert crqd["lu_factor"] > 0 and crqd["lu_solve"] > 0, crqd
    assert launches["cholesky"] > 0 and launches["lu_factor"] > 0, launches
    return rec, shapes


def phase_quadrotor_gusto_softplus_staged(torch, lk, ck):
    """The quadrotor_gusto_softplus configuration (N=30, 180 exp blocks a
    subproblem) on the staged sweeps, from the projected guess of a
    float64 set-up: in float64 on explicit "staged_cr" (the library LU, as
    the JAX package's takes XLA's), on "staged_crpl" (every LU on the LU
    kernels, the template's 694-wide arrow Schur complement on lu_factor's
    grid design and lu_solve's cluster design, since a float64 block fits
    in shared memory only up to 168) and on "staged_qr" (R_k on
    solve_lower_t, the same arrow on the LU kernels): each SOLVED,
    feasible, within 1e-3 of the JAX package's softplus cost; then in
    float32 with
    no kkt_method, where the auto policy takes "staged_cr" with a builder
    (n = 752 >= 600): its status and cost deviation are recorded."""
    from scptoolbox_torch.config import SCPStatus
    from scptoolbox_torch.models.quadrotor import quadrotor
    from scptoolbox_torch.solvers.solution import SCPSolution

    tag = "quadrotor_gusto_softplus_staged"
    base = GUSTO_PARS["quadrotor_gusto_softplus"]
    rec, shapes, warm = {}, {}, None
    for name, kkt, dtype in (("staged_cr", "staged_cr", torch.float64),
                             ("staged_crpl", "staged_crpl", torch.float64),
                             ("staged_qr", "staged_qr", torch.float64),
                             ("auto_f32", None, torch.float32)):
        sub = f"{tag}_{name}"
        solver, r, shp, guess = _gusto_setup(
            torch, lk, ck, sub, quadrotor(), dict(base, kkt_method=kkt),
            project=warm is None, dtype=dtype)
        shapes.update(shp)
        if warm is None:
            x, u, p = (a.cpu().numpy() for a in guess)
            warm = SCPSolution(status=SCPStatus.FAILED,
                               algorithm="projection", iterations=0, xd=x,
                               ud=u, p=p, cost=math.nan, t_grid=solver.t_np,
                               feas=False)
        st = solver.kkt_builder.structure
        r.update(ng=st.ng, mg=st.mg, s=st.ns + st.rmax)
        assert r["kkt"] == (kkt or "staged_cr"), (name, r)
        assert (r["n"], r["nexp"]) == (752, 180), r
        sol, wall, launches, shapes[sub] = _drive(
            torch, lk, ck, lambda: solver.solve(warm=warm))
        keep = _keep_out(torch, sol.xd)
        r.update(wall_s=wall, status=str(sol.status),
                 feasible=bool(sol.feas), iterations=sol.iterations,
                 cost=sol.cost,
                 cost_rel_dev_jax=abs(sol.cost / GUSTO_SOFTPLUS_JAX - 1.0),
                 keep_out_min=keep, history=_gusto_history(sol),
                 launches=launches)
        log(f"[{tag}] {name} " + json.dumps(r))
        rec[name] = r
        if dtype == torch.float64:
            assert sol.status == SCPStatus.SOLVED and sol.feas, (name, r)
            assert r["cost_rel_dev_jax"] <= 1e-3, (name, r)
            assert min(keep) >= 1.0 - 5e-3, (name, keep)
        if kkt in ("staged_crpl", "staged_qr"):
            arrow = r["ng"] + r["mg"]
            assert arrow == 694, r
            assert any(k[0] == "lu_factor" and k[3] == arrow
                       for k in shapes[sub]), shapes[sub]
            assert launches["lu_factor"] > 0 and launches["lu_solve"] > 0
        if kkt == "staged_qr":
            assert launches["solve_lower_t"] > 0, launches
    return rec, shapes


C_BALL, A_PLANE = np.asarray([3.0, -4.0]), np.asarray([1.0, 2.0, -1.0])


def _parser_programs(torch, device="cuda"):
    """Builders of the conic parser's programs in float64 on `device`:
    the GEOM programs of tests/test_cones.py:158-200 (max t with
    geomean(x) >= t at fixed x; AM-GM) and the parametric programs of
    tests/test_variation.py (a bound, a ball, a plane)."""
    from scptoolbox_torch.parser.problem import geom, nonpos, soc, zero
    from scptoolbox_torch.parser.program import ConicProgram

    f64 = dict(dtype=torch.float64, device=device)
    T = lambda a: torch.as_tensor(np.asarray(a), **f64)

    def geom_program(n, xval):
        prg = ConicProgram(**f64)
        t, x = prg.variable("t"), prg.variable("x", n)
        prg.add_constraint("fix", lambda xv: [zero(xv - T(xval))], (x,))
        prg.add_constraint("gm", lambda tv, xv: [geom(torch.cat(
            [tv.reshape(1), xv]))], (t, x))
        prg.add_cost(lambda tv: -tv.sum(), (t,))
        prg.build()
        return prg

    def am_gm(n=5):
        prg = ConicProgram(**f64)
        x = prg.variable("x", n)
        prg.add_constraint("gm", lambda xv: [geom(torch.cat(
            [T([1.0]), xv]))], (x,))
        prg.add_cost(lambda xv: xv.sum(), (x,))
        prg.build()
        return prg

    def bound(theta):
        prg = ConicProgram(**f64)
        x = prg.variable("x", 1)
        th = prg.parameter("theta", theta)
        prg.add_constraint("bound", lambda xv, t: [nonpos(t - xv)], (x, th))
        prg.add_cost(lambda xv: ((xv - 2.0) ** 2).sum(), (x,))
        prg.build()
        return prg

    def ball():
        prg = ConicProgram(**f64)
        x = prg.variable("x", 2)
        th = prg.parameter("theta", 2.0)
        prg.add_constraint("ball", lambda xv, t: [soc(torch.cat(
            [t.reshape(1), xv]))], (x, th))
        prg.add_cost(lambda xv: (T(C_BALL) * xv).sum(), (x,))
        prg.build()
        return prg

    def plane():
        prg = ConicProgram(**f64)
        x = prg.variable("x", 3)
        th = prg.parameter("theta", 4.0)
        prg.add_constraint("plane", lambda xv, t: [zero(
            ((T(A_PLANE) * xv).sum() - t).reshape(1))], (x, th))
        prg.add_cost(lambda xv: (xv * xv).sum(), (x,))
        prg.build()
        return prg

    return dict(geom=geom_program, am_gm=am_gm, bound=bound, ball=ball,
                plane=plane)


def phase_conic_parser(torch, lk, ck):
    """The parser's GEOM programs (tests/test_cones.py:158-200: max t with
    geomean(x) >= t at fixed x for n = 2, 3, 4, 5, 7, and AM-GM at n = 5)
    and the four closed-form sensitivities of tests/test_variation.py, as
    ConicPrograms in float64 on the card (the dense Schur KKT's Cholesky
    ladder), held to their closed forms at those tests' tolerances."""
    from scptoolbox_torch.parser.variation import variation

    progs = _parser_programs(torch)
    geom_program, am_gm, bound, ball, plane = (
        progs[k] for k in ("geom", "am_gm", "bound", "ball", "plane"))

    def run():
        out = {}
        for n in (2, 3, 4, 5, 7):
            xval = 0.5 + np.random.default_rng(n).random(n)
            sol = geom_program(n, xval).solve()
            out[f"geom_{n}"] = dict(
                t=float(sol.values["t"]),
                geomean=float(np.exp(np.mean(np.log(xval)))),
                status=int(sol.status))
        sol = am_gm().solve()
        out["am_gm"] = dict(x=sol.values["x"].tolist(), obj=float(sol.obj),
                            status=int(sol.status))
        for name, build, theta, dx in (
                ("active_bound", lambda: bound(3.0), 3.0, [1.0]),
                ("inactive_bound", lambda: bound(1.0), 1.0, [0.0]),
                ("soc_radius", ball, 2.0, -C_BALL / 5.0),
                ("equality_rhs", plane, 4.0, A_PLANE / 6.0)):
            prg = build()
            sol = prg.solve()
            d = variation(prg, sol, {"theta": theta}).solve({"theta": 1.0})
            out[name] = dict(x=sol.values["x"].tolist(),
                             dx=d.dvalues["x"].tolist(), dx_closed=list(dx),
                             status=int(d.status))
        return out

    out, wall, launches, shapes = _drive(torch, lk, ck, run)
    rec = dict(out, wall_s=wall, launches=launches)
    log("[conic_parser] " + json.dumps(rec))
    for n in (2, 3, 4, 5, 7):
        r = out[f"geom_{n}"]
        assert abs(r["t"] / r["geomean"] - 1.0) <= 1e-6, r
    assert np.allclose(out["am_gm"]["x"], 1.0, atol=1e-5), out["am_gm"]
    assert abs(out["am_gm"]["obj"] / 5.0 - 1.0) <= 1e-6, out["am_gm"]
    for name, tol in (("active_bound", 1e-4), ("inactive_bound", 1e-4),
                      ("soc_radius", 1e-3), ("equality_rhs", 1e-4)):
        assert np.allclose(out[name]["dx"], out[name]["dx_closed"],
                           atol=tol), (name, out[name])
    assert _ladder_launched(launches), launches
    return rec, {"conic_parser": shapes}



def _random_cone_problem(rng, n, nz, nl, socs):
    """A feasible, bounded conic problem (A, b, c, (nz, nl, socs)) with a
    known interior point (tests/test_native.py:24-48)."""
    m = nz + nl + sum(socs)
    A = rng.standard_normal((m, n))
    x0 = rng.standard_normal(n)

    def interior(first):
        v = np.zeros(m)
        v[:nz] = first
        v[nz:nz + nl] = np.abs(rng.standard_normal(nl)) + 0.5
        off = nz + nl
        for d in socs:
            w = rng.standard_normal(d - 1) * 0.2
            v[off] = np.linalg.norm(w) + 1.0
            v[off + 1:off + d] = w
            off += d
        return v

    b = A @ x0 + interior(0.0)
    z0 = interior(rng.standard_normal(nz))
    return A, b, -A.T @ z0, (nz, nl, tuple(socs))


def _native_cases(torch, device="cuda"):
    """{name: (device solve, native solve)} of the native_ipm phase, float64
    on `device`, each solve returning (status, iters, obj, x, z) in numpy:
    the random LP / SOCP / mixed problems of tests/test_native.py:51-56
    (ops/ipm.py `solve` against native.solve, tol 1e-9); the conic
    parser's GEOM programs at n = 2-7 and its three parametric programs,
    the LCvx double integrator at both parameter choices (N=50) and one
    infeasible LP (x >= 1, x <= -1), as ConicPrograms (solve() against
    solve(backend="native"); x their variables, z their constraints'
    duals). AM-GM is left out: its objective is flat to second order at
    the optimum, so at the IPM's tolerance x is fixed only to ~sqrt(tol)
    (both solvers 4e-5 from x = 1 on the CPU)."""
    from scptoolbox_torch import native
    from scptoolbox_torch.models import double_integrator_lcvx as dil
    from scptoolbox_torch.ops import ipm
    from scptoolbox_torch.ops.cones import ConeSpec
    from scptoolbox_torch.parser.problem import nonpos
    from scptoolbox_torch.parser.program import ConicProgram

    h = lambda a: a.detach().cpu().numpy()
    cases = {}
    for seed, n, nz, nl, socs in ((0, 6, 0, 10, ()), (1, 8, 3, 6, (4,)),
                                  (2, 10, 2, 5, (3, 5)),
                                  (3, 5, 0, 0, (4, 3))):
        A, b, c, (nz, nl, socs) = _random_cone_problem(
            np.random.default_rng(seed), n, nz, nl, socs)
        spec = ConeSpec(nz=nz, nl=nl, socs=socs)
        T = [torch.as_tensor(a, dtype=torch.float64, device=device)
             for a in (A, b, c)]

        def dev(T=T, spec=spec):
            sol = ipm.solve(*T, spec, tol=1e-9, max_iter=60)
            return (int(sol.status), int(sol.iters), float(sol.obj),
                    h(sol.x), h(sol.z))

        def nat(A=A, b=b, c=c, spec=spec):
            sol = native.solve(A, b, c, spec, tol=1e-9, max_iter=60)
            return int(sol.status), sol.iters, sol.obj, sol.x, sol.z

        cases[f"random_{seed}"] = (dev, nat)

    pp = _parser_programs(torch, device)
    progs = {f"geom_{n}": pp["geom"](n, 0.5 + np.random.default_rng(n)
                                     .random(n)) for n in (2, 3, 4, 5, 7)}
    progs.update(bound=pp["bound"](3.0), ball=pp["ball"](),
                 plane=pp["plane"]())
    for choice in (1, 2):
        progs[f"lcvx_di_{choice}"] = dil.build_program(
            dil.LCvxDoubleIntegratorParameters(choice=choice),
            torch.float64, device)
    lp = ConicProgram(dtype=torch.float64, device=device)
    x = lp.variable("x", 1)
    lp.add_constraint("above", lambda xv: [nonpos(1.0 - xv)], (x,))
    lp.add_constraint("below", lambda xv: [nonpos(xv + 1.0)], (x,))
    lp.add_cost(lambda xv: xv.sum(), (x,))
    lp.build()
    progs["infeasible_lp"] = lp
    cat = lambda d: np.concatenate([h(v).ravel() for v in d.values()])

    def program(prg, **kw):
        sol = prg.solve(**kw)
        return (int(sol.status), int(sol.iters), float(sol.obj),
                cat(sol.values), cat(sol.duals))

    for name, prg in progs.items():
        cases[name] = (lambda prg=prg: program(prg),
                       lambda prg=prg: program(prg, backend="native"))
    return cases


def _native_check(torch, cases, sync):
    """Each case's device and native solves: {name: record}, held as
    tests/test_native.py:63-68 holds the pair (status equal, objective
    within 1e-6, x within 1e-5, z within 1e-4 relative / 1e-5 absolute);
    the infeasible LP PRIMAL_INFEASIBLE on both."""
    from scptoolbox_torch.ops.ipm import IPMStatus

    out = {}
    for name, (dev, nat) in cases.items():
        t0 = time.perf_counter()
        sd, itd, od, xd, zd = dev()
        sync()
        t1 = time.perf_counter()
        sn, itn, on, xn, zn = nat()
        t2 = time.perf_counter()
        r = dict(status=sd, native_status=sn, iters=itd, native_iters=itn,
                 device_s=t1 - t0, native_s=t2 - t1)
        if name == "infeasible_lp":
            assert sd == sn == int(IPMStatus.PRIMAL_INFEASIBLE), (name, r)
        else:
            r.update(obj=od, native_obj=on, obj_abs_dev=abs(od - on),
                     x_max_abs_dev=float(np.max(np.abs(xd - xn))),
                     z_max_abs_dev=float(np.max(np.abs(zd - zn))))
            assert sd == sn, (name, r)
            assert r["obj_abs_dev"] <= 1e-6, (name, r)
            assert np.allclose(xn, xd, rtol=1e-5, atol=1e-5), (name, r)
            assert np.allclose(zn, zd, rtol=1e-4, atol=1e-5), (name, r)
        out[name] = r
    return out


def phase_native_ipm(torch, lk, ck):
    """The host C++ IPM (scptoolbox_torch/native.py, built with g++ from
    native/ipm.cpp at first use) beside the card's IPM (the dense Schur
    KKT's Cholesky ladder) in float64 on _native_cases: the random cone
    problems of tests/test_native.py, the conic parser's programs, the
    LCvx double integrator and an infeasible LP."""
    from scptoolbox_torch import native

    t0 = time.perf_counter()
    assert native.available(), native.build_error()
    build_s = time.perf_counter() - t0
    cases = _native_cases(torch)
    out, wall, launches, shapes = _drive(
        torch, lk, ck, lambda: _native_check(torch, cases,
                                             torch.cuda.synchronize))
    rec = dict(out, build_s=build_s, wall_s=wall, launches=launches)
    log("[native_ipm] " + json.dumps(rec))
    assert _ladder_launched(launches), launches
    return rec, {"native_ipm": shapes}


def phase_checkpoint(torch, lk, ck):
    """bench.py's double integrator (N=31, Nsub=15) solved serially in
    float64 on the card (the dense Schur ladder), saved with
    save_solution, loaded, and resumed by PTR.solve(warm=) on the card:
    the resume reaches the same status, its cost within a relative 1e-6 of
    the saved one."""
    import tempfile
    from importlib import import_module

    from scptoolbox_torch.solvers import ptr
    from scptoolbox_torch.utils.checkpoint import (load_solution,
                                                   save_solution)

    di = import_module("scptoolbox_torch.models.double_integrator")
    solver = ptr.PTR(di.double_integrator(di.DoubleIntegratorParameters(
        drag=True, g=0.01, s=30.0)), ptr.PTRParameters(**DI_PARS,
                                                       iter_max=15),
        dtype=torch.float64, device="cuda")

    def run():
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "double_integrator.npz")
            sol = solver.solve()
            save_solution(path, sol)
            size = os.path.getsize(path)
            back = load_solution(path)
            return sol, back, solver.solve(warm=back), size

    (sol, back, res, size), wall, launches, shapes = _drive(
        torch, lk, ck, run)
    rec = dict(status=str(sol.status), iterations=sol.iterations,
               cost=sol.cost, file_bytes=size,
               resumed_status=str(res.status),
               resumed_iterations=res.iterations, resumed_cost=res.cost,
               cost_rel_dev=abs(res.cost / sol.cost - 1.0), wall_s=wall,
               launches=launches)
    log("[checkpoint] " + json.dumps(rec))
    assert back.status == sol.status and back.cost == sol.cost, rec
    assert np.array_equal(back.xd, sol.xd) and len(back.history) == len(
        sol.history), rec
    assert res.status == sol.status, rec
    assert rec["cost_rel_dev"] <= 1e-6, rec
    assert _ladder_launched(launches), launches
    return rec, {"checkpoint": shapes}


PARALLEL_B, PARALLEL_ITERS = 128, 10


def _parallel_runs(torch, lk, ck, device="cuda", B=PARALLEL_B):
    """The parallel phase's two runs on the current world: the collective
    solve on "staged_crpl" and the sharded solve on the dense Schur KKT,
    bench.py's double integrator (float32) from _scenario_batch's B
    guesses with PARALLEL_ITERS iterations. Returns (solvers, batches,
    results, records, shapes), the records' numbers those of this rank."""
    from importlib import import_module

    from scptoolbox_torch.config import SCPStatus
    from scptoolbox_torch.parallel import (solve_batched_collective,
                                           solve_batched_sharded)
    from scptoolbox_torch.solvers import ptr

    di = import_module("scptoolbox_torch.models.double_integrator")
    pbm = di.double_integrator(di.DoubleIntegratorParameters(
        drag=True, g=0.01, s=30.0))
    solvers, batches, results, recs, shapes = {}, {}, {}, {}, {}
    for tag, kkt, fn in (("collective", "staged_crpl",
                          solve_batched_collective),
                         ("sharded", None, solve_batched_sharded)):
        solver = ptr.PTR(pbm, ptr.PTRParameters(**DI_PARS, kkt_method=kkt),
                         dtype=torch.float32, device=device)
        batch = _scenario_batch(torch, solver, B, 0.1)
        res, wall, launches, shp = _drive(
            torch, lk, ck, lambda: fn(solver, *batch, PARALLEL_ITERS))
        if tag == "collective":
            iters = res.iters.cpu().numpy()
            r = dict(solved=int((res.status == int(SCPStatus.SOLVED)).sum()),
                     n_feasible=res.n_feasible, outer_iters=res.outer_iters,
                     total_iters=res.total_iters,
                     stopped_early=res.outer_iters < PARALLEL_ITERS,
                     max_iters=int(iters.max()), sum_iters=int(iters.sum()))
        else:
            r = dict(n_feasible=res.n_feasible, scp_steps=len(res.traces),
                     stopped_early=len(res.traces) < PARALLEL_ITERS)
        recs[tag] = dict(r, B=B, kkt=kkt or "schur", wall_s=wall,
                         launches=launches)
        solvers[tag], batches[tag], results[tag], shapes[tag] = (
            solver, batch, res, shp)
    return solvers, batches, results, recs, shapes


def _parallel_rank(rank, world, store_file, out_dir):
    """A rank of the parallel phase's world of two: gloo on a FileStore,
    every rank on cuda:0 (NCCL refuses two ranks on one device); writes
    its records, J_aug, launch counts and shapes to out_dir/rank<r>.json."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    _precise(torch)
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store_file, world),
                            world_size=world, rank=rank)
    try:
        from scptoolbox_torch.ops import chol_kernels as ck
        from scptoolbox_torch.ops import lu_kernels as lk

        _, _, results, recs, shapes = _parallel_runs(torch, lk, ck)
        out = dict(recs=recs, J_aug={
            tag: res.J_aug.cpu().tolist() for tag, res in results.items()},
            shapes={tag: [[list(k), c] for k, c in shp.items()]
                    for tag, shp in shapes.items()})
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def _same_traces(torch, a, b):
    return len(a) == len(b) and all(
        torch.equal(x[k].nan_to_num(), y[k].nan_to_num())
        and torch.equal(x[k].isnan(), y[k].isnan()) if x[k].is_floating_point()
        else torch.equal(x[k], y[k]) for x, y in zip(a, b) for k in x)


def phase_parallel(torch, lk, ck):
    """Scenario batches over torch.distributed (scptoolbox_torch/parallel/)
    at bench.py's double integrator, B=128, float32, 10 iterations: the
    collective solve on "staged_crpl" (the LU kernels) and the sharded
    solve on the dense Schur KKT (the Cholesky ladder). World 1: an NCCL
    group in this process on a FileStore; each run equal to
    solve_batched on the same 128 scenarios (J_aug, iterations and
    statuses; the sharded traces too). World 2: two spawned ranks on gloo,
    both on the one card, each solving 64 scenarios: 128/128 feasible,
    every rank's gathered J_aug equal to solve_batched on the two halves
    of the batch (the batches a rank's kernels and reductions see), the
    vote's outer_iters the largest iteration count and total_iters their
    sum; the collective's J_aug within a relative 1e-4 of world 1. The
    sharded run's distance from world 1 is recorded, not held: on the
    float32 Schur ladder a scenario's last bits depend on the batch it is
    solved in (its GEMMs and reductions may take other kernels at another
    batch size), and its SCP steps carry such a change into the iterate,
    up to 2% of J_aug after 10 steps; the LU path repeats world 1 to the
    bit. Walls, SOLVED counts and whether the vote stopped the fleet early
    are recorded."""
    import shutil
    import tempfile

    import torch.distributed as dist
    import torch.multiprocessing as mp

    rec, shapes_by_path = {}, {}
    tmp = tempfile.mkdtemp()
    try:
        torch.cuda.set_device(0)
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(tmp, "nccl"), 1),
            world_size=1, rank=0)
        try:
            solvers, batches, w1, recs, shapes = _parallel_runs(torch, lk,
                                                                ck)
        finally:
            dist.destroy_process_group()
        for tag in ("collective", "sharded"):
            t0 = time.perf_counter()
            ref = solvers[tag].solve_batched(*batches[tag], PARALLEL_ITERS)
            torch.cuda.synchronize()
            recs[tag]["solve_batched_wall_s"] = time.perf_counter() - t0
            res = w1[tag]
            if tag == "collective":
                same = all(torch.equal(getattr(res, k), ref[k])
                           for k in ("J_aug", "iters", "status"))
            else:
                same = (all(torch.equal(getattr(res, k), ref[k])
                            for k in ("x", "J_aug", "feas"))
                        and _same_traces(torch, res.traces, ref["traces"]))
            recs[tag]["equal_to_solve_batched"] = same
            rec[f"{tag}_w1"] = recs[tag]
            shapes_by_path[f"parallel_{tag}_w1"] = shapes[tag]

        half = PARALLEL_B // 2
        J_halves = {tag: torch.cat([solvers[tag].solve_batched(
            *(a[i:i + half] for a in batches[tag]), PARALLEL_ITERS)["J_aug"]
            for i in (0, half)]).cpu().tolist() for tag in solvers}
        t0 = time.perf_counter()
        mp.start_processes(_parallel_rank, args=(2, os.path.join(
            tmp, "gloo"), tmp), nprocs=2, start_method="spawn")
        rec["spawn_wall_s"] = time.perf_counter() - t0
        ranks = []
        for r in range(2):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        for tag in ("collective", "sharded"):
            J1 = w1[tag].J_aug.cpu().numpy()
            r2 = dict(ranks[0]["recs"][tag])
            r2["rank_wall_s"] = [rk["recs"][tag]["wall_s"] for rk in ranks]
            r2["launches"] = dict(sum((collections.Counter(
                rk["recs"][tag]["launches"]) for rk in ranks),
                collections.Counter()))
            r2["J_aug_max_rel_dev_w1"] = max(float(np.max(np.abs(
                np.asarray(rk["J_aug"][tag]) / J1 - 1.0))) for rk in ranks)
            r2["equal_to_halves"] = all(rk["J_aug"][tag] == J_halves[tag]
                                        for rk in ranks)
            rec[f"{tag}_w2"] = r2
            shp = collections.Counter()
            for rk in ranks:
                shp.update({tuple(k): c for k, c in rk["shapes"][tag]})
            shapes_by_path[f"parallel_{tag}_w2"] = shp
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log("[parallel] " + json.dumps(rec))
    for w in ("w1", "w2"):
        c, s_ = rec[f"collective_{w}"], rec[f"sharded_{w}"]
        assert c["launches"]["lu_factor"] > 0, (w, c["launches"])
        assert c["launches"]["lu_solve"] > 0, (w, c["launches"])
        assert _ladder_launched(s_["launches"]), (w, s_["launches"])
        assert c["n_feasible"] == s_["n_feasible"] == PARALLEL_B, (w, rec)
        assert c["outer_iters"] == c["max_iters"], (w, c)
        assert c["total_iters"] == c["sum_iters"], (w, c)
    for tag in ("collective", "sharded"):
        assert rec[f"{tag}_w1"]["equal_to_solve_batched"], (tag, rec)
        assert rec[f"{tag}_w2"]["equal_to_halves"], (tag, rec)
    assert rec["collective_w2"]["J_aug_max_rel_dev_w1"] <= 1e-4, rec
    return rec, shapes_by_path


def phase_gmres(torch, lk, ck, B=4):
    """FGMRES depth of the staged CR KKT against IPM convergence on the
    first Starship subproblems of B spread guesses (float64 k=8, float32
    k=8 and 16). Not a default phase: it measured the float32 depth that
    StagedCR.GMRES_ITERS fixes (PERF.md)."""
    from scptoolbox_torch.ops import aug_kkt, ipm

    rows = []
    for dtype, depths in ((torch.float64, (8,)), (torch.float32, (8, 16))):
        solver = _starship_solver(torch, dtype, 1)
        bx, bu, bp = _scenario_batch(torch, solver, B, 0.02)
        A, b, c, const = solver._assemble(bx, bu, bp,
                                          solver._discretize(bx, bu, bp),
                                          solver.consts)
        for k in depths:
            builder = aug_kkt.make_staged_crpl_builder(
                solver.kkt_builder.structure, gmres_iters=k)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sol = ipm.solve_batched(A, b, c, solver.spec, tol=3e-6,
                                    tol_almost=1e-5, max_iter=60,
                                    kkt_builder=builder)
            torch.cuda.synchronize()
            row = dict(dtype=str(dtype).split(".")[-1], gmres_iters=k,
                       wall_s=time.perf_counter() - t0,
                       status=sol.status.tolist(), iters=sol.iters.tolist(),
                       gap=sol.gap.tolist(),
                       objective=(sol.obj + const).tolist())
            rows.append(row)
            log("[gmres] " + json.dumps(row))
    return rows


def _union_ms(intervals):
    """Total length of the union of (start, end) intervals in us, in ms."""
    total, cur = 0.0, None
    for a, b in sorted(intervals):
        if cur is None or a > cur[1]:
            if cur is not None:
                total += cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    if cur is not None:
        total += cur[1] - cur[0]
    return total / 1e3


def phase_profile(torch, lk, ck, B=32, loops=10, reps=3):
    """Where the main path's first SCP step spends its time: a host-clock
    split into discretize / assemble / IPM, then `reps` windows of `loops`
    batched IPM iterations of that step, each under torch.profiler (device
    activity only, to keep the trace small). Each window gives its own wall
    time and device busy time (the union of its kernels' intervals), so the
    busy share is read within one window; the same window unprofiled gives
    the profiler's cost on the wall. Not a default phase."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from scptoolbox_torch.ops import ipm

    solver = _starship_solver(torch, torch.float32, 1)
    bx, bu, bp = _scenario_batch(torch, solver, B, 0.02)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    dltv, disc_ms = timed(lambda: solver._discretize(bx, bu, bp))
    (A, b, c, _), asm_ms = timed(lambda: solver._assemble(
        bx, bu, bp, dltv, solver.consts))
    sol, ipm_ms = timed(lambda: solver._solve_sub(A, b, c))
    window = lambda: ipm.solve_batched(
        A, b, c, solver.spec, tol=solver.pars.ipm_tol, max_iter=loops,
        kkt_builder=solver.kkt_builder)
    windows, by_name = [], {}
    for rep in range(reps):
        _, plain_ms = timed(window)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _, wall_ms = timed(window)
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        busy_ms = _union_ms((e.time_range.start, e.time_range.end)
                            for e in dev)
        windows.append(dict(unprofiled_ms=plain_ms, wall_ms=wall_ms,
                            device_busy_ms=busy_ms,
                            device_busy_share=busy_ms / wall_ms,
                            kernel_launches=len(dev)))
        if rep == 0:
            for e in dev:
                n, t = by_name.get(e.name, (0, 0.0))
                by_name[e.name] = (n + 1,
                                   t + e.time_range.elapsed_us() / 1e3)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    rec = dict(B=B, discretize_ms=disc_ms, assemble_ms=asm_ms, ipm_ms=ipm_ms,
               ipm_loops=int(sol.iters.max()) + 1, window_loops=loops + 1,
               windows=windows,
               top=[dict(name=k[:80], launches=n, ms=t)
                    for k, (n, t) in top])
    log("[profile] " + json.dumps(rec))
    assert by_name, "the profiler recorded no device activity"
    return rec


REPLACES = {"lu_factor": "scptoolbox_tpu/ops/pallas_kernels.py:373",
            "lu_solve": "scptoolbox_tpu/ops/pallas_kernels.py:449",
            "cholesky": "scptoolbox_tpu/ops/pallas_kernels.py:65",
            "solve_lower": "scptoolbox_tpu/ops/pallas_kernels.py:129",
            "solve_lower_t": "scptoolbox_tpu/ops/pallas_kernels.py:154",
            "gj_inverse": "scptoolbox_tpu/ops/pallas_kernels.py:252"}
SOURCES = {"lu_factor": "scptoolbox_torch/csrc/lu_kernels.cu",
           "lu_solve": "scptoolbox_torch/csrc/panel_solve.cuh",
           "cholesky": "scptoolbox_torch/csrc/chol_kernels.cu",
           "solve_lower": "scptoolbox_torch/csrc/chol_kernels.cu",
           "solve_lower_t": "scptoolbox_torch/csrc/chol_kernels.cu",
           "gj_inverse": "scptoolbox_torch/csrc/gj_kernels.cu"}


def _path_launches(record):
    """{path: launch counts} of every driven run that recorded them."""
    out = {}
    for name, rec in record.items():
        if not isinstance(rec, dict):
            continue
        if "launches" in rec:
            out[name] = rec["launches"]
        if "setup_launches" in rec:
            out[f"{name}_setup"] = rec["setup_launches"]
        for sub, r in rec.items():           # the lcvx phase's programs
            if isinstance(r, dict) and "launches" in r:
                out[f"{name}_{sub}"] = r["launches"]
    return out


def _kernel_line(record):
    """One entry per kernel, from the path that launched it most (the main
    path, starship, for the LU kernels): that path's launches, the largest
    error over every check, and the times of the shape that path launched
    most often. gj_inverse, which no path launches, has the path "kernels"
    and the launches of its checks there, at its largest shape."""
    by_path = _path_launches(record)
    kernels = []
    for name, replaces in REPLACES.items():
        rows = [r for r in record["kernels"] if r["kernel"] == name]
        if name == "gj_inverse":
            path = "kernels"
            r = max(rows, key=lambda r: r["bound_nb"] * r["n"])
            launches = sum(x["launches"] for x in rows)
        else:
            path = max(by_path, key=lambda p: by_path[p].get(name, 0))
            r = max((r for r in rows if r["path"] == path),
                    key=lambda r: r["launches"])
            launches = by_path[path][name]
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=replaces, path=path, launches=launches,
            max_abs_err=max(x["max_abs_err"] for x in rows),
            ms=r["kernel_ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"],
            shape=dict(nb=r["bound_nb"], n=r["n"], K=r["K"])))
    return {"kernels": kernels}


def _kernel_time(rows, shapes_by_path):
    """{path: {kernel: s, "total": s}}: each path's launches of a group
    times the group's wrapper time (timed at its largest batch)."""
    ms = {(r["path"], r["kernel"], r["dtype"], r["n"], r["K"]): r["kernel_ms"]
          for r in rows}
    names = {"f32": "float32", "f64": "float64"}
    out = {}
    for path, shapes in shapes_by_path.items():
        per = collections.Counter()
        for (kernel, suffix, nb, n, K), cnt in shapes.items():
            per[kernel] += cnt * ms[(path, kernel, names[suffix], n, K)] / 1e3
        out[path] = dict(per, total=sum(per.values()))
    return out


PATHS = (("starship", phase_starship),
         ("starship_f64", phase_starship_f64),
         ("starship_f64_block", phase_starship_f64_block),
         ("double_integrator_crpl", phase_double_integrator_crpl),
         ("double_integrator_schur", phase_double_integrator_schur),
         ("starship_serial_lu", phase_starship_serial_lu),
         ("oscillator", phase_oscillator),
         ("lcvx", phase_lcvx),
         ("rendezvous_planar", phase_rendezvous_planar),
         ("rendezvous_3d", phase_rendezvous_3d),
         ("quadrotor_scvx", phase_quadrotor_scvx),
         ("freeflyer_scvx", phase_freeflyer_scvx),
         ("starship_scvx", phase_starship_scvx),
         ("quadrotor_scvx_batched", phase_quadrotor_scvx_batched),
         ("quadrotor_gusto", phase_quadrotor_gusto),
         ("quadrotor_gusto_softplus", phase_quadrotor_gusto_softplus),
         ("quadrotor_gusto_qrchol", phase_quadrotor_gusto_qrchol),
         ("freeflyer_gusto_step", phase_freeflyer_gusto_step),
         ("quadrotor_gusto_batched", phase_quadrotor_gusto_batched),
         ("starship_f64_staged_lu", phase_starship_f64_staged_lu),
         ("starship_f64_staged_qr", phase_starship_f64_staged_qr),
         ("double_integrator_staged", phase_double_integrator_staged),
         ("starship_crqd_kkt", phase_starship_crqd_kkt),
         ("quadrotor_gusto_softplus_staged",
          phase_quadrotor_gusto_softplus_staged),
         ("conic_parser", phase_conic_parser),
         ("parallel", phase_parallel),
         ("native_ipm", phase_native_ipm),
         ("checkpoint", phase_checkpoint))
OPT_IN_PATHS = (("rendezvous_full", phase_rendezvous_full),)
DEFAULT = ",".join([name for name, _ in PATHS] + ["kernels"])


# each path phase's wall when this script ran them one after another on
# an NVIDIA H100 80GB HBM3 at 700.00 W (seconds, phase set-ups included):
# the weights by which run_paths shares the phases out; a phase missing
# here weighs 60
PHASE_S = {"starship": 161.7, "starship_f64": 51.8,
           "starship_f64_block": 40.5, "double_integrator_crpl": 10.4,
           "double_integrator_schur": 5.4, "starship_serial_lu": 29.5,
           "oscillator": 19.4, "lcvx": 35.7, "rendezvous_planar": 97.4,
           "rendezvous_3d": 139.0, "quadrotor_scvx": 25.2,
           "freeflyer_scvx": 119.7, "starship_scvx": 195.9,
           "quadrotor_scvx_batched": 47.4, "quadrotor_gusto": 17.7,
           "quadrotor_gusto_softplus": 26.4, "quadrotor_gusto_qrchol": 17.0,
           "freeflyer_gusto_step": 4.8, "quadrotor_gusto_batched": 28.1,
           # PR 11's phases: their walls side by side over three workers
           "starship_f64_staged_lu": 105.0, "starship_f64_staged_qr": 90.0,
           "double_integrator_staged": 48.6, "starship_crqd_kkt": 23.9,
           "quadrotor_gusto_softplus_staged": 140.0, "conic_parser": 10.0,
           # the three phases below: walls side by side over three workers
           "parallel": 146.7, "native_ipm": 10.0, "checkpoint": 5.0}


def _precise(torch):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def _run_phases(torch, names):
    """Run the path phases `names` in this process, in PATHS order:
    ({name: record}, {path: launch shapes})."""
    from scptoolbox_torch.ops import chol_kernels as ck
    from scptoolbox_torch.ops import lu_kernels as lk

    record, shapes_by_path = {}, {}
    for name, fn in PATHS + OPT_IN_PATHS:
        if name in names:
            t0 = time.perf_counter()
            record[name], shapes = fn(torch, lk, ck)
            shapes_by_path.update(shapes)
            log(f"[{name}] phase {time.perf_counter() - t0:.1f} s")
    return record, shapes_by_path


def _groups(names, workers):
    """The phases shared out over `workers` processes, heaviest first to
    the least loaded (PHASE_S)."""
    load = [[0.0, []] for _ in range(workers)]
    for name in sorted(names, key=lambda n: -PHASE_S.get(n, 60.0)):
        slot = min(load, key=lambda g: g[0])
        slot[0] += PHASE_S.get(name, 60.0)
        slot[1].append(name)
    return [g[1] for g in load if g[1]]


def run_paths(torch, names, workers):
    """Every path phase in `names`, over `workers` processes that share the
    card (each path's launch counts and shapes are its own process's); one
    worker runs them here. The paths are host-bound, so the processes
    overlap almost wholly; their walls are taken side by side."""
    groups = _groups(names, workers)
    if len(groups) <= 1:
        return _run_phases(torch, names)
    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    outs = [os.path.join(out_dir, f"worker{i}.json")
            for i in range(len(groups))]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--worker", ",".join(g), "--out", out])
             for g, out in zip(groups, outs)]
    try:
        for g, proc in zip(groups, procs):
            assert proc.wait() == 0, f"worker for {g} failed"
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    record, shapes_by_path = {}, {}
    for out in outs:
        with open(out) as f:
            part = json.load(f)
        record.update(part["record"])
        for path, items in part["shapes"].items():
            shapes_by_path[path] = collections.Counter(
                {tuple(k): c for k, c in items})
    return record, shapes_by_path


def worker(names, out):
    """A worker process of run_paths: its phases' records and launch
    shapes to the file `out`."""
    import torch

    sys.path.insert(0, REPO)
    _precise(torch)
    record, shapes_by_path = _run_phases(torch, names.split(","))
    with open(out, "w") as f:
        json.dump({"record": record, "shapes": {
            path: [[list(k), c] for k, c in shapes.items()]
            for path, shapes in shapes_by_path.items()}}, f)
    return 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=DEFAULT,
                    help="comma-separated phases to run; also "
                    "rendezvous_full, gmres and profile, which are not run "
                    "by default")
    ap.add_argument("--workers", type=int, default=4,
                    help="processes the path phases are shared over (1: "
                    "one after another in this process, each wall alone)")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        return worker(args.worker, args.out)
    phases = args.phases.split(",")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from scptoolbox_torch.ops import chol_kernels as ck
    from scptoolbox_torch.ops import cuda_lib
    from scptoolbox_torch.ops import gj_kernels as gk
    from scptoolbox_torch.ops import lu_kernels as lk

    card = phase_environment(torch)
    record = {"card": card}
    t_start = t0 = time.perf_counter()
    for path in cuda_lib.build_all([lk.LIB, ck.LIB, gk.LIB], verbose=True):
        log(f"[build] {os.path.relpath(path, REPO)}")
    log(f"[build] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    paths, shapes_by_path = run_paths(
        torch, [n for n, _ in PATHS + OPT_IN_PATHS if n in phases],
        args.workers)
    record.update(paths)
    record["paths_s"] = time.perf_counter() - t0
    record["workers"] = args.workers
    log(f"[paths] {record['paths_s']:.1f} s over {args.workers} workers")
    if "kernels" in phases:
        record["kernels"] = phase_kernels(torch, lk, ck, gk, shapes_by_path)
        record["kernel_time_s"] = _kernel_time(record["kernels"],
                                               shapes_by_path)
        log("[kernel_time_s] " + json.dumps(record["kernel_time_s"]))
    for name, fn in (("gmres", phase_gmres), ("profile", phase_profile)):
        if name in phases:
            record[name] = fn(torch, lk, ck)
    record["total_s"] = time.perf_counter() - t_start

    if "kernels" in phases and all(name in phases for name, _ in PATHS):
        log(json.dumps(_kernel_line(record)))
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
