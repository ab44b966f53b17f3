"""The port's serial PTR (scptoolbox_torch/solvers/ptr.py `PTR.solve`) and
its progress table (scptoolbox_torch/utils/table.py) against the JAX
package's, on the same problem: the double integrator of bench.py at N=15
(tests/torch_refs.py), float64, the default dense Schur KKT on both sides
(LU on the CPU). Then the serial
loop's own rules, on the port alone: the callback's veto and extra budget,
the emergency exit on a non-finite cost, the timing split."""

import math

import numpy as np
import pytest
import torch

from scptoolbox_torch.config import SCPStatus
from scptoolbox_torch.solvers import ptr as tptr
from scptoolbox_torch.utils import table as ttable
from scptoolbox_tpu.utils import table as jtable
from tests import torch_refs as refs

torch.set_num_threads(1)


def _port_solver(**over):
    pbm = refs.tdi.double_integrator(
        refs.tdi.DoubleIntegratorParameters(**refs.DI_MODEL))
    pars = dict(refs.DI_PARS, **over)
    return pbm, tptr.PTR(pbm, tptr.PTRParameters(**pars), device="cpu")


@pytest.fixture(scope="module")
def serial_runs():
    return refs.jax_di_ptr_dense_solution(), _port_solver()[1].solve()


def test_serial_ptr_matches_jax(serial_runs):
    sj, st = serial_runs
    assert st.status == sj.status == SCPStatus.SOLVED
    assert st.iterations == sj.iterations == len(st.history)
    for hj, ht in zip(sj.history, st.history):
        assert ht.J_aug == pytest.approx(hj.J_aug, rel=1e-8)
        assert ht.ipm_iters == hj.ipm_iters and ht.feas == hj.feas
    np.testing.assert_allclose(st.xd, sj.xd, rtol=1e-7, atol=1e-7)
    assert st.cost == pytest.approx(sj.cost, rel=1e-8)


def test_serial_replay_matches_jax(serial_runs):
    """The continuous-time replay at 2 Nsub substeps per interval."""
    sj, st = serial_runs
    assert st.x_cont.shape == sj.x_cont.shape
    np.testing.assert_allclose(st.t_cont, sj.t_cont, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(st.x_cont, sj.x_cont, rtol=1e-7,
                               atol=1e-7 * np.abs(sj.x_cont).max())


def test_table_prints_as_jax(capsys):
    cols = [("iter", "iter", "{:4d}"), ("J", "J", "%12.4e"),
            ("dev", "deviation", "9.2e"), ("s", "note", "{:>6s}")]
    rows = [dict(iter=1, J=1.5, dev=2e-3, s="ab"),
            dict(iter=2, J=float("nan"), dev=None, s=3)]
    out = {}
    for name, mod in (("jax", jtable), ("port", ttable)):
        t = mod.Table([mod.Column(*c) for c in cols])
        for r in rows:
            t.print_row(r)
        t.reset()
        t.print_row(rows[0])
        out[name] = capsys.readouterr().out
    assert out["port"] == out["jax"]
    for a, b in ((1.0, 0.9), (0.0, 1.0), (math.inf, 1.0)):
        x, y = ttable.improvement_percent(a, b), jtable.improvement_percent(
            a, b)
        assert x == y or (math.isnan(x) and math.isnan(y))


def test_callback_vetoes_stopping_and_extends_the_budget():
    pbm, S = _port_solver(iter_max=2)
    seen = []

    def callback(rec):
        seen.append(rec.iteration)
        if rec.iteration == 1:
            S.extra_iters += 1      # one more iteration than iter_max
        return True                 # never let it stop

    pbm.callback = callback
    pbm.add_table_column("n", "n", "{:3d}", lambda rec: len(seen))
    sol = S.solve(verbose=True)
    assert seen == [1, 2, 3] and sol.iterations == 3
    # exhausting the budget on a clean subproblem is SOLVED
    assert sol.status == SCPStatus.SOLVED


def test_callback_moves_the_consts_of_the_next_iteration():
    """solver.consts is read at every iteration, as the JAX package's loop
    reads it (scptoolbox_tpu/solvers/ptr.py:386-389): a callback that moves
    it (the 3-D rendezvous homotopy ladder) changes the next step."""
    pbm, S = _port_solver(iter_max=3)
    moved = {"rung": 1}
    seen = []
    step = S._step_impl

    def spy(*args):
        seen.append(args[-1])
        return step(*args)

    def callback(rec):
        if rec.iteration == 1:
            S.consts = moved
        return True

    S._step_impl = spy
    pbm.callback = callback
    S.solve()
    assert len(seen) == 3
    assert seen[0] is None and seen[1] is moved and seen[2] is moved


def test_non_finite_cost_ends_the_solve_on_the_last_good_iterate(
        monkeypatch):
    _, S = _port_solver(iter_max=3, timing_detail=True)
    step = S._step_timed

    def failing(*a, **kw):
        out, timing = step(*a, **kw)
        if failing.calls == 1:
            out = dict(out, J_aug=torch.full_like(out["J_aug"], math.nan))
        failing.calls += 1
        return out, timing

    failing.calls = 0
    monkeypatch.setattr(S, "_step_timed", failing)
    sol = S.solve()
    assert sol.status == SCPStatus.FAILED and sol.iterations == 2
    assert len(sol.history) == 1
    np.testing.assert_array_equal(sol.xd, sol.history[0].x)
    assert set(sol.history[0].timing) == {"formulate", "solve", "discretize",
                                          "total", "overhead"}
