"""The comparison that decides `correct` catches a broken timed path: a run
driven with a fault planted under the window (the harness's look for a
card skipped) comes out not correct. On the CPU at a tiny size against the
double-integrator cell's own limits, where the same run unbroken comes out
correct; on a card (`-m cuda`) in every cell at its own size. Faults: a
step that returns its state unchanged; half of the batch left out and the
mean of the rest given in its place; an answer altered where it is
produced. (The cells run on one card: there is no exchange between chips
to leave out.)"""

import time

import pytest
import torch

from bench_layout import ROOT, tiny_layout
from benchmark import harness
from test_bench_control import CELLS


def _unchanged(inner):
    def step(self, ref_x, ref_u, ref_p, dltv, J_aug_ref, consts=None):
        out = inner(self, ref_x, ref_u, ref_p, dltv, J_aug_ref, consts)
        return dict(out, x=ref_x.clone(), u=ref_u.clone(), p=ref_p.clone(),
                    dltv=dltv)
    return step


def _half(inner):
    def step(self, ref_x, ref_u, ref_p, dltv, J_aug_ref, consts=None):
        h = max(ref_x.shape[0] // 2, 1)
        out = inner(self, ref_x[:h], ref_u[:h], ref_p[:h],
                    type(dltv)(*(a[:h] for a in dltv)), J_aug_ref[:h],
                    consts)
        n = ref_x.shape[0]

        def fill(a):
            if not torch.is_floating_point(a):
                return torch.cat([a, a[:1].expand(n - h, *a.shape[1:])])
            return torch.cat([a, a.mean(0, keepdim=True).expand(
                n - h, *a.shape[1:])])

        res = {k: fill(v) for k, v in out.items() if k != "dltv"}
        res["dltv"] = type(out["dltv"])(*(fill(a) for a in out["dltv"]))
        return res
    return step


def _altered(inner):
    def step(self, ref_x, ref_u, ref_p, dltv, J_aug_ref, consts=None):
        out = inner(self, ref_x, ref_u, ref_p, dltv, J_aug_ref, consts)
        x = out["x"].clone()
        x[:, x.shape[1] // 2] += 0.01 * self.scaling.Sx
        return dict(out, x=x)
    return step


def _run(tmp_path):
    torch.set_num_threads(2)
    root = tiny_layout(tmp_path, B=4, cap=2)
    result, compared, details = harness.run(
        root, "di_tiny", 2 ** 31 + 777, 0.5, 0, "cpu", time.time())
    return result, compared, details


@pytest.mark.parametrize("fault", [None, _unchanged, _half, _altered])
def test_fault_is_caught(tmp_path, monkeypatch, fault):
    from scptoolbox_torch.solvers.ptr import PTR
    if fault is not None:
        monkeypatch.setattr(PTR, "_step_impl", fault(PTR._step_impl))
    result, compared, details = _run(tmp_path)
    assert result["correct"] == (fault is None), (compared, details)


@pytest.mark.cuda
@pytest.mark.parametrize("fault", [_unchanged, _half, _altered])
@pytest.mark.parametrize("workload", CELLS)
def test_fault_is_caught_on_the_card(card, monkeypatch, workload, fault):
    from scptoolbox_torch.solvers.ptr import PTR
    monkeypatch.setattr(PTR, "_step_impl", fault(PTR._step_impl))
    result, compared, details = harness.run(
        ROOT, workload, 2 ** 31 + 4242, 10, 0, card, time.time())
    assert result["correct"] is False, (compared, details)
