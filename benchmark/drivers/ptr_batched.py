"""Window driver: the body of the program's `PTR.solve_batched`, one batched
SCP iteration at a time, and its comparison with the plain reference.

A batch of scenarios is started (`_batched_start`), stepped one batched SCP
iteration at a time (`_batched_iteration`) until every scenario has stopped
or the traffic's cap is reached, and closed (`_batched_result`). The
configuration names the solver class, its parameters' class and values,
the problem and the reference model; the traffic the batch, the spread of
the guess multipliers and the cap.
"""

from __future__ import annotations

import collections
import importlib
from pathlib import Path

import numpy as np
import torch

from benchmark.reference.check import judge
from benchmark.reference.model import load as load_ref_model
from benchmark.reference.ptr_step import F64, RefPTR

# the solver's calls the traced run wraps in host-clock spans
SPANS = ("_discretize", "_assemble", "_solve_sub")


def resolve(path: str):
    """The object `module:attribute` names."""
    mod, _, attr = path.partition(":")
    return getattr(importlib.import_module(mod), attr)


def build_solver(cfg, device):
    """The program's problem and solver as the configuration states."""
    prog, sv = cfg["program"], cfg["solver"]
    subst = {"$device": str(device), "$N": sv["params"]["N"]}
    params = resolve(prog["params_class"])(**prog.get("params", {}))
    kwargs = {k: subst.get(v, v) if isinstance(v, str) else v
              for k, v in prog.get("problem_kwargs", {}).items()}
    pbm = resolve(prog["problem"])(params, **kwargs)
    pars = resolve(sv["params_class"])(**sv["params"])
    return resolve(sv["class"])(pbm, pars, dtype=getattr(torch, cfg["dtype"]),
                                device=device)


def multipliers(seed: int, batch_index: int, B: int, spread: float,
                midpoints: bool = False):
    """The batch's guess multipliers, uniform on [1 - spread, 1 + spread]:
    one in each of B equal strata, at a seeded place in it, in a seeded
    order. With `midpoints`, at each stratum's midpoint, so that every
    seed gives the same set of scenarios in another order."""
    rng = np.random.default_rng([int(seed) % (1 << 63), batch_index])
    u = (np.arange(B) + (0.5 if midpoints else rng.random(B))) / B
    return 1.0 + spread * (2.0 * rng.permutation(u) - 1.0)


class Recorder:
    """Wraps the solver's `_step_impl` to keep a few rows of each step's
    inputs and outputs (drawn from the seed) for the reference."""

    def __init__(self, solver, rows_per_step, seed):
        self.solver = solver
        self.inner = solver._step_impl
        self.k = int(rows_per_step)
        self.rng = np.random.default_rng([int(seed) % (1 << 63), 7])
        self.records = []
        solver._step_impl = self

    def __call__(self, ref_x, ref_u, ref_p, dltv, J_aug_ref, consts=None):
        out = self.inner(ref_x, ref_u, ref_p, dltv, J_aug_ref, consts)
        n = ref_x.shape[0]
        rows = np.sort(self.rng.choice(n, size=min(self.k, n),
                                       replace=False))
        r = torch.as_tensor(rows, device=ref_x.device)
        keep = lambda a: a[r].detach().clone()
        blocks = ("A", "Bm", "Bp", "F", "r", "defects")
        self.records.append(dict(
            rows=rows, xb=keep(ref_x), ub=keep(ref_u), pb=keep(ref_p),
            J_in=keep(J_aug_ref),
            disc_in={k: keep(getattr(dltv, k)) for k in blocks},
            disc_out={k: keep(getattr(out["dltv"], k)) for k in blocks},
            **{k: keep(out[k]) for k in (
                "x", "u", "p", "J_aug", "J_orig", "defect_norm",
                "deviation", "improv_rel")}))
        return out

    def remove(self):
        self.solver._step_impl = self.inner


class Driver:
    spans = SPANS

    def __init__(self, cfg, traffic, seed, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.solver = build_solver(cfg, device)
        self.cap = int(traffic["iter_cap"])
        self.recorder = None

    def _inputs(self, index):
        s = self.solver
        gx, gu, gp = s._guess
        B = int(self.traffic["batch"])
        m = torch.as_tensor(multipliers(
            self.seed, index, B, float(self.traffic["spread"]),
            self.traffic.get("in_stratum") == "midpoint"),
                            dtype=s.dtype, device=gx.device)
        return (gx[None] * m[:, None, None],
                gu[None].expand(B, *gu.shape).clone(),
                gp[None].expand(B, *gp.shape).clone())

    def warm(self):
        """Set-up's share of the window's work: batch 0 of the seed started
        and its first batched iteration run, at the cell's batch. Where the
        traffic's `continue_warm` is true, the batch is returned and the
        window goes on with it from its second iteration, so that a window
        that holds part of one batch holds iterations of one kind."""
        batch = self.start(0)
        self.step(batch, 0)
        batch["first_it"] = 1
        return batch if self.traffic.get("continue_warm") else None

    def start(self, index):
        return dict(index=index, result=None,
                    state=self.solver._batched_start(*self._inputs(index)))

    def step(self, batch, it):
        """Batched iteration `it`; False once the batch has stopped."""
        if it >= self.cap:
            return False
        n_rec = len(self.recorder.records) if self.recorder else 0
        ran = self.solver._batched_iteration(batch["state"], it)
        if ran and it + 1 == self.cap:
            batch["result"] = self.solver._batched_result(batch["state"])
        if self.recorder:
            for r in self.recorder.records[n_rec:]:
                r.update(batch=batch, it=it)
        return ran

    # ---- the program's counters -------------------------------------
    @staticmethod
    def launch_counts():
        from scptoolbox_torch.ops import chol_kernels, lu_kernels
        return {**lu_kernels.launch_counts(),
                **chol_kernels.launch_counts()}

    @staticmethod
    def shapes_on():
        importlib.import_module("scptoolbox_torch.ops.cuda_lib"
                                ).launch_shapes = collections.Counter()

    @staticmethod
    def shapes_off():
        lib = importlib.import_module("scptoolbox_torch.ops.cuda_lib")
        shapes, lib.launch_shapes = lib.launch_shapes, None
        return dict(shapes)

    def record(self, on):
        if on:
            chk = self.traffic.get("check", {})
            self.recorder = Recorder(self.solver,
                                     chk.get("rows_per_step", 1), self.seed)
        elif self.recorder:
            self.recorder.remove()

    def tally(self, batches, steps):
        """What the window did, from the loop's traces and final states;
        annotates each step with its active scenarios and IPM loops."""
        attempted = failed = 0
        stop_iters, st_counts, ipm_counts = [], collections.Counter(), \
            collections.Counter()
        for batch in batches:
            state = batch["state"]
            # a batch that set-up started: its first iterations are set-up's
            first = batch.get("first_it", 0)
            for k, tr in enumerate(state["traces"][first:]):
                act = tr["active"]
                step = steps[batch["first_step"] + k]
                step["active"] = int(act.sum())
                step["ipm_loops"] = (int(tr["ipm_iters"][act].max()) + 1
                                     if bool(act.any()) else 0)
                attempted += int(act.sum())
                failed += int((act & ~torch.isfinite(tr["J_aug"])).sum())
            done, status = state["done"], state["status"]
            stopped = done.clone()
            if batch["result"] is not None:   # the cap: every one stops
                status = batch["result"]["status"]
                failed += int((~done & (status != 0)).sum())
                stopped[:] = True
            stop_iters += state["iters"][stopped].tolist()
            st_counts.update(status[stopped].tolist())
            ipm_counts.update(state["ipmst"].tolist())
        note = (f"scp status of stopped scenarios {dict(st_counts)}, last "
                f"ipm status of every scenario {dict(ipm_counts)}")
        return dict(attempted=attempted, failed=failed,
                    stop_iters=stop_iters, note=note)

    # ---- the comparison with the reference ----------------------------
    def sample(self, batches, device):
        """A sample of the recorded rows drawn from the seed, the window's
        last step in it, stacked in float64; each row with its stop
        decision as the program's batch state records it."""
        records = self.recorder.records
        rows = [(ri, j) for ri, r in enumerate(records) if "batch" in r
                for j in range(len(r["rows"]))]
        count = self.traffic.get("check", {}).get("samples", 8)
        rng = np.random.default_rng([self.seed % (1 << 63), 11])
        last = [x for x in rows if x[0] == rows[-1][0]]
        rest = [x for x in rows if x[0] != rows[-1][0]]
        take = min(max(int(count) - len(last), 0), len(rest))
        pick = last + [rest[i] for i in sorted(rng.choice(
            len(rest), take, replace=False))]
        out = collections.defaultdict(list)
        for ri, j in pick:
            r = records[ri]
            state = r["batch"]["state"]
            act = state["traces"][r["it"]]["active"].nonzero()[:, 0]
            sid = act[int(r["rows"][j])]
            stopped = bool(state["done"][sid]) and int(
                state["iters"][sid]) == r["it"] + 1
            for k, v in r.items():
                if k in ("disc_in", "disc_out"):
                    for kk, vv in v.items():
                        out[k + "." + kk].append(vv[j])
                elif isinstance(v, torch.Tensor):
                    out[k].append(v[j])
            out["it"].append(torch.tensor(r["it"]))
            out["stopped"].append(torch.tensor(stopped))
        stacked = {}
        for k, v in out.items():
            t = torch.stack([a.to(device) for a in v])
            stacked[k] = t.to(F64) if t.is_floating_point() else t
        s = {k: v for k, v in stacked.items() if "." not in k}
        for grp in ("disc_in", "disc_out"):
            s[grp] = {k.split(".")[1]: v for k, v in stacked.items()
                      if k.startswith(grp + ".")}
        self.guess = [a.detach().cpu().double().numpy()
                      for a in self.solver._guess]
        return s

    def free(self):
        """Drop the program's state before the reference runs."""
        self.recorder = self.solver = None

    def check(self, root, samples, device):
        """The numbers compared: the reference PTR iteration on every
        sampled row, and the program's guess as the reference model
        checks it."""
        cfg = self.cfg
        ref_cfg, sv = cfg["reference"], cfg["solver"]["params"]
        N = int(sv["N"])
        model = load_ref_model(
            Path(root) / "benchmark" / "reference" / "models",
            ref_cfg["model"], cfg["program"].get("params", {}), N)
        start = model.check_guess(*self.guess)
        ref = RefPTR(model, N, sv["Nsub"], sv["wvc"], sv["wtr"], device)
        pars = dict(eps_abs=sv["eps_abs"], eps_rel=sv["eps_rel"],
                    feas_tol=sv["feas_tol"])
        return judge(ref, samples, pars, start_gap=start,
                     delta=float(ref_cfg.get("delta", 1e-4)))
