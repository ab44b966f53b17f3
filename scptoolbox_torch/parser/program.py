"""Direct conic-program modeling layer: `ConicProgram` on the PyTorch IPM.

Counterpart of `scptoolbox_tpu/parser/program.py:88`, exponential-cone
and GEOM constraints included (:300, :405), with the introspection
accessors `constraints`, `variables`, `parameters`, `describe` and
`__repr__` (:310-365) and the host C++ IPM as `solve(backend="native")`
(:368-412). Constraints are PyTorch functions of the variable blocks (and
parameters) returning lists of ConeCon, affine in the variables; costs are
affine or convex quadratic. Their structure is extracted exactly by
`torch.func.jacfwd` / `hessian`, and the program lowers to one dense
(A, b, c) solved by ops.ipm.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch
from torch.func import grad, hessian, jacfwd

from scptoolbox_torch.config import default_dtype, resolve_device
from scptoolbox_torch.ops import ipm
from scptoolbox_torch.parser.problem import ConeKind
from scptoolbox_torch.solvers.subproblem import Assembler, RowPlan, VarLayout
from scptoolbox_torch.solvers.template import (BlockPoster,
                                               post_quadratic_epigraphs)


def _interleave(order, vvals, pvals):
    vi = iter(vvals)
    pi = iter(pvals)
    return [next(vi) if tok == "v" else next(pi) for tok in order]


class Var(NamedTuple):
    name: str
    shape: Tuple[int, ...]


class Par(NamedTuple):
    name: str
    shape: Tuple[int, ...]


class ProgramSolution(NamedTuple):
    values: Dict[str, torch.Tensor]
    obj: torch.Tensor
    status: torch.Tensor
    duals: Dict[str, torch.Tensor]
    x: torch.Tensor
    z: torch.Tensor
    iters: torch.Tensor


class _Constraint(NamedTuple):
    name: str
    fn: Callable
    var_args: Tuple[Var, ...]
    par_args: Tuple[Par, ...]
    order: Tuple[str, ...]
    posters: Tuple[BlockPoster, ...]


class _Cost(NamedTuple):
    fn: Callable
    var_args: Tuple[Var, ...]
    par_args: Tuple[Par, ...]
    order: Tuple[str, ...]


class ConicProgram:
    """min sum(costs) s.t. cone constraints, over named variable blocks.

        prg = ConicProgram(device="cpu")
        x = prg.variable("x", N, 2)
        tf = prg.parameter("tf", 1.0)
        prg.add_constraint("dyn", lambda x, tf: [zero(...)], (x, tf))
        prg.add_cost(lambda x: torch.sum(x ** 2), (x,))
        prg.build()
        sol = prg.solve(tf=2.0)

    Runs on the card unless `device` says otherwise."""

    def __init__(self, dtype=None, device=None):
        self.device = resolve_device(device)
        self.dtype = dtype or default_dtype(self.device)
        self.layout = VarLayout()
        self.plan = RowPlan()
        self._vars: Dict[str, Var] = {}
        self._pars: Dict[str, Tuple[Par, torch.Tensor]] = {}
        self._cons: List[_Constraint] = []
        self._costs: List[_Cost] = []
        self._scales: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
        self._built = False
        self._n_epi = 0
        self._cost_linear: List[bool] = []

    def _t(self, v):
        return torch.as_tensor(v, dtype=self.dtype, device=self.device)

    def variable(self, name: str, *shape: int) -> Var:
        assert not self._built
        v = Var(name, tuple(int(s) for s in shape))
        self.layout.add(name, *shape)
        self._vars[name] = v
        return v

    def parameter(self, name: str, example) -> Par:
        assert not self._built
        val = self._t(example)
        p = Par(name, tuple(val.shape))
        self._pars[name] = (p, val)
        return p

    def scale(self, var: Var, S, c) -> None:
        """Diagonal scaling advice x = S .* x_hat .+ c."""
        self._scales[var.name] = (
            torch.broadcast_to(self._t(S), var.shape).reshape(-1),
            torch.broadcast_to(self._t(c), var.shape).reshape(-1))

    def _split_args(self, args):
        var_args = tuple(a for a in args if isinstance(a, Var))
        par_args = tuple(a for a in args if isinstance(a, Par))
        assert len(var_args) + len(par_args) == len(args)
        return var_args, par_args

    def _example_values(self, var_args, par_args):
        vvals = [torch.zeros(v.shape, dtype=self.dtype, device=self.device)
                 for v in var_args]
        pvals = [self._pars[p.name][1] for p in par_args]
        return vvals, pvals

    def add_constraint(self, name: str, fn: Callable, args: Sequence) -> None:
        assert not self._built
        var_args, par_args = self._split_args(args)
        order = tuple("v" if isinstance(a, Var) else "p" for a in args)
        vvals, pvals = self._example_values(var_args, par_args)
        cons = fn(*_interleave(order, vvals, pvals))
        posters = tuple(
            BlockPoster(f"{name}{i}", c.kind, int(np.prod(c.v.shape)), 1,
                        self.layout, self.plan)
            for i, c in enumerate(cons))
        self._cons.append(_Constraint(name, fn, var_args, par_args, order,
                                      posters))

    def add_cost(self, fn: Callable, args: Sequence) -> None:
        assert not self._built
        var_args, par_args = self._split_args(args)
        order = tuple("v" if isinstance(a, Var) else "p" for a in args)
        self._costs.append(_Cost(fn, var_args, par_args, order))
        nd = sum(int(np.prod(v.shape)) for v in var_args)
        _, pvals = self._example_values(var_args, par_args)
        scalar = self._scalar(fn, var_args, order, pvals)
        H = hessian(scalar)(torch.zeros(nd, dtype=self.dtype,
                                        device=self.device))
        linear = bool(torch.max(torch.abs(H)) == 0.0)
        self._cost_linear.append(linear)
        if not linear:
            self.layout.add(f"_t_cost{self._n_epi}")
            self.plan.soc(f"_cost_epi{self._n_epi}", 1, nd + 2)
        self._n_epi += 1

    @staticmethod
    def _scalar(fn, var_args, order, pv):
        sizes = [int(np.prod(v.shape)) for v in var_args]

        def scalar(vec):
            parts = torch.split(vec, sizes)
            shaped = [q.reshape(v.shape) for q, v in zip(parts, var_args)]
            return torch.as_tensor(fn(*_interleave(order, shaped, pv)),
                                   dtype=vec.dtype)

        return scalar

    def build(self) -> None:
        assert not self._built
        self.spec = self.plan.freeze()
        self.n = self.layout.n
        self.m = self.plan.m
        S = torch.ones(self.n, dtype=self.dtype, device=self.device)
        c = torch.zeros(self.n, dtype=self.dtype, device=self.device)
        for name, (Sv, cv) in self._scales.items():
            S[self.layout.sl(name)] = Sv
            c[self.layout.sl(name)] = cv
        self._S_full, self._c_full = S, c
        self._built = True

    def _assemble(self, pvals: Dict[str, torch.Tensor]):
        asm = Assembler(self.m, self.n, 1, self.dtype, self.device)
        for con in self._cons:
            sizes = [int(np.prod(v.shape)) for v in con.var_args]
            cols = np.concatenate(
                [self.layout.idx(v.name).reshape(-1) for v in con.var_args])
            pv = [pvals[p.name] for p in con.par_args]

            def stacked(vec, con=con, sizes=sizes, pv=pv):
                parts = torch.split(vec, sizes)
                shaped = [q.reshape(v.shape)
                          for q, v in zip(parts, con.var_args)]
                cons_out = con.fn(*_interleave(con.order, shaped, pv))
                return torch.cat([cc.v.reshape(-1) for cc in cons_out])

            at0 = torch.zeros(int(sum(sizes)), dtype=self.dtype,
                              device=self.device)
            v0 = stacked(at0)
            J = jacfwd(stacked)(at0).to(self.dtype)
            off = 0
            for po in con.posters:
                po.post(asm, self.plan, self.layout, cols[None, :],
                        J[None, off:off + po.dim, :], v0[None, off:off + po.dim])
                off += po.dim

        for i, cost in enumerate(self._costs):
            sizes = [int(np.prod(v.shape)) for v in cost.var_args]
            cols = np.concatenate(
                [self.layout.idx(v.name).reshape(-1) for v in cost.var_args])
            pv = [pvals[p.name] for p in cost.par_args]
            scalar = self._scalar(cost.fn, cost.var_args, cost.order, pv)
            d0 = torch.zeros(int(sum(sizes)), dtype=self.dtype,
                             device=self.device)
            c0 = scalar(d0)
            g = grad(scalar)(d0).to(self.dtype)
            if self._cost_linear[i]:
                asm.add_c(cols, g)
                asm.add_const(c0)
            else:
                H = hessian(scalar)(d0).to(self.dtype)
                post_quadratic_epigraphs(
                    asm, self.plan.rows(f"_cost_epi{i}"), cols[None, :],
                    self.layout.idx(f"_t_cost{i}").reshape(1),
                    H[None], g[None], c0[None], d0[None])
                asm.add_c(self.layout.idx(f"_t_cost{i}").reshape(1),
                          torch.ones(1, dtype=self.dtype, device=self.device))
        A, b, c, const = asm.finish(self._S_full, self._c_full)
        return A[0], b[0], c[0], const[0]

    # -- introspection (the JAX package's regex accessors and summary) ----

    def constraints(self, pattern: str = ".*"):
        """[(name, kind names, dims)] of the constraint groups whose name
        matches the regex."""
        rx = re.compile(pattern)
        return [(c.name, tuple(p.kind.name for p in c.posters),
                 tuple(p.dim for p in c.posters))
                for c in self._cons if rx.search(c.name)]

    def variables(self, pattern: str = ".*"):
        """[(name, shape)] of the variable blocks matching the regex."""
        rx = re.compile(pattern)
        return [(name, v.shape) for name, v in self._vars.items()
                if rx.search(name)]

    def parameters(self, pattern: str = ".*"):
        """[(name, shape)] of the parameter blocks matching the regex."""
        rx = re.compile(pattern)
        return [(name, p.shape) for name, (p, _) in self._pars.items()
                if rx.search(name)]

    def describe(self) -> str:
        """The program's summary: variables, parameters, constraint blocks
        and costs."""
        lines = [f"ConicProgram ({'built' if self._built else 'unbuilt'}): "
                 f"{self.layout.n} variables"
                 + (f", {self.plan.m} rows" if self._built else "")]
        shp = lambda s: "scalar" if not s else str(s)
        if self._vars:
            lines.append("  variables:")
            lines += [f"    {name}: {shp(v.shape)}"
                      for name, v in self._vars.items()]
        if self._pars:
            lines.append("  parameters:")
            lines += [f"    {name}: {shp(p.shape)}"
                      for name, (p, _) in self._pars.items()]
        if self._cons:
            lines.append("  constraints:")
            for c in self._cons:
                blocks = ", ".join(
                    f"{p.kind.name}({p.dim})" for p in c.posters)
                lines.append(f"    {c.name}: {blocks}")
        if self._costs:
            lines.append(f"  costs: {len(self._costs)} term(s)"
                         + ("" if all(self._cost_linear)
                            else " (quadratic epigraphs lowered)"))
        return "\n".join(lines)

    def __repr__(self) -> str:
        return self.describe()

    def solve(self, tol: float = 1e-8, max_iter: int = 60,
              backend: str = "torch", **params) -> ProgramSolution:
        """Solve with the given parameter values (defaults otherwise).

        backend="torch" runs the IPM of ops/ipm.py on the program's device;
        backend="native" the host C++ IPM (scptoolbox_torch/native.py) in
        float64, for small programs where a device round trip costs more
        than the solve. The native backend raises where its library cannot
        be built (no g++) and on exponential-cone programs; any other
        backend raises."""
        assert self._built, "call build() first"
        if backend not in ("torch", "native"):
            raise ValueError(f"unknown backend {backend!r}: 'torch' or "
                             "'native'")
        pvals = {name: self._t(params.get(name, default))
                 for name, (_, default) in self._pars.items()}
        A, b, c, const = self._assemble(pvals)
        if backend == "native":
            return self._solve_native(A, b, c, const, tol, max_iter)
        sol = ipm.solve(A, b, c, self.spec, tol=tol, max_iter=max_iter)
        return self._solution(sol.x, sol.z, sol.obj + const, sol.status,
                              sol.iters)

    def _solve_native(self, A, b, c, const, tol, max_iter
                      ) -> ProgramSolution:
        """The assembled program on the host C++ IPM; the solution comes
        back as tensors on the program's device and dtype."""
        from scptoolbox_torch import native

        if not native.available():
            raise RuntimeError("the native backend cannot be built: "
                               f"{native.build_error()}")
        nsol = native.solve(A, b, c, self.spec, tol=tol, max_iter=max_iter)
        return self._solution(
            self._t(nsol.x), self._t(nsol.z),
            self._t(nsol.obj) + const,
            torch.tensor(int(nsol.status), dtype=torch.int32,
                         device=self.device),
            torch.tensor(nsol.iters, dtype=torch.int32, device=self.device))

    def _solution(self, x, z, obj, status, iters) -> ProgramSolution:
        """Values and duals by name from the scaled solution x and the
        duals z."""
        d = self._S_full * x + self._c_full
        values = {name: d[self.layout.sl(name)].reshape(v.shape)
                  for name, v in self._vars.items()}
        duals = {}
        for con in self._cons:
            for i, po in enumerate(con.posters):
                nm = f"{con.name}{i}"
                if po.kind in (ConeKind.ZERO, ConeKind.NONPOS):
                    duals[nm] = z[torch.as_tensor(
                        self.plan.rows(nm), device=self.device)]
                elif po.kind in (ConeKind.SOC, ConeKind.GEOM,
                                 ConeKind.EXP):
                    duals[nm] = z[torch.as_tensor(
                        self.plan.rows(nm), device=self.device)].reshape(-1)
        return ProgramSolution(values=values, obj=obj, status=status,
                               duals=duals, x=d, z=z, iters=iters)
