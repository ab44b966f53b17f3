"""Batched primal-dual interior-point method for conic programs.

Counterpart of `scptoolbox_tpu/ops/ipm.py:434-806`: a homogeneous self-dual
embedding (HSDE) Mehrotra predictor-corrector over zero / nonneg / SOC cones
and the nonsymmetric exponential cone (its blocks start at the barrier's
central points, are scaled by ops/cones.py's BFGS update of mu hess F*(z),
take the central-path target without a Mehrotra term, and keep their gaps
centred by a back-tracking of the step, :532-540, :609, :630-637, :683-706),

    minimize c'x  subject to  A x + s = b,  s in K,

with cone-aware Ruiz equilibration, a windowed stall detector, the
best-iterate fallback, infeasibility certificates and the `enabled` gate.

Where JAX vmaps a `lax.while_loop`, this runs one Python loop over an
explicit leading batch dimension: every scenario carries its own done flag,
and each iteration only computes the scenarios still running (a finished
scenario's state is never touched again), so a batch of B solves returns
what B single solves return.

The KKT solve is pluggable: `builder(spec, A (B, m, n), reg_eps, cone_mask)`
returns an object with `factor(W)` and `solve(fac, rhs (B, n+m, K))`.
"""

from __future__ import annotations

import enum
from typing import NamedTuple, Optional

import torch

from scptoolbox_torch.ops import chol_kernels
from scptoolbox_torch.ops import cones as cn
from scptoolbox_torch.ops import linalg
from scptoolbox_torch.ops.cones import ConeSpec


class IPMStatus(enum.IntEnum):
    OPTIMAL = 0
    PRIMAL_INFEASIBLE = 1
    DUAL_INFEASIBLE = 2
    MAX_ITER = 3
    ALMOST_OPTIMAL = 4


class IPMSolution(NamedTuple):
    x: torch.Tensor
    s: torch.Tensor
    z: torch.Tensor
    status: torch.Tensor
    iters: torch.Tensor
    obj: torch.Tensor
    pres: torch.Tensor
    dres: torch.Tensor
    gap: torch.Tensor
    tau: torch.Tensor
    kappa: torch.Tensor


def _apply_cols(fn, M):
    """Apply a (B, K, m) -> (B, K, m) cone map to the columns of M
    (B, m, K)."""
    return fn(M.transpose(1, 2)).transpose(1, 2)


def _winv_rows(spec, W, M, times):
    """W^-times (1 or 2) applied to the columns of the cone rows' M
    (B, m - nz, k)."""
    if W is None:
        return M
    full = torch.zeros(M.shape[0], spec.m, M.shape[2], dtype=M.dtype,
                       device=M.device)
    full[:, spec.nz:] = M

    def inv(v):
        for _ in range(times):
            v = cn.scale(spec, W, v, inverse=True)
        return v

    return _apply_cols(inv, full)[:, spec.nz:]


def _w2_matvec(spec, W, M, cone_mask):
    """W^2 applied to the columns of M (B, m, K) (0 on zero rows)."""
    if W is None:
        return M * cone_mask[:, None]
    return _apply_cols(
        lambda v: cn.scale(spec, W, cn.scale(spec, W, v)) * cone_mask, M)


class _LUKKT:
    """Dense LU of the regularized quasidefinite augmented system, with two
    refinement rounds against the unregularized operator
    (scptoolbox_tpu/ops/ipm.py:119)."""

    def __init__(self, spec, A, reg_eps, cone_mask):
        self.spec, self.A, self.reg_eps = spec, A, reg_eps
        self.cone_mask = cone_mask
        self.n, self.m = A.shape[2], A.shape[1]

    def factor(self, W):
        n, m, A = self.n, self.m, self.A
        Bn = A.shape[0]
        dt, dev = A.dtype, A.device
        w2 = (cn.w2_dense(self.spec, W) if W is not None
              else torch.diag(self.cone_mask).expand(Bn, m, m))
        eye_n = torch.eye(n, dtype=dt, device=dev) * self.reg_eps
        eye_m = torch.eye(m, dtype=dt, device=dev) * self.reg_eps
        K_reg = torch.cat([
            torch.cat([eye_n.expand(Bn, n, n), A.transpose(1, 2)], dim=2),
            torch.cat([A, -(w2 + eye_m)], dim=2)], dim=1)
        LU, piv = linalg.lu_factor(K_reg)
        return (LU, piv, w2)

    def solve(self, fac, rhs):
        LU, piv, w2 = fac
        n, A = self.n, self.A
        sol = torch.linalg.lu_solve(LU, piv, rhs)
        for _ in range(2):
            resid = rhs - torch.cat(
                [A.transpose(1, 2) @ sol[:, n:],
                 A @ sol[:, :n] - w2 @ sol[:, n:]], dim=1)
            sol = sol + torch.linalg.lu_solve(LU, piv, resid)
        return sol


class _QRCholKKT:
    """Null-space KKT solve (scptoolbox_tpu/ops/ipm.py:158, CVXOPT conelp's
    QR kktsolver): A = [A_E; A_C] with the equality rows first, the complete
    QR A_E' = Q R, Q = [Q1 Q2], computed once per subproblem by
    torch.linalg.qr. Then per IPM iteration the Cholesky factor of the
    reduced normal matrix G'G + eps I, G = W^-1 A_C Q2, and

        R' y1 = rhs_E,  (G'G) y2 = Q2'(rhs_x + A_C' W^-2 rhs_C)
                                   - Q2' A_C' W^-2 A_C Q1 y1,
        dx = Q1 y1 + Q2 y2,  dz_C = W^-2 (A_C dx - rhs_C),
        R dz_E = Q1'(rhs_x - A_C' dz_C),

    refined twice against the exact operator. The factor, its cho_solve and
    both solves with R (solve_lower with L = R', solve_lower_t with the same
    L) go through ops/chol_kernels.py: the card's kernels on a CUDA tensor,
    their plain versions on a CPU one."""

    def __init__(self, spec, A, reg_eps, cone_mask):
        self.spec, self.A, self.reg_eps = spec, A, reg_eps
        self.cone_mask = cone_mask
        self.n, self.m = A.shape[2], A.shape[1]
        self.nz = spec.nz
        Q, R = torch.linalg.qr(A[:, : self.nz].transpose(1, 2),
                               mode="complete")
        self.Q1 = Q[:, :, : self.nz]
        self.Q2 = Q[:, :, self.nz:]
        self.Rt = R[:, : self.nz].transpose(1, 2).contiguous()  # lower
        self.A_C = A[:, self.nz:]

    def factor(self, W):
        G = _winv_rows(self.spec, W, self.A_C @ self.Q2, 1)
        nred = G.shape[2]
        M = G.transpose(1, 2) @ G + self.reg_eps * torch.eye(
            nred, dtype=G.dtype, device=G.device)
        return (chol_kernels.cholesky(M), W)

    def _solve_once(self, fac, rhs):
        L, W = fac
        n, nz = self.n, self.nz
        rx = rhs[:, :n]
        rE = rhs[:, n: n + nz]
        rC = rhs[:, n + nz:]
        ACt = self.A_C.transpose(1, 2)
        w2 = lambda M: _winv_rows(self.spec, W, M, 2)
        y1 = chol_kernels.solve_lower(self.Rt, rE)
        WirC = w2(rC)
        t = self.Q2.transpose(1, 2) @ (rx + ACt @ WirC)
        t = t - self.Q2.transpose(1, 2) @ (ACt @ w2(
            self.A_C @ (self.Q1 @ y1)))
        dx = self.Q1 @ y1 + self.Q2 @ chol_kernels.cho_solve(L, t)
        dzC = w2(self.A_C @ dx) - WirC
        dzE = chol_kernels.solve_lower_t(
            self.Rt, self.Q1.transpose(1, 2) @ (rx - ACt @ dzC))
        return torch.cat([dx, dzE, dzC], dim=1)

    def solve(self, fac, rhs):
        W = fac[1]
        sol = self._solve_once(fac, rhs)
        n = self.n
        for _ in range(2):
            w2z = _w2_matvec(self.spec, W, sol[:, n:], self.cone_mask)
            resid = rhs - torch.cat(
                [self.A.transpose(1, 2) @ sol[:, n:],
                 self.A @ sol[:, :n] - w2z], dim=1)
            sol = sol + self._solve_once(fac, resid)
        return sol


class _SchurKKT:
    """Reduced (normal-equations) KKT solve, the default
    (scptoolbox_tpu/ops/ipm.py:237): the cone rows are eliminated,
    dz_C = W^-2 (A_C dx - rhs_C), leaving the (n + nz) quasidefinite system
    [[H, A_E'], [A_E, -eps I]] with H = A_C' W^-2 A_C + eps I, refined twice
    against the exact operator. `use_lu` follows the device, as the JAX
    package's follows the backend: LU of the whole system on a CPU tensor;
    on the card the Cholesky ladder L_H = chol(H), HiAE = H^-1 A_E',
    L_S = chol(A_E HiAE + reg), on the hand-written kernels of
    ops/chol_kernels.py."""

    refine_rounds = 2

    def __init__(self, spec, A, reg_eps, cone_mask):
        self.spec, self.A, self.reg_eps = spec, A, reg_eps
        self.cone_mask = cone_mask
        self.n, self.m = A.shape[2], A.shape[1]
        self.nz = spec.nz
        self.A_E = A[:, : self.nz]
        self.A_C = A[:, self.nz:]
        self.use_lu = A.device.type == "cpu"

    def factor(self, W):
        n, nz = self.n, self.nz
        dt, dev = self.A.dtype, self.A.device
        Bn = self.A.shape[0]
        WiAC = _winv_rows(self.spec, W, self.A_C, 2)
        H = self.A_C.transpose(1, 2) @ WiAC
        # ~100 eps of the diagonal keeps the factor positive under roundoff
        # near convergence; refinement recovers what the shift costs
        eps_rel = 100.0 * torch.finfo(dt).eps
        reg = self.reg_eps + eps_rel * torch.abs(
            torch.diagonal(H, dim1=1, dim2=2))
        H = H + torch.diag_embed(reg)
        if self.use_lu:
            K = torch.cat([
                torch.cat([H, self.A_E.transpose(1, 2)], dim=2),
                torch.cat([self.A_E, -self.reg_eps * torch.eye(
                    nz, dtype=dt, device=dev).expand(Bn, nz, nz)], dim=2)],
                dim=1)
            return ("lu", linalg.lu_factor(K), W)
        L_H = chol_kernels.cholesky(H)
        HiAE = chol_kernels.cho_solve(L_H, self.A_E.transpose(1, 2))
        S = self.A_E @ HiAE
        reg_s = self.reg_eps + eps_rel * torch.abs(
            torch.diagonal(S, dim1=1, dim2=2))
        L_S = chol_kernels.cholesky(S + torch.diag_embed(reg_s))
        return ("chol", (L_H, HiAE, L_S), W)

    def _solve_once(self, fac, rhs):
        kind, data, W = fac
        n, nz = self.n, self.nz
        rx = rhs[:, :n]
        rE = rhs[:, n: n + nz]
        rC = rhs[:, n + nz:]
        r1 = rx + self.A_C.transpose(1, 2) @ _winv_rows(self.spec, W, rC, 2)
        if kind == "lu":
            sol = torch.linalg.lu_solve(*data, torch.cat([r1, rE], dim=1))
            dx, dzE = sol[:, :n], sol[:, n:]
        else:
            L_H, HiAE, L_S = data
            y = chol_kernels.cho_solve(L_H, r1)
            dzE = chol_kernels.cho_solve(L_S, self.A_E @ y - rE)
            dx = y - HiAE @ dzE
        dzC = _winv_rows(self.spec, W, self.A_C @ dx - rC, 2)
        return torch.cat([dx, dzE, dzC], dim=1)

    def solve(self, fac, rhs):
        W = fac[2]
        sol = self._solve_once(fac, rhs)
        n = self.n
        for _ in range(self.refine_rounds):
            w2z = _w2_matvec(self.spec, W, sol[:, n:], self.cone_mask)
            resid = rhs - torch.cat(
                [self.A.transpose(1, 2) @ sol[:, n:],
                 self.A @ sol[:, :n] - w2z], dim=1)
            sol = sol + self._solve_once(fac, resid)
        return sol


_KKT_METHODS = {"lu": _LUKKT, "qrchol": _QRCholKKT, "schur": _SchurKKT}


def _equilibrate(spec: ConeSpec, A, iters: int = 3):
    """Cone-aware Ruiz equilibration: (R (B, m), D (B, n)) with R A D of
    near-unit row/column inf-norms; uniform within each SOC block and each
    exp block (only a ray scaling keeps exp membership)."""
    Bn, m, n = A.shape
    R = torch.ones(Bn, m, dtype=A.dtype, device=A.device)
    D = torch.ones(Bn, n, dtype=A.dtype, device=A.device)
    blocks = [idx for _, idx in cn.soc_idx(spec, A.device)]
    if spec.nexp > 0:
        blocks.append(cn.exp_idx(spec, A.device))
    for _ in range(iters):
        As = torch.abs(R[:, :, None] * A * D[:, None, :])
        rmax = torch.amax(As, dim=2)
        for idx in blocks:
            blk = torch.amax(rmax[:, idx], dim=2, keepdim=True)
            rmax[:, idx] = blk.expand(Bn, *idx.shape)
        rmax = torch.where(rmax > 0, rmax, torch.ones_like(rmax))
        cmax = torch.amax(As, dim=1)
        cmax = torch.where(cmax > 0, cmax, torch.ones_like(cmax))
        R = R / torch.sqrt(rmax)
        D = D / torch.sqrt(cmax)
    return R, D


def _lambda_min(spec: ConeSpec, v):
    """Smallest cone 'eigenvalue' of v (B, m) -> (B,)."""
    out = torch.full(v.shape[:1], torch.inf, dtype=v.dtype, device=v.device)
    if spec.nl > 0:
        out = torch.minimum(out, torch.amin(v[:, spec.lin_slice], dim=1))
    for d, idx in cn.soc_idx(spec, v.device):
        vb = v[:, idx]
        out = torch.minimum(out, torch.amin(
            vb[..., 0] - torch.linalg.vector_norm(vb[..., 1:], dim=-1),
            dim=1))
    return out


def _shift_interior(spec: ConeSpec, v, margin=1.0):
    """Shift v along the identity until strictly interior (conelp init)."""
    lam_min = _lambda_min(spec, v)
    e = cn.identity_elem(spec, v.dtype, v.device)
    shift = torch.where(lam_min > 1e-8, torch.zeros_like(lam_min),
                        margin - lam_min)
    out = v + shift[:, None] * e
    if spec.nz > 0:
        out[:, spec.zero_slice] = v[:, spec.zero_slice]
    return out


_STATE_KEYS = ("x", "s", "z", "tau", "kappa", "it", "done", "status", "pres",
               "dres", "gap", "best_x", "best_s", "best_z", "best_tau",
               "best_kappa", "best_pres", "best_dres", "best_gap",
               "best_merit", "snap_merit", "snap_it")


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _inf_norm(v):
    return torch.amax(torch.abs(v), dim=-1)


def solve(A, b, c, spec: ConeSpec, *, tol: float = 1e-8,
          tol_almost: float = 1e-5, max_iter: int = 50,
          kkt_method: Optional[str] = None, kkt_builder=None,
          enabled=None, stall_patience: int = 10) -> IPMSolution:
    """Solve min c'x s.t. Ax + s = b, s in K for one problem (A (m, n)) or
    a batch (A (B, m, n), b (B, m), c (B, n)); outputs follow the input's
    batching. `enabled` (B,) bool: a False scenario returns after the
    initialization solve without iterating. `stall_patience`: stop once
    the best merit max(pres, dres, relgap) has not halved over that many
    iterations (the best iterate is returned)."""
    single = A.dim() == 2
    if single:
        A, b, c = A[None], b[None], c[None]
        if enabled is not None:
            enabled = torch.as_tensor(enabled, device=A.device).reshape(1)
    sol = _solve_impl(A, b, c, spec, tol=tol, tol_almost=tol_almost,
                      max_iter=max_iter, kkt_method=kkt_method,
                      kkt_builder=kkt_builder, enabled=enabled,
                      stall_patience=stall_patience)
    if single:
        sol = IPMSolution(*(t[0] for t in sol))
    return sol


def solve_batched(A, b, c, spec: ConeSpec, **kw) -> IPMSolution:
    """Solve over a leading batch axis of (A, b, c)."""
    return _solve_impl(A, b, c, spec, **kw)


def _solve_impl(A, b, c, spec, *, tol=1e-8, tol_almost=1e-5, max_iter=50,
                kkt_method=None, kkt_builder=None, enabled=None,
                stall_patience=10) -> IPMSolution:
    dt, dev = A.dtype, A.device
    Bn, m, n = A.shape
    assert m == spec.m, f"A has {m} rows but spec.m={spec.m}"
    R_eq, D_eq = _equilibrate(spec, A)
    A = R_eq[:, :, None] * A * D_eq[:, None, :]
    b = R_eq * b
    c = D_eq * c
    reg_eps = 1e-10 if dt == torch.float64 else 1e-7
    cone_mask = torch.as_tensor(spec.cone_mask(), dtype=dt, device=dev)
    e = cn.identity_elem(spec, dt, dev)
    deg = spec.degree
    builder = kkt_builder or _KKT_METHODS[kkt_method or "schur"]
    kkt = builder(spec, A, reg_eps, cone_mask)

    one = torch.ones(Bn, dtype=dt, device=dev)
    norm_b = torch.maximum(one, _inf_norm(b))
    norm_c = torch.maximum(one, _inf_norm(c))
    big = torch.full((Bn,), torch.inf, dtype=dt, device=dev)

    # ---------------- initialization (conelp-style) ----------------
    zn = torch.zeros(Bn, n, dtype=dt, device=dev)
    zm = torch.zeros(Bn, m, dtype=dt, device=dev)
    rhs0 = torch.stack([torch.cat([zn, b], 1), torch.cat([-c, zm], 1)], 2)
    sol0 = kkt.solve(kkt.factor(None), rhs0)
    x0 = sol0[:, :n, 0]
    s0 = _shift_interior(spec, -sol0[:, n:, 0] * cone_mask)
    z0 = _shift_interior(spec, sol0[:, n:, 1])
    eidx = cn.exp_idx(spec, dev) if spec.nexp > 0 else None
    if eidx is not None:
        # exp blocks start at the barriers' central points
        s0[:, eidx] = torch.as_tensor(cn.EXP_PRIMAL_CENTRAL, dtype=dt,
                                      device=dev)
        z0[:, eidx] = torch.as_tensor(cn.EXP_DUAL_CENTRAL, dtype=dt,
                                      device=dev)

    def residuals(x, s, z, tau, kappa, Ai, bi, ci):
        rx = (Ai.transpose(1, 2) @ z[:, :, None])[..., 0] + ci * tau[:, None]
        rz = (Ai @ x[:, :, None])[..., 0] + s - bi * tau[:, None]
        rtau = _dot(ci, x) + _dot(bi, z) + kappa
        return rx, rz, rtau

    def convergence(x, s, z, tau, kappa, Ai, bi, ci, nb, nc):
        rx, rz, rtau = residuals(x, s, z, tau, kappa, Ai, bi, ci)
        inv_tau = 1.0 / tau
        pres = _inf_norm(rz) * inv_tau / nb
        dres = _inf_norm(rx) * inv_tau / nc
        pcost = _dot(ci, x) * inv_tau
        dcost = -_dot(bi, z) * inv_tau
        gap = _dot(s, z) * inv_tau * inv_tau
        relgap = gap / torch.clamp(
            torch.minimum(torch.abs(pcost), torch.abs(dcost)), min=1.0)
        optimal = (pres < tol) & (dres < tol) & (relgap < tol)
        bz = _dot(bi, z)
        zbar_scale = torch.where(bz < 0, -1.0 / torch.clamp(bz, max=-1e-30),
                                 torch.zeros_like(bz))
        pinf_res = _inf_norm(
            (Ai.transpose(1, 2) @ z[:, :, None])[..., 0]) * zbar_scale
        pinf = (bz < -tol * nb) & (pinf_res < tol)
        cx = _dot(ci, x)
        xbar_scale = torch.where(cx < 0, -1.0 / torch.clamp(cx, max=-1e-30),
                                 torch.zeros_like(cx))
        dinf_res = _inf_norm((Ai @ x[:, :, None])[..., 0] + s) * xbar_scale
        dinf = (cx < -tol * nc) & (dinf_res < tol)
        status = torch.where(
            optimal, int(IPMStatus.OPTIMAL), torch.where(
                pinf, int(IPMStatus.PRIMAL_INFEASIBLE), torch.where(
                    dinf, int(IPMStatus.DUAL_INFEASIBLE),
                    int(IPMStatus.MAX_ITER)))).to(torch.int32)
        merit = torch.maximum(torch.maximum(pres, dres), relgap)
        merit = torch.where(torch.isfinite(merit), merit,
                            torch.full_like(merit, torch.inf))
        return optimal | pinf | dinf, status, pres, dres, gap, merit

    tau0 = one.clone()
    kap0 = one.clone()
    stop0, status0, pres0, dres0, gap0, merit0 = convergence(
        x0, s0, z0, tau0, kap0, A, b, c, norm_b, norm_c)
    if enabled is not None:
        stop0 = stop0 | ~enabled.to(device=dev, dtype=torch.bool)
    izero = torch.zeros(Bn, dtype=torch.int32, device=dev)
    st = dict(x=x0, s=s0, z=z0, tau=tau0, kappa=kap0, it=izero.clone(),
              done=stop0, status=status0, pres=pres0, dres=dres0, gap=gap0,
              best_x=x0.clone(), best_s=s0.clone(), best_z=z0.clone(),
              best_tau=tau0.clone(), best_kappa=kap0.clone(),
              best_pres=pres0, best_dres=dres0, best_gap=gap0,
              best_merit=merit0, snap_merit=big.clone(),
              snap_it=izero.clone())

    def body(cur, Ai, bi, ci, nb, nc, kkt_i):
        Bs = Ai.shape[0]
        x, s, z, tau, kappa = (cur["x"], cur["s"], cur["z"], cur["tau"],
                               cur["kappa"])
        rx, rz, rtau = residuals(x, s, z, tau, kappa, Ai, bi, ci)
        mu = (_dot(s, z) + tau * kappa) / (deg + 1)
        W = cn.nt_scaling(spec, s, z, mu=mu)
        lam = cn.lambda_vec(spec, W, z)
        fac = kkt_i.factor(W)

        def directions(sigma, eta_corr, dkap_corr):
            one_m_sig = 1.0 - sigma
            d_s = (-cn.cone_product(spec, lam, lam) - eta_corr
                   + (sigma * mu)[:, None] * e)
            d_kap = -tau * kappa - dkap_corr + sigma * mu
            bs = cn.scale(spec, W, cn.cone_div(spec, lam, d_s)) * cone_mask
            if eidx is not None:
                # exp central path s = -mu grad F*(z), linearized: the
                # target goes straight into bs (no Mehrotra term)
                bs[:, eidx] = (-s[:, eidx]
                               - (sigma * mu)[:, None, None] * W.exp_g)
            rhs = torch.stack([
                torch.cat([-ci, bi], 1),
                torch.cat([-one_m_sig[:, None] * rx,
                           -one_m_sig[:, None] * rz - bs], 1)], 2)
            sol = kkt_i.solve(fac, rhs)
            u1, u2 = sol[:, :n, 0], sol[:, n:, 0]
            v1, v2 = sol[:, :n, 1], sol[:, n:, 1]
            denom = _dot(ci, u1) + _dot(bi, u2) - kappa / tau
            numer = (-one_m_sig * rtau - _dot(ci, v1) - _dot(bi, v2)
                     - d_kap / tau)
            dtau = numer / denom
            dx = u1 * dtau[:, None] + v1
            dz = u2 * dtau[:, None] + v2
            ds = (bs - cn.scale(spec, W, cn.scale(spec, W, dz)) * cone_mask
                  ) * cone_mask
            dkap = (d_kap - kappa * dtau) / tau
            return dx, dz, ds, dtau, dkap

        bigs = torch.full((Bs,), torch.inf, dtype=dt, device=dev)

        def step_len(ds, dz, dtau, dkap):
            a_s = cn.max_step(spec, s, ds, dual=False)
            a_z = cn.max_step(spec, z, dz, dual=True)
            a_t = torch.where(dtau < 0,
                              -tau / torch.clamp(dtau, max=-1e-30), bigs)
            a_k = torch.where(dkap < 0,
                              -kappa / torch.clamp(dkap, max=-1e-30), bigs)
            return torch.minimum(torch.minimum(a_s, a_z),
                                 torch.minimum(a_t, a_k))

        zs = torch.zeros(Bs, dtype=dt, device=dev)
        dx_a, dz_a, ds_a, dt_a, dk_a = directions(
            zs, torch.zeros(Bs, m, dtype=dt, device=dev), zs)
        alpha_aff = torch.clamp(step_len(ds_a, dz_a, dt_a, dk_a), max=1.0)
        sigma = torch.clamp((1.0 - alpha_aff) ** 3, 1e-8, 1.0 - 1e-8)
        dz_a_t = cn.scale(spec, W, dz_a) * cone_mask
        ds_a_t = (-lam - dz_a_t) * cone_mask
        eta = cn.cone_product(spec, ds_a_t, dz_a_t)
        dkap_corr = dt_a * dk_a
        dx, dz, ds, dtau, dkap = directions(sigma, eta, dkap_corr)
        alpha = torch.clamp(0.99 * step_len(ds, dz, dtau, dkap), max=1.0)
        if eidx is not None:
            # centrality safeguard: back-track (30 steps of 0.8, on the
            # device) until every exp block keeps s_i'z_i >= 1e-2 mu(alpha)
            se, ze = s[:, eidx], z[:, eidx]
            dse, dze = ds[:, eidx], dz[:, eidx]
            for _ in range(30):
                a1 = alpha[:, None]
                mu_n = (_dot(s + a1 * ds, z + a1 * dz)
                        + (tau + alpha * dtau) * (kappa + alpha * dkap)
                        ) / (deg + 1)
                a2 = alpha[:, None, None]
                gaps = torch.sum((se + a2 * dse) * (ze + a2 * dze), dim=-1)
                ok = (gaps >= 1e-2 * mu_n[:, None]).all(dim=1)
                alpha = torch.where(ok, alpha, 0.8 * alpha)

        x_n = x + alpha[:, None] * dx
        s_n = s + alpha[:, None] * ds
        z_n = z + alpha[:, None] * dz
        tau_n = tau + alpha * dtau
        kap_n = kappa + alpha * dkap
        finite = (torch.isfinite(x_n).all(1) & torch.isfinite(s_n).all(1)
                  & torch.isfinite(z_n).all(1) & torch.isfinite(tau_n)
                  & torch.isfinite(kap_n) & (tau_n > 0))
        f1 = finite[:, None]
        x_n = torch.where(f1, x_n, x)
        s_n = torch.where(f1, s_n, s)
        z_n = torch.where(f1, z_n, z)
        tau_n = torch.where(finite, tau_n, tau)
        kap_n = torch.where(finite, kap_n, kappa)
        it_n = cur["it"] + 1

        stop, status, pres, dres, gap, merit = convergence(
            x_n, s_n, z_n, tau_n, kap_n, Ai, bi, ci, nb, nc)
        better = merit < cur["best_merit"]
        best_merit_n = torch.minimum(merit, cur["best_merit"])
        window = (it_n - cur["snap_it"]) >= stall_patience
        stalled = window & (best_merit_n > 0.5 * cur["snap_merit"])
        adv_snap = window & ~stalled
        pick = lambda a, b_: torch.where(
            better.reshape((-1,) + (1,) * (a.dim() - 1)), a, b_)
        return dict(
            x=x_n, s=s_n, z=z_n, tau=tau_n, kappa=kap_n, it=it_n,
            done=stop | ~finite | stalled, status=status,
            pres=pres, dres=dres, gap=gap,
            snap_merit=torch.where(adv_snap, best_merit_n,
                                   cur["snap_merit"]),
            snap_it=torch.where(adv_snap, it_n, cur["snap_it"]),
            best_x=pick(x_n, cur["best_x"]), best_s=pick(s_n, cur["best_s"]),
            best_z=pick(z_n, cur["best_z"]),
            best_tau=pick(tau_n, cur["best_tau"]),
            best_kappa=pick(kap_n, cur["best_kappa"]),
            best_pres=pick(pres, cur["best_pres"]),
            best_dres=pick(dres, cur["best_dres"]),
            best_gap=pick(gap, cur["best_gap"]),
            best_merit=pick(merit, cur["best_merit"]))

    while True:
        act = (~st["done"]) & (st["it"] < max_iter)
        if not bool(act.any()):
            break
        if bool(act.all()):
            new = body(st, A, b, c, norm_b, norm_c, kkt)
            st = new
            continue
        idx = act.nonzero()[:, 0]
        Ai = A[idx]
        kkt_i = builder(spec, Ai, reg_eps, cone_mask)
        new = body({k: st[k][idx] for k in _STATE_KEYS}, Ai, b[idx], c[idx],
                   norm_b[idx], norm_c[idx], kkt_i)
        st = {k: st[k].index_copy(0, idx, new[k]) for k in _STATE_KEYS}

    # best-iterate fallback; certificates keep the final iterate
    is_cert = ((st["status"] == int(IPMStatus.PRIMAL_INFEASIBLE))
               | (st["status"] == int(IPMStatus.DUAL_INFEASIBLE)))
    _, _, fpres, fdres, fgap, fmerit = convergence(
        st["x"], st["s"], st["z"], st["tau"], st["kappa"], A, b, c, norm_b,
        norm_c)
    use_best = (~is_cert) & (st["best_merit"] < fmerit)
    sel = lambda a, b_: torch.where(
        use_best.reshape((-1,) + (1,) * (a.dim() - 1)), a, b_)
    x_f = sel(st["best_x"], st["x"])
    s_f = sel(st["best_s"], st["s"])
    z_f = sel(st["best_z"], st["z"])
    tau_f = sel(st["best_tau"], st["tau"])
    kap_f = sel(st["best_kappa"], st["kappa"])
    pres_f = sel(st["best_pres"], fpres)
    dres_f = sel(st["best_dres"], fdres)
    gap_f = sel(st["best_gap"], fgap)
    merit_f = torch.minimum(st["best_merit"], fmerit)
    status = torch.where(
        (st["status"] == int(IPMStatus.MAX_ITER)) & (merit_f < tol_almost),
        torch.full_like(st["status"], int(IPMStatus.ALMOST_OPTIMAL)),
        st["status"])
    inv_tau = 1.0 / tau_f
    scale_out = torch.where(is_cert, torch.ones_like(inv_tau), inv_tau)
    x = x_f * scale_out[:, None] * D_eq
    s = s_f * scale_out[:, None] / R_eq
    z = z_f * scale_out[:, None] * R_eq
    return IPMSolution(x=x, s=s, z=z, status=status, iters=st["it"],
                       obj=_dot(c / D_eq, x), pres=pres_f, dres=dres_f,
                       gap=gap_f, tau=tau_f, kappa=kap_f)
