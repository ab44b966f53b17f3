"""A plain dense interior-point solver for a batch of convex quadratic
programs, in float64:

    minimize 0.5 z'Pz + c'z  subject to  A z = b,  G z <= h,

Mehrotra's predictor-corrector on the reduced KKT system
[[P + G' D G, A'], [A, 0]] (D = lambda / s), one LU factorization a loop
and two rounds of iterative refinement a solve,
every row of A and G equilibrated to unit largest coefficient. Written for
the benchmark's reference: independent of the program under test, exact to
round-off rather than fast.
"""

from __future__ import annotations

import torch


def _max_step(v, dv):
    """Largest a in [0, 1] with v + a dv >= 0, per batch entry."""
    ratio = torch.where(dv < 0, -v / dv, torch.full_like(v, float("inf")))
    return torch.clamp(ratio.amin(dim=1), max=1.0)


def solve_qp(P, c, A, b, G, h, tol=1e-9, max_iter=120):
    """P (S, n, n), c (S, n), A (S, p, n), b (S, p), G (S, m, n), h (S, m).
    Returns (z (S, n), objective (S,), converged (S,) bool)."""
    ra = A.abs().amax(dim=2).clamp(min=1e-300)
    A, b = A / ra[..., None], b / ra
    rg_ = G.abs().amax(dim=2).clamp(min=1e-300)
    G, h = G / rg_[..., None], h / rg_
    S, n = c.shape
    p, m = A.shape[1], G.shape[1]
    Gt, At = G.transpose(1, 2), A.transpose(1, 2)
    zeros_pp = torch.zeros(S, p, p, dtype=c.dtype, device=c.device)

    def factor(D):
        H = P + Gt @ (D[..., None] * G)
        K = torch.cat([torch.cat([H, At], 2), torch.cat([A, zeros_pp], 2)], 1)
        Ks[0] = K
        if K.device.type == "cpu":
            # batched LU of wide matrices hangs under MKL with several
            # threads: one matrix at a time
            parts = [torch.linalg.lu_factor(k) for k in K]
            return (torch.stack([a for a, _ in parts]),
                    torch.stack([b_ for _, b_ in parts]))
        return torch.linalg.lu_factor(K)

    Ks = [None]

    def kkt_solve(LU, r1, r2):
        """The reduced KKT system, with two rounds of iterative refinement
        (its matrix grows ill-conditioned as the iterates converge)."""
        rhs = torch.cat([r1, r2], 1)[..., None]
        sol = torch.linalg.lu_solve(*LU, rhs)
        for _ in range(2):
            sol = sol + torch.linalg.lu_solve(*LU, rhs - Ks[0] @ sol)
        return sol[:, :n, 0], sol[:, n:, 0]

    # the start of CVXOPT's conelp: the least-squares primal point
    # (min ||s|| with G z + s = h, A z = b) and dual point (min ||lambda||
    # with G' lambda + A' y + c = 0), each moved into the cone's interior
    LU = factor(torch.ones(S, m, dtype=c.dtype, device=c.device))
    z, y = kkt_solve(LU, (Gt @ h[..., None])[..., 0], b)
    v, y = kkt_solve(LU, -c, torch.zeros_like(b))
    s = h - (G @ z[..., None])[..., 0]
    lam = (G @ v[..., None])[..., 0]
    s = s + (1.0 - s.amin(dim=1)).clamp(min=0.0)[:, None]
    lam = lam + (1.0 - lam.amin(dim=1)).clamp(min=0.0)[:, None]
    done = torch.zeros(S, dtype=torch.bool, device=c.device)
    scale_c = 1.0 + c.abs().amax(dim=1)
    scale_b = 1.0 + b.abs().amax(dim=1) if p else torch.ones_like(scale_c)
    scale_h = 1.0 + h.abs().amax(dim=1)
    for _ in range(max_iter):
        Pz = (P @ z[..., None])[..., 0]
        rd = Pz + c + (Gt @ lam[..., None])[..., 0]
        if p:
            rd = rd + (At @ y[..., None])[..., 0]
        rp = (A @ z[..., None])[..., 0] - b
        rgv = (G @ z[..., None])[..., 0] + s - h
        mu = (s * lam).sum(dim=1) / m
        pobj = 0.5 * (z * Pz).sum(dim=1) + (c * z).sum(dim=1)
        done = done | (((rp.abs().amax(dim=1) if p else 0.0) / scale_b
                          < tol)
                       & (rgv.abs().amax(dim=1) / scale_h < tol)
                       & (m * mu / (1.0 + pobj.abs()) < tol)
                       # the dual residual stalls above round-off as the
                       # system grows ill-conditioned; the objective is
                       # then settled to about tol
                       & (rd.abs().amax(dim=1) / scale_c < tol ** 0.5))
        if bool(done.all()):
            break
        D = lam / s
        LU = factor(D)

        def direction(rc):
            dz, dy = kkt_solve(LU, -rd - (Gt @ (D * rgv - rc / s)[..., None]
                                         )[..., 0], -rp)
            dlam = D * ((G @ dz[..., None])[..., 0] + rgv) - rc / s
            ds = -(rc + s * dlam) / lam
            return dz, dy, ds, dlam

        dz, dy, ds, dlam = direction(s * lam)
        a = torch.minimum(_max_step(s, ds), _max_step(lam, dlam))
        mu_aff = ((s + a[:, None] * ds) * (lam + a[:, None] * dlam)
                  ).sum(dim=1) / m
        sigma = (mu_aff / mu) ** 3
        dz, dy, ds, dlam = direction(s * lam + ds * dlam
                                     - (sigma * mu)[:, None])
        a = 0.99 * torch.minimum(_max_step(s, ds), _max_step(lam, dlam))
        a = torch.where(done, torch.zeros_like(a), torch.clamp(a, max=1.0))
        z = z + a[:, None] * dz
        y = y + a[:, None] * dy
        s = s + a[:, None] * ds
        lam = lam + a[:, None] * dlam
    Pz = (P @ z[..., None])[..., 0]
    return z, 0.5 * (z * Pz).sum(dim=1) + (c * z).sum(dim=1), done
