"""The plain reference of one PTR iteration, in float64 (after the penalized
trust-region method of Reynolds, Szmuk, Malyuk and Acikmese, SCPToolbox.jl
ptr.jl): first-order-hold discretization about a reference trajectory, the
convex subproblem with virtual controls, virtual buffers, relaxed boundary
conditions and an infinity-norm trust region, solved by `qp.solve_qp`, and
the quantities of the stopping rule.

The subproblem, for references (xb, ub, pb) on the grid t_k = k / (N - 1):

    minimize  J(x, u, p) + wtr (trapz(eta_x) + trapz(eta_u) + eta_p)
              + wvc (sum_k w_k ||nu_k||_1 + trapz(sum vs) + ||vic||_1
                     + ||vtc||_1)
    s.t.  x_{k+1} = A_k x_k + Bm_k u_k + Bp_k u_{k+1} + F_k p + r_k + nu_k
          convex(t_k, x_k, u_k, p) <= 0           (affine, exact)
          s(zb_k) + ds(zb_k) (z_k - zb_k) <= vs_k,  vs_k >= 0
          gic, gtc linearized = vic, vtc          (free, penalized)
          ||(x_k - xb_k) / Sx||_inf <= eta_x_k, and likewise for u and p,

with w the trapezoid weights, J the terminal cost (linear) plus trapz of
the running cost (convex quadratic, exact), and (S, c) the scaling boxes
of the model. Every variable is solved for in scaled form.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import jacfwd, vmap

from benchmark.reference.qp import solve_qp

F64 = torch.float64


def trapezoid_weights(t):
    dt = np.diff(t)
    w = np.zeros(len(t))
    w[:-1] += dt / 2
    w[1:] += dt / 2
    return w


def _box(lo, hi, dim):
    if dim == 0:
        return np.ones(0), np.zeros(0)
    S = np.asarray(hi, float) - np.asarray(lo, float)
    return np.where(S < 1e-8, 1.0, S), np.asarray(lo, float)


class RefPTR:
    """The reference PTR iteration for one model on N nodes."""

    def __init__(self, model, N, Nsub, wvc, wtr, device):
        self.m, self.N, self.Nsub = model, int(N), int(Nsub)
        self.wvc, self.wtr = float(wvc), float(wtr)
        self.dev = torch.device(device)
        self.t = np.linspace(0.0, 1.0, self.N)
        self.w = trapezoid_weights(self.t)
        T = lambda a: torch.as_tensor(np.asarray(a, float), dtype=F64,
                                      device=self.dev)
        Sx, cx = _box(model.x_lo, model.x_hi, model.nx)
        Su, cu = _box(model.u_lo, model.u_hi, model.nu)
        Sp, cp = _box(model.p_lo, model.p_hi, model.np)
        self.Sx, self.cx, self.Su, self.cu = T(Sx), T(cx), T(Su), T(cu)
        self.Sp, self.cp = T(Sp), T(cp)
        self.T = T

    # ---- discretization ------------------------------------------------
    def discretize(self, x, u, p):
        """FOH about references x (S, N, nx), u (S, N, nu), p (S, np): the
        state transition Phi and its inverse Psi integrated with Nsub RK4
        steps an interval. Returns A, Bm, Bp, F, r, defects (S, N-1, ...)."""
        m = self.m
        S, N, nx = x.shape
        nu, npp = u.shape[2], p.shape[1]
        M = S * (N - 1)
        xk = x[:, :-1].reshape(M, nx)
        uk, uk1 = u[:, :-1].reshape(M, nu), u[:, 1:].reshape(M, nu)
        pk = p.repeat_interleave(N - 1, dim=0)
        tg = self.T(self.t)
        tk = tg[:-1].repeat(S)
        hk = (tg[1:] - tg[:-1]).repeat(S)

        def one(t, xx, uu, pp):
            g = lambda a, b_, c_: (m.f(t, a, b_, c_),) * 2
            (Ja, Jb, Jc), val = jacfwd(g, argnums=(0, 1, 2), has_aux=True)(
                xx, uu, pp)
            return val, Ja, Jb, Jc

        fj = vmap(one)

        def rhs(tau, st):
            X, Phi, Psi, Bm, Bp, Fp, _ = st
            sp = tau / hk
            uu = uk + (uk1 - uk) * sp[:, None]
            fx, At, Bt, Ft = fj(tk + tau, X, uu, pk)
            PsiB = Psi @ Bt
            return (fx, At @ Phi, -Psi @ At, (1.0 - sp)[:, None, None] * PsiB,
                    sp[:, None, None] * PsiB, Psi @ Ft, Psi)

        eye = torch.eye(nx, dtype=F64, device=self.dev).expand(M, nx, nx)
        st = (xk, eye, eye, xk.new_zeros(M, nx, nu), xk.new_zeros(M, nx, nu),
              xk.new_zeros(M, nx, npp), xk.new_zeros(M, nx, nx))
        dsub = hk / self.Nsub
        ax = lambda a, k, s_: tuple(si + a.reshape(-1, *[1] * (si.dim() - 1))
                                    * ki for si, ki in zip(s_, k))
        for i in range(self.Nsub):
            tau = i * dsub
            k1 = rhs(tau, st)
            k2 = rhs(tau + dsub / 2, ax(dsub / 2, k1, st))
            k3 = rhs(tau + dsub / 2, ax(dsub / 2, k2, st))
            k4 = rhs(tau + dsub, ax(dsub, k3, st))
            st = tuple(s_ + dsub.reshape(-1, *[1] * (s_.dim() - 1)) / 6
                       * (a + 2 * b_ + 2 * c_ + d)
                       for s_, a, b_, c_, d in zip(st, k1, k2, k3, k4))
        xprop, Phi = st[0], st[1]
        A, Bm, Bp, F = Phi, Phi @ st[3], Phi @ st[4], Phi @ st[5]
        mv = lambda Mx, v: (Mx @ v[..., None])[..., 0]
        r = xprop - mv(A, xk) - mv(Bm, uk) - mv(Bp, uk1) - mv(F, pk)
        sh = lambda a: a.reshape((S, N - 1) + a.shape[1:])
        return dict(A=sh(A), Bm=sh(Bm), Bp=sh(Bp), F=sh(F), r=sh(r),
                    defects=x[:, 1:] - sh(xprop))

    def defect_norm(self, x, u, p):
        d = self.discretize(x, u, p)["defects"]
        return torch.amax(torch.abs(d / self.Sx), dim=(1, 2))

    # ---- costs ----------------------------------------------------------
    def original_cost(self, x, u, p):
        """Terminal cost plus trapz of the running cost, (S,)."""
        m, S, N = self.m, x.shape[0], self.N
        J = torch.zeros(S, dtype=F64, device=self.dev)
        if m.terminal is not None:
            J = J + vmap(m.terminal)(x[:, -1], p)
        if m.running is not None:
            tt = self.T(self.t).repeat(S)
            vals = vmap(m.running)(tt, x.reshape(S * N, -1),
                                   u.reshape(S * N, -1),
                                   p.repeat_interleave(N, dim=0))
            J = J + (vals.reshape(S, N) * self.T(self.w)).sum(dim=1)
        return J

    def deviation(self, x, p, xb, pb):
        """max_k ||(x_k - xb_k) / Sx||_inf + ||(p - pb) / Sp||_inf, (S,)."""
        dx = torch.amax(torch.abs((x - xb) / self.Sx), dim=(1, 2))
        if p.shape[1]:
            dx = dx + torch.amax(torch.abs((p - pb) / self.Sp), dim=1)
        return dx

    # ---- the subproblem ---------------------------------------------------
    def solve(self, xb, ub, pb, disc=None, near=None, delta=0.0):
        """The subproblem about (xb, ub, pb), solved: (x, u, p, J_aug,
        converged), J_aug the optimal value with every constant term. With
        `near` = (x, u, p), the scaled x, u and p are held within `delta` of
        it: the least J_aug of the points that near."""
        if disc is None:
            disc = self.discretize(xb, ub, pb)
        P, c, k0, A, b, G, h, lay = self._qp(xb, ub, pb, disc)
        if near is not None:
            zc = torch.cat([((near[0] - self.cx) / self.Sx).flatten(1),
                            ((near[1] - self.cu) / self.Su).flatten(1),
                            (near[2] - self.cp) / self.Sp], 1)
            cols = torch.cat([lay["x"], lay["u"], lay["p"]])
            cnt, S = cols.numel(), zc.shape[0]
            Gb = torch.zeros(S, 2 * cnt, c.shape[1], dtype=F64,
                             device=self.dev)
            r_ = torch.arange(cnt, device=self.dev)
            Gb[:, r_, cols] = 1.0
            Gb[:, r_ + cnt, cols] = -1.0
            G = torch.cat([G, Gb], 1)
            h = torch.cat([h, zc + delta, -zc + delta], 1)
        z, obj, ok = solve_qp(P, c, A, b, G, h)
        x, u, p = self._unpack(z, lay)
        return x, u, p, obj + k0, ok

    def _unpack(self, z, lay):
        S, N, m = z.shape[0], self.N, self.m
        x = z[:, lay["x"]].reshape(S, N, m.nx) * self.Sx + self.cx
        u = z[:, lay["u"]].reshape(S, N, m.nu) * self.Su + self.cu
        p = z[:, lay["p"]] * self.Sp + self.cp
        return x, u, p

    def _qp(self, xb, ub, pb, disc):
        m, N, dev = self.m, self.N, self.dev
        S, nx, nu, npp = xb.shape[0], m.nx, m.nu, m.np
        tg = self.T(self.t)
        t_fl = tg.repeat(S)
        x_fl, u_fl = xb.reshape(S * N, nx), ub.reshape(S * N, nu)
        p_fl = pb.repeat_interleave(N, dim=0)
        nodes = lambda a: a.reshape((S, N) + a.shape[1:])
        ns = (m.ncvx(tg[0], xb[0, 0], ub[0, 0], pb[0]).shape[0]
              if m.ncvx else 0)
        nic = m.gic(xb[0, 0], pb[0]).shape[0] if m.gic else 0
        ntc = m.gtc(xb[0, -1], pb[0]).shape[0] if m.gtc else 0

        lay, n = {}, 0
        for name, size in (("x", N * nx), ("u", N * nu), ("p", npp),
                           ("nu", (N - 1) * nx), ("wnu", (N - 1) * nx),
                           ("vs", N * ns), ("vic", 2 * nic),
                           ("vtc", 2 * ntc), ("ex", N), ("eu", N),
                           ("ep", 1 if npp else 0)):
            lay[name] = torch.arange(n, n + size, device=dev)
            n += size
        ix = lay["x"].reshape(N, nx)
        iu = lay["u"].reshape(N, nu)
        ip = lay["p"]
        Sx, Su, Sp = self.Sx, self.Su, self.Sp
        z = lambda *sh: torch.zeros(*sh, dtype=F64, device=dev)
        blocks_eq, blocks_in = [], []

        def rows(count):
            return z(S, count, n), z(S, count)

        # dynamics, scaled variables: x = Sx xh + cx, nu = Sx nuh
        Ad, bd = rows((N - 1) * nx)
        Ad4 = Ad.view(S, N - 1, nx, n)
        ar = torch.arange(N - 1, device=dev)
        for i in range(nx):
            Ad4[:, ar, i, ix[1:, i]] = Sx[i]
            Ad4[:, ar, i, lay["nu"].reshape(N - 1, nx)[:, i]] = -Sx[i]
        for k in range(N - 1):
            Ad4[:, k, :, ix[k]] -= disc["A"][:, k] * Sx
            Ad4[:, k, :, iu[k]] -= disc["Bm"][:, k] * Su
            Ad4[:, k, :, iu[k + 1]] -= disc["Bp"][:, k] * Su
            if npp:
                Ad4[:, k, :, ip] -= disc["F"][:, k] * Sp
        mv = lambda Mx, v: (Mx @ v[..., None])[..., 0]
        bd = (disc["r"] - self.cx + mv(disc["A"], self.cx.expand(S, N - 1, nx))
              + mv(disc["Bm"] + disc["Bp"], self.cu.expand(S, N - 1, nu)))
        if npp:
            bd = bd + mv(disc["F"], self.cp.expand(S, N - 1, npp))
        blocks_eq.append((Ad, bd.reshape(S, -1)))

        # |nu| <= wnu
        Gw, hw = rows(2 * (N - 1) * nx)
        r_ = torch.arange((N - 1) * nx, device=dev)
        Gw[:, r_, lay["nu"]] = 1.0
        Gw[:, r_, lay["wnu"]] = -1.0
        Gw[:, r_ + (N - 1) * nx, lay["nu"]] = -1.0
        Gw[:, r_ + (N - 1) * nx, lay["wnu"]] = -1.0
        blocks_in.append((Gw, hw))

        def affine(fn, with_u):
            """Rows J z + v0 of fn linearized at the references: J over
            (x, u, p) scaled, per node (S, N, d, n), and v0 (S, N, d)."""
            args = (t_fl, x_fl, u_fl, p_fl)
            val = vmap(fn)(*args)
            Jx, Ju, Jp = vmap(jacfwd(fn, argnums=(1, 2, 3)))(*args)
            d = val.shape[1]
            v0 = (val - mv(Jx, x_fl) - mv(Ju, u_fl) - mv(Jp, p_fl)
                  + mv(Jx, self.cx.expand(S * N, nx))
                  + mv(Ju, self.cu.expand(S * N, nu)))
            if npp:
                v0 = v0 + mv(Jp, self.cp.expand(S * N, npp))
            J = z(S, N, d, n)
            Jx, Ju, Jp = nodes(Jx), nodes(Ju), nodes(Jp)
            for k in range(N):
                J[:, k, :, ix[k]] = Jx[:, k] * Sx
                J[:, k, :, iu[k]] = Ju[:, k] * Su
                if npp:
                    J[:, k, :, ip] = Jp[:, k] * Sp
            return J, nodes(v0), d

        if m.convex is not None:
            fn = lambda t, x, u, p: m.convex(t, x, u, p)
            J, v0, d = affine(fn, True)
            blocks_in.append((J.reshape(S, N * d, n), -v0.reshape(S, -1)))
        if ns:
            J, v0, d = affine(m.ncvx, True)
            ivs = lay["vs"].reshape(N, ns)
            for k in range(N):
                J[:, k, torch.arange(ns, device=dev), ivs[k]] = -1.0
            blocks_in.append((J.reshape(S, N * ns, n), -v0.reshape(S, -1)))
            Gv, hv = rows(N * ns)
            Gv[:, torch.arange(N * ns, device=dev), lay["vs"]] = -1.0
            blocks_in.append((Gv, hv))

        def bc(fn, node, name, cnt):
            xn = xb[:, node]
            g0 = vmap(fn)(xn, pb)
            Hx, Kp = vmap(jacfwd(fn, argnums=(0, 1)))(xn, pb)
            Ab, _ = rows(cnt)
            Ab[:, :, ix[node]] = Hx * Sx
            if npp:
                Ab[:, :, ip] = Kp * Sp
            iv = lay[name]
            Ab[:, torch.arange(cnt, device=dev), iv[:cnt]] = 1.0
            Ab[:, torch.arange(cnt, device=dev), iv[cnt:]] = -1.0
            rhs = -(g0 - mv(Hx, xn) + mv(Hx, self.cx.expand(S, nx)))
            if npp:
                rhs = rhs - (-mv(Kp, pb) + mv(Kp, self.cp.expand(S, npp)))
            blocks_eq.append((Ab, rhs))
            Gn, hn = rows(2 * cnt)
            Gn[:, torch.arange(2 * cnt, device=dev), iv] = -1.0
            blocks_in.append((Gn, hn))

        if nic:
            bc(m.gic, 0, "vic", nic)
        if ntc:
            bc(m.gtc, N - 1, "vtc", ntc)

        # trust region: +-(zh - zbh) <= eta
        def trust(idx, zb_h, eta_idx):
            cnt = idx.numel()
            Gt, ht = rows(2 * cnt)
            r2 = torch.arange(cnt, device=dev)
            flat_idx = idx.reshape(-1)
            eta = eta_idx.reshape(-1, 1).expand(idx.shape).reshape(-1)
            Gt[:, r2, flat_idx] = 1.0
            Gt[:, r2, eta] = -1.0
            Gt[:, r2 + cnt, flat_idx] = -1.0
            Gt[:, r2 + cnt, eta] = -1.0
            zb = zb_h.reshape(S, -1)
            ht[:, :cnt], ht[:, cnt:] = zb, -zb
            blocks_in.append((Gt, ht))

        trust(ix, (xb - self.cx) / Sx, lay["ex"])
        trust(iu, (ub - self.cu) / Su, lay["eu"])
        if npp:
            trust(ip.reshape(1, npp), ((pb - self.cp) / Sp)[:, None],
                  lay["ep"])

        # the cost: penalties, the terminal cost (linear), the running cost
        # (convex quadratic, its second-order expansion exact)
        c = z(S, n)
        P = z(S, n, n)
        k0 = z(S)
        w = self.T(self.w)
        c[:, lay["ex"]] += self.wtr * w
        c[:, lay["eu"]] += self.wtr * w
        if npp:
            c[:, lay["ep"]] += self.wtr
        c[:, lay["wnu"]] += (self.wvc * w[:-1, None] * Sx).reshape(-1)
        if ns:
            c[:, lay["vs"]] += (self.wvc * w[:, None]).expand(
                N, ns).reshape(-1)
        for name in ("vic", "vtc"):
            c[:, lay[name]] += self.wvc
        if m.terminal is not None:
            xN = xb[:, -1]
            phi = vmap(m.terminal)(xN, pb)
            gx, gp = vmap(jacfwd(m.terminal, argnums=(0, 1)))(xN, pb)
            c[:, ix[-1]] += gx * Sx
            k0 = k0 + phi - (gx * (xN - self.cx)).sum(1)
            if npp:
                c[:, ip] += gp * Sp
                k0 = k0 - (gp * (pb - self.cp)).sum(1)
        if m.running is not None:
            def run(zz, t):
                return m.running(t, zz[:nx], zz[nx:nx + nu], zz[nx + nu:])

            zc = torch.cat([x_fl, u_fl, p_fl], 1)
            r0 = vmap(run)(zc, t_fl)
            g = vmap(jacfwd(run))(zc, t_fl)
            H = vmap(jacfwd(jacfwd(run)))(zc, t_fl)
            scl = torch.cat([Sx, Su, Sp])
            off = torch.cat([self.cx, self.cu, self.cp])
            d0 = (zc - off) / scl            # the references, scaled
            gs, Hs = g * scl, H * scl[:, None] * scl[None, :]
            gs, Hs, r0, d0 = nodes(gs), nodes(Hs), nodes(r0), nodes(d0)
            for k in range(N):
                cols = torch.cat([ix[k], iu[k], ip])
                lin = gs[:, k] - mv(Hs[:, k], d0[:, k])
                c[:, cols] += w[k] * lin
                P[:, cols[:, None], cols[None, :]] += w[k] * Hs[:, k]
                k0 = k0 + w[k] * (r0[:, k] - (gs[:, k] * d0[:, k]).sum(1)
                                  + 0.5 * (d0[:, k] * mv(Hs[:, k], d0[:, k])
                                           ).sum(1))
        A = torch.cat([a for a, _ in blocks_eq], 1)
        b = torch.cat([v for _, v in blocks_eq], 1)
        G = torch.cat([a for a, _ in blocks_in], 1)
        h = torch.cat([v for _, v in blocks_in], 1)
        return P, c, k0, A, b, G, h, lay
