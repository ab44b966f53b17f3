"""Cone toolkit for the batched IPM: zero / nonneg / second-order /
exponential cones.

Counterpart of `scptoolbox_tpu/ops/cones.py` (`EXP_PRIMAL_CENTRAL` /
`EXP_DUAL_CENTRAL` :45-47, `ConeSpec` :52 with `exp_indices` :102,
`_exp_dual_barrier` :142, `exp_dual_grad_hess` :150, `exp_interior` :158,
`max_step` :214, `nt_scaling` :311, `scale` :391, `w2_dense` :408,
`lambda_vec` :436, `exp_violation` :477, `violation` :499). Every function
works on a trailing cone dimension m with any leading batch dimensions:
vectors are (B, m) or (B, K, m). The scaling of a batch of iterates carries
a leading B on each of its fields, and applying it to (B, K, m) broadcasts
over K.

The flat slack/dual layout is [zero | nonneg | soc_1 | ... | soc_k |
exp_1 | ... | exp_j]; SOC blocks of equal dimension are processed together
as one (..., k, d) tensor, the 3-row exp blocks as one (..., j, 3) tensor.
Exponential cone (MOI ordering):

  K_exp  = cl{(x, y, z) : y > 0,  y e^{x/y} <= z}
  K_exp* = cl{(u, v, w) : u < 0,  -u e^{v/u} <= e w}

with the dual barrier F*(u,v,w) = -log(u log(-u/w) + v - u) - log(-u)
- log w. Its blocks are scaled by a primal-dual BFGS update of
mu hess F*(z), not by the Jordan algebra of the symmetric cones.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch


# central points e* of the exp-cone barriers (grad F(e*) = -e*)
EXP_PRIMAL_CENTRAL = (-0.8278384059008612, 0.8051020015847954,
                      1.2909277098569585)
EXP_DUAL_CENTRAL = (-1.0513839437502288, 0.5564096194693704,
                    1.2589678864644602)


@dataclasses.dataclass(frozen=True)
class ConeSpec:
    """Static description of a product cone
    K = 0^nz x R+^nl x SOC(d1) x ... x EXP^nexp."""

    nz: int = 0
    nl: int = 0
    socs: Tuple[int, ...] = ()
    nexp: int = 0

    def __post_init__(self):
        object.__setattr__(self, "socs", tuple(int(d) for d in self.socs))
        assert all(d >= 2 for d in self.socs), "SOC blocks need dim >= 2"

    @property
    def m(self) -> int:
        return self.nz + self.nl + sum(self.socs) + 3 * self.nexp

    @property
    def cone_dim(self) -> int:
        return self.nl + sum(self.socs) + 3 * self.nexp

    @property
    def degree(self) -> int:
        return self.nl + len(self.socs) + 3 * self.nexp

    def soc_groups(self) -> Dict[int, np.ndarray]:
        """Map soc dim -> array of start offsets (into the full m-vector)."""
        groups: Dict[int, list] = {}
        off = self.nz + self.nl
        for d in self.socs:
            groups.setdefault(d, []).append(off)
            off += d
        return {d: np.asarray(s, dtype=np.int64) for d, s in groups.items()}

    def soc_indices(self) -> Dict[int, np.ndarray]:
        """Map soc dim -> (num_blocks, dim) absolute row indices."""
        return {d: s[:, None] + np.arange(d)[None, :]
                for d, s in self.soc_groups().items()}

    def exp_indices(self) -> np.ndarray:
        """(nexp, 3) absolute row indices of the exp blocks (after the SOC
        blocks)."""
        off = self.nz + self.nl + sum(self.socs)
        return (off + 3 * np.arange(self.nexp)[:, None]
                + np.arange(3)[None, :])

    @property
    def lin_slice(self) -> slice:
        return slice(self.nz, self.nz + self.nl)

    @property
    def zero_slice(self) -> slice:
        return slice(0, self.nz)

    def cone_mask(self, dtype=float) -> np.ndarray:
        """(m,) mask: 1 on nonneg/SOC rows, 0 on zero-cone rows."""
        mask = np.ones(self.m, dtype=dtype)
        mask[: self.nz] = 0
        return mask


@functools.lru_cache(maxsize=None)
def _soc_idx(spec: ConeSpec, device: torch.device):
    """SOC index tensors on `device`: ((dim, (k, dim) LongTensor), ...)."""
    return tuple((d, torch.as_tensor(idx, device=device))
                 for d, idx in spec.soc_indices().items())


def soc_idx(spec: ConeSpec, device) -> Tuple[Tuple[int, torch.Tensor], ...]:
    return _soc_idx(spec, torch.device(device))


@functools.lru_cache(maxsize=None)
def _exp_idx(spec: ConeSpec, device: torch.device):
    return torch.as_tensor(spec.exp_indices(), device=device)


def exp_idx(spec: ConeSpec, device) -> torch.Tensor:
    """The (nexp, 3) exp-block row indices as a LongTensor on `device`."""
    return _exp_idx(spec, torch.device(device))


def _bw(w: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """View a scaling field w (B, *f) so it broadcasts against a vector
    batch v (B, ..., m): one singleton dim after B per extra lead dim."""
    extra = v.dim() - 2
    if extra <= 0:
        return w
    return w.reshape(w.shape[:1] + (1,) * extra + w.shape[1:])


def identity_elem(spec: ConeSpec, dtype, device) -> torch.Tensor:
    """Jordan identity e: 0 on zero rows, 1 on nonneg, (1,0,..,0) per SOC."""
    e = np.zeros(spec.m)
    e[spec.lin_slice] = 1.0
    off = spec.nz + spec.nl
    for d in spec.socs:
        e[off] = 1.0
        off += d
    return torch.as_tensor(e, dtype=dtype, device=device)


def exp_dual_grad_hess(zb):
    """Gradient (..., 3) and Hessian (..., 3, 3) of the dual barrier
    F*(u,v,w) = -log(psi) - log(-u) - log(w), psi = u log(-u/w) + v - u,
    at blocks zb (..., 3) strictly inside K_exp*, in closed form."""
    u, v, w = zb[..., 0], zb[..., 1], zb[..., 2]
    lg = torch.log(-u / w)
    psi = u * lg + v - u
    # grad psi = (log(-u/w), 1, -u/w); hess psi = [[1/u, 0, -1/w], [0, 0, 0],
    # [-1/w, 0, u/w^2]]
    dpsi = torch.stack([lg, torch.ones_like(u), -u / w], dim=-1)
    g = -dpsi / psi[..., None] - torch.stack(
        [1.0 / u, torch.zeros_like(u), 1.0 / w], dim=-1)
    z = torch.zeros_like(u)
    h2 = torch.stack([torch.stack([1.0 / u, z, -1.0 / w], -1),
                      torch.stack([z, z, z], -1),
                      torch.stack([-1.0 / w, z, u / w ** 2], -1)], -2)
    H = (-h2 / psi[..., None, None]
         + dpsi[..., :, None] * dpsi[..., None, :] / (psi ** 2)[..., None,
                                                                 None]
         + torch.diag_embed(torch.stack([1.0 / u ** 2, z, 1.0 / w ** 2],
                                        -1)))
    return g, H


def exp_interior(vb, dual: bool, margin=0.0):
    """(...,) bool: strict interior membership of blocks vb (..., 3) in
    K_exp (dual=False) or K_exp* (dual=True), with an optional margin on
    the barrier argument; the logs are guarded."""
    a, b, c = vb[..., 0], vb[..., 1], vb[..., 2]
    one = torch.ones_like(a)
    if dual:
        # u < 0, w > 0, u log(-u/w) + v - u > margin
        pos = (a < 0.0) & (c > 0.0)
        psi = a * torch.log(torch.where(pos, -a, one)
                            / torch.where(pos, c, one)) + b - a
        return pos & (psi > margin)
    # y > 0, z > 0, y log(z/y) - x > margin
    pos = (b > 0.0) & (c > 0.0)
    r = b * torch.log(torch.where(pos, c, one)
                      / torch.where(pos, b, one)) - a
    return pos & (r > margin)


def exp_violation(vb) -> torch.Tensor:
    """Feasibility gap of blocks vb (..., 3) against K_exp, 0 iff in the
    cone: max(0, x - y log(z/y), -z) for y, z > 0; max(-z, y) for y > 0,
    z <= 0 (outside the cone by at least y); max(x, -z, -y) on the face
    y <= 0."""
    x, y, z = vb[..., 0], vb[..., 1], vb[..., 2]
    ypos = y > 0.0
    zpos = z > 0.0
    one = torch.ones_like(y)
    r_int = torch.maximum(x - y * torch.log(torch.where(zpos, z, one)
                                            / torch.where(ypos, y, one)), -z)
    r_face = torch.maximum(x, torch.maximum(-z, -y))
    r_ynegz = torch.maximum(-z, y)
    r = torch.where(ypos & zpos, r_int, torch.where(ypos, r_ynegz, r_face))
    return torch.clamp(r, min=0.0)


def cone_product(spec: ConeSpec, u, v) -> torch.Tensor:
    """Jordan product u o v (0 on zero rows; elementwise on nonneg; arrow
    product on SOC blocks)."""
    out = torch.zeros_like(u)
    sl = spec.lin_slice
    out[..., sl] = u[..., sl] * v[..., sl]
    for d, idx in soc_idx(spec, u.device):
        ub = u[..., idx]
        vb = v[..., idx]
        head = torch.sum(ub * vb, dim=-1, keepdim=True)
        tail = ub[..., :1] * vb[..., 1:] + vb[..., :1] * ub[..., 1:]
        out[..., idx] = torch.cat([head, tail], dim=-1)
    return out


def cone_div(spec: ConeSpec, lam, v) -> torch.Tensor:
    """Solve lam o x = v for x (inverse arrow operator per block)."""
    out = torch.zeros_like(v)
    sl = spec.lin_slice
    out[..., sl] = v[..., sl] / lam[..., sl]
    for d, idx in soc_idx(spec, v.device):
        lb = lam[..., idx]
        vb = v[..., idx]
        l0, l1 = lb[..., :1], lb[..., 1:]
        v0, v1 = vb[..., :1], vb[..., 1:]
        det = l0 ** 2 - torch.sum(l1 ** 2, dim=-1, keepdim=True)
        x0 = (l0 * v0 - torch.sum(l1 * v1, dim=-1, keepdim=True)) / det
        x1 = (v1 - x0 * l1) / l0
        out[..., idx] = torch.cat([x0, x1], dim=-1)
    return out


def max_step(spec: ConeSpec, u, du, big: float = 1e12,
             dual: bool = False) -> torch.Tensor:
    """Largest alpha >= 0 with u + alpha*du in K (zero rows ignored), per
    leading batch entry: u, du (B, m) -> (B,), capped at `big`. `dual`
    selects K_exp* for the exp blocks (pass True when stepping z)."""
    bigt = torch.full(u.shape[:-1], big, dtype=u.dtype, device=u.device)
    alpha = bigt
    sl = spec.lin_slice
    if spec.nl > 0:
        ul = u[..., sl]
        dl = du[..., sl]
        neg = dl < 0
        cand = torch.where(neg, -ul / torch.where(neg, dl, -1.0),
                           torch.full_like(ul, big))
        alpha = torch.minimum(alpha, cand.min(dim=-1).values)
    for d, idx in soc_idx(spec, u.device):
        ub = u[..., idx]
        db = du[..., idx]
        u0, u1 = ub[..., 0], ub[..., 1:]
        d0, d1 = db[..., 0], db[..., 1:]
        a = d0 ** 2 - torch.sum(d1 ** 2, dim=-1)
        b = 2.0 * (u0 * d0 - torch.sum(u1 * d1, dim=-1))
        c = u0 ** 2 - torch.sum(u1 ** 2, dim=-1)
        disc = b ** 2 - 4.0 * a * c
        sqrt_disc = torch.sqrt(torch.clamp(disc, min=0.0))
        q = -0.5 * (b + torch.sign(b + (b == 0).to(b.dtype)) * sqrt_disc)
        bigk = torch.full_like(a, big)
        r1 = torch.where(a != 0, q / torch.where(a != 0, a, 1.0), bigk)
        r2 = torch.where(q != 0, c / torch.where(q != 0, q, 1.0), bigk)

        def pos_or_big(r):
            return torch.where((r > 0) & (disc >= 0), r, bigk)

        root = torch.minimum(pos_or_big(r1), pos_or_big(r2))
        head = torch.where(d0 < 0, -u0 / torch.where(d0 < 0, d0, -1.0), bigk)
        alpha = torch.minimum(alpha,
                              torch.minimum(root, head).min(dim=-1).values)
    alpha = torch.minimum(alpha, bigt)
    if spec.nexp > 0:
        # the feasible alphas of a ray from an interior point form an
        # interval [0, a*): 90 bisection steps on strict-interior
        # membership, unless the whole step is feasible; every step stays
        # on the device (no host sync)
        idx = exp_idx(spec, u.device)
        ub, db = u[..., idx], du[..., idx]

        def feas(a):
            return exp_interior(ub + a[..., None, None] * db, dual).all(-1)

        lo, hi = torch.zeros_like(alpha), alpha
        for _ in range(90):
            mid = 0.5 * (lo + hi)
            ok = feas(mid)
            lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
        alpha = torch.where(feas(alpha), alpha, lo)
    return alpha


class NTScaling(NamedTuple):
    """Scaling point for R+^nl x SOC products x EXP^nexp, per batch entry.
    Nesterov-Todd on the symmetric cones:
      w_l:  (B, nl) with W_lin = diag(w_l)
      socs: per dim-group (eta (B, k, 1), wbar (B, k, d)) with
            W_soc = eta * [[w0, w1'], [w1, I + w1 w1'/(1+w0)]].
    A primal-dual BFGS scaling on the exp blocks (None without them):
      exp_W / exp_Winv: (B, j, 3, 3) symmetric square root of W^2 and its
                        inverse; exp_H: (B, j, 3, 3) W^2 itself;
      exp_g: (B, j, 3) the dual barrier's gradient at z."""

    w_l: torch.Tensor
    socs: Tuple[Tuple[torch.Tensor, torch.Tensor], ...]
    soc_dims: Tuple[int, ...]
    exp_W: Optional[torch.Tensor] = None
    exp_Winv: Optional[torch.Tensor] = None
    exp_H: Optional[torch.Tensor] = None
    exp_g: Optional[torch.Tensor] = None


def nt_scaling(spec: ConeSpec, s, z, mu=None) -> NTScaling:
    """The scaling from strictly interior s, z (B, m); every sqrt argument is
    floored at `tiny` so boundary-grazing iterates degrade gracefully. `mu`
    (the barrier parameter) is required when the spec has exp blocks."""
    tiny = 1e-300 if s.dtype == torch.float64 else 1e-30
    sl = spec.lin_slice
    w_l = (torch.sqrt(torch.clamp(s[..., sl] / z[..., sl], min=tiny))
           if spec.nl > 0 else s[..., :0])
    socs = []
    dims = []
    for d, idx in soc_idx(spec, s.device):
        sb = s[..., idx]
        zb = z[..., idx]
        J = torch.cat([torch.ones(1, dtype=s.dtype, device=s.device),
                       -torch.ones(d - 1, dtype=s.dtype, device=s.device)])
        res_s = torch.sqrt(torch.clamp(
            torch.sum(sb * sb * J, dim=-1, keepdim=True), min=tiny))
        res_z = torch.sqrt(torch.clamp(
            torch.sum(zb * zb * J, dim=-1, keepdim=True), min=tiny))
        sbar = sb / res_s
        zbar = zb / res_z
        gamma = torch.sqrt(torch.clamp(
            (1.0 + torch.sum(sbar * zbar, dim=-1, keepdim=True)) / 2.0,
            min=tiny))
        wbar = (sbar + zbar * J) / (2.0 * gamma)
        eta = torch.sqrt(torch.clamp(res_s / res_z, min=tiny))
        socs.append((eta, wbar))
        dims.append(d)
    exp_W = exp_Winv = exp_H = exp_g = None
    if spec.nexp > 0:
        assert mu is not None, "exp-cone scaling needs the barrier parameter"
        idx = exp_idx(spec, s.device)
        zb, sb = z[..., idx], s[..., idx]
        g, H = exp_dual_grad_hess(zb)
        # start from mu_b hess F*(z), mu_b = s'z / 3 per block, and apply the
        # BFGS double rank-1 update so that the secant W^2 z = s holds
        sz = torch.clamp(torch.sum(sb * zb, dim=-1), min=tiny)
        H0 = (sz / 3.0)[..., None, None] * H
        H0z = (H0 @ zb[..., None])[..., 0]
        zH0z = torch.clamp(torch.sum(zb * H0z, dim=-1), min=tiny)
        W2 = (H0 - H0z[..., :, None] * H0z[..., None, :]
              / zH0z[..., None, None]
              + sb[..., :, None] * sb[..., None, :] / sz[..., None, None])
        # a non-finite block (a boundary-grazing iterate) gives NaN, as in
        # JAX, where torch.linalg.eigh would raise: the IPM's guard then
        # discards the step
        bad = ~torch.isfinite(W2).all(dim=-1).all(dim=-1)
        eye = torch.eye(3, dtype=W2.dtype, device=W2.device)
        lam_e, U = torch.linalg.eigh(torch.where(bad[..., None, None], eye,
                                                 W2))   # ascending
        lam_e = torch.where(bad[..., None], torch.nan, lam_e)
        # relative floor: the BFGS subtraction leaves W2 singular along
        # directions roundoff can push slightly negative
        eps_r = 1e-13 if s.dtype == torch.float64 else 1e-6
        lam_e = torch.maximum(lam_e, eps_r * lam_e[..., -1:])
        sq = torch.sqrt(lam_e)
        Ut = U.transpose(-1, -2)
        exp_W = (U * sq[..., None, :]) @ Ut
        exp_Winv = (U / sq[..., None, :]) @ Ut
        exp_H = W2
        exp_g = g
    return NTScaling(w_l, tuple(socs), tuple(dims), exp_W=exp_W,
                     exp_Winv=exp_Winv, exp_H=exp_H, exp_g=exp_g)


def _soc_apply(eta, wbar, v, inverse: bool):
    w0 = wbar[..., :1]
    w1 = -wbar[..., 1:] if inverse else wbar[..., 1:]
    v0 = v[..., :1]
    v1 = v[..., 1:]
    t = torch.sum(w1 * v1, dim=-1, keepdim=True)
    out0 = w0 * v0 + t
    out1 = v1 + (v0 + t / (1.0 + w0)) * w1
    out = torch.cat([out0, out1], dim=-1)
    return out / eta if inverse else out * eta


def scale(spec: ConeSpec, W: NTScaling, v, inverse: bool = False):
    """Apply W (or W^{-1}) to v (B, m) or (B, K, m). Zero rows pass
    through unchanged."""
    out = v.clone()
    sl = spec.lin_slice
    if spec.nl > 0:
        wl = _bw(W.w_l, v)
        out[..., sl] = v[..., sl] / wl if inverse else v[..., sl] * wl
    groups = dict(soc_idx(spec, v.device))
    for (eta, wbar), d in zip(W.socs, W.soc_dims):
        idx = groups[d]
        out[..., idx] = _soc_apply(_bw(eta, v), _bw(wbar, v),
                                   v[..., idx], inverse)
    if spec.nexp > 0 and W.exp_W is not None:
        idx = exp_idx(spec, v.device)
        M = _bw(W.exp_Winv if inverse else W.exp_W, v)
        out[..., idx] = (M @ v[..., idx, None])[..., 0]
    return out


def w2_dense(spec: ConeSpec, W: NTScaling) -> torch.Tensor:
    """Dense (B, m, m) block-diagonal W^2 (zero block on zero-cone rows);
    an SOC block is eta^2 (2 wbar wbar' - J)."""
    Bn = W.w_l.shape[0]
    dt, dev = W.w_l.dtype, W.w_l.device
    out = torch.zeros(Bn, spec.m, spec.m, dtype=dt, device=dev)
    if spec.nl > 0:
        li = torch.arange(spec.nz, spec.nz + spec.nl, device=dev)
        out[:, li, li] = W.w_l ** 2
    groups = dict(soc_idx(spec, dev))
    for (eta, wbar), d in zip(W.socs, W.soc_dims):
        idx = groups[d]
        J = torch.cat([torch.ones(1, dtype=dt, device=dev),
                       -torch.ones(d - 1, dtype=dt, device=dev)])
        blocks = (eta ** 2)[..., None] * (
            2.0 * wbar[..., :, None] * wbar[..., None, :] - torch.diag(J))
        out[:, idx[:, :, None], idx[:, None, :]] = blocks
    if spec.nexp > 0 and W.exp_H is not None:
        idx = exp_idx(spec, dev)
        out[:, idx[:, :, None], idx[:, None, :]] = W.exp_H
    return out


def lambda_vec(spec: ConeSpec, W: NTScaling, z) -> torch.Tensor:
    """lambda = W z (zero on zero-cone rows, and on exp rows: the
    nonsymmetric blocks take their central-path target directly)."""
    lam = scale(spec, W, z)
    if spec.nz > 0:
        lam[..., spec.zero_slice] = 0.0
    if spec.nexp > 0:
        lam[..., exp_idx(spec, z.device)] = 0.0
    return lam


def project(spec: ConeSpec, v) -> torch.Tensor:
    """Euclidean projection onto K (0 on zero rows); the exp cone has no
    closed form (use violation())."""
    assert spec.nexp == 0, "no closed-form projection onto the exp cone"
    out = v.clone()
    if spec.nz > 0:
        out[..., spec.zero_slice] = 0.0
    sl = spec.lin_slice
    if spec.nl > 0:
        out[..., sl] = torch.clamp(v[..., sl], min=0.0)
    for d, idx in soc_idx(spec, v.device):
        vb = v[..., idx]
        v0 = vb[..., 0]
        v1 = vb[..., 1:]
        nv1 = torch.linalg.vector_norm(v1, dim=-1)
        coef = torch.clamp((v0 + nv1) / 2.0, min=0.0)
        inside = v0 >= nv1
        p0 = torch.where(inside, v0, coef)
        safe = torch.where(nv1 > 0, nv1, torch.ones_like(nv1))
        p1 = torch.where(inside[..., None], v1, (coef / safe)[..., None] * v1)
        out[..., idx] = torch.cat([p0[..., None], p1], dim=-1)
    return out


def violation(spec: ConeSpec, v) -> torch.Tensor:
    """||v - proj_K(v)||_inf per leading batch entry (zero rows as |v|),
    exp rows by their feasibility gap (exp_violation)."""
    out = torch.zeros(v.shape[:-1], dtype=v.dtype, device=v.device)
    if spec.nexp > 0:
        out = torch.amax(exp_violation(v[..., exp_idx(spec, v.device)]),
                         dim=-1)
        spec = ConeSpec(nz=spec.nz, nl=spec.nl, socs=spec.socs)
        v = v[..., : spec.m]
    if spec.m > 0:
        out = torch.maximum(out, torch.amax(
            torch.abs(v - project(spec, v)), dim=-1))
    return out
