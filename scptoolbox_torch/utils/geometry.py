"""Geometric sets and rigid-body transform helpers.

Counterpart of `scptoolbox_tpu/utils/geometry.py` (`skew` :20, `Ellipsoid`
:33, `Hyperrectangle` :81, `homtransf` / `hominv` / `homdisp` / `homrot`
:138-164; reference src/utils/ellipsoid.jl, hyperrectangle.jl and
helper.jl:65, :873-943). The sets are NamedTuples of tensors, so their
methods map and differentiate under torch.func; a set's tensors carry the
dtype and device it was made with.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def skew(v) -> torch.Tensor:
    """3x3 cross-product (skew-symmetric) matrix of v: skew(v) w = v x w."""
    v = torch.as_tensor(v)
    z = torch.zeros((), dtype=v.dtype, device=v.device)
    return torch.stack([
        torch.stack([z, -v[2], v[1]]),
        torch.stack([v[2], z, -v[0]]),
        torch.stack([-v[1], v[0], z])])


class Ellipsoid(NamedTuple):
    """Ellipsoid {x : ||H (x - c)|| <= 1} (reference ellipsoid.jl:27-51),
    the quadrotor's and the free-flyer's keep-out zones."""

    H: torch.Tensor  # (n, n) shape matrix
    c: torch.Tensor  # (n,) center

    @staticmethod
    def from_radii(radii, center) -> "Ellipsoid":
        """Axis-aligned ellipsoid with the given semi-axis lengths."""
        radii = torch.as_tensor(radii)
        return Ellipsoid(torch.diag(1.0 / radii),
                         torch.as_tensor(center, dtype=radii.dtype,
                                         device=radii.device))

    def __call__(self, r) -> torch.Tensor:
        """Level-set value ||H (r - c)|| (reference ellipsoid.jl:99-102)."""
        return torch.linalg.vector_norm(self.H @ (r - self.c))

    def grad(self, r) -> torch.Tensor:
        """Gradient of the level-set value (reference ellipsoid.jl:115-118)."""
        d = r - self.c
        HtH = self.H.T @ self.H
        val = torch.sqrt(d @ HtH @ d)
        return (HtH @ d) / torch.clamp(val, min=1e-12)

    def project(self, axes) -> "Ellipsoid":
        """The shadow of the set on the coordinates `axes`: the Schur
        complement of H'H on those axes, then its symmetric square root
        (reference ellipsoid.jl:65-84)."""
        axes = list(axes)
        M = self.H.T @ self.H
        others = [i for i in range(self.c.shape[0]) if i not in axes]
        ia = torch.as_tensor(axes, device=M.device)
        S = M[ia][:, ia]
        if others:
            io = torch.as_tensor(others, device=M.device)
            Bm = M[ia][:, io]
            C = M[io][:, io]
            S = S - Bm @ torch.linalg.solve(C, Bm.T)
        w, V = torch.linalg.eigh(S)
        Hp = (V * torch.sqrt(torch.clamp(w, min=0.0))) @ V.T
        return Ellipsoid(Hp, self.c[ia])


class Hyperrectangle(NamedTuple):
    """Axis-aligned box {x : l <= x <= u} (reference hyperrectangle.jl:26-149)
    with its affine scaling s = (u - l) / 2, center = (u + l) / 2."""

    l: torch.Tensor
    u: torch.Tensor

    @staticmethod
    def from_ranges(*ranges, dtype=torch.float64, device=None
                    ) -> "Hyperrectangle":
        """The box of per-axis (lo, hi) pairs."""
        lo = torch.tensor([float(r[0]) for r in ranges], dtype=dtype,
                          device=device)
        hi = torch.tensor([float(r[1]) for r in ranges], dtype=dtype,
                          device=device)
        return Hyperrectangle(lo, hi)

    @staticmethod
    def from_extrusion(offset, width, height, depth, *, yaw=0.0, pitch=0.0,
                       roll=0.0, dtype=torch.float64, device=None
                       ) -> "Hyperrectangle":
        """A width x height rectangle at `offset` extruded by `depth` along
        +z, then turned by Tait-Bryan angles in degrees, each a multiple of
        90 so that the box stays axis-aligned (ValueError otherwise;
        reference hyperrectangle.jl:102-148)."""
        for ang in (yaw, pitch, roll):
            if ang % 90 != 0:
                raise ValueError("hyperrectangle must be axis-aligned")
        lo = np.array([-width / 2.0, -height / 2.0, 0.0])
        hi = np.array([width / 2.0, height / 2.0, depth])
        c = lambda a: np.cos(np.deg2rad(a))
        s = lambda a: np.sin(np.deg2rad(a))
        Rz = np.array([[c(yaw), -s(yaw), 0], [s(yaw), c(yaw), 0], [0, 0, 1]])
        Ry = np.array([[c(pitch), 0, s(pitch)], [0, 1, 0],
                       [-s(pitch), 0, c(pitch)]])
        Rx = np.array([[1, 0, 0], [0, c(roll), -s(roll)],
                       [0, s(roll), c(roll)]])
        R = Rz @ Ry @ Rx
        lr, ur = R @ lo, R @ hi
        off = np.asarray(offset, dtype=float)
        T = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
        return Hyperrectangle(T(np.minimum(lr, ur) + off),
                              T(np.maximum(lr, ur) + off))

    @property
    def s(self) -> torch.Tensor:
        return (self.u - self.l) / 2.0

    @property
    def center(self) -> torch.Tensor:
        return (self.u + self.l) / 2.0

    def contains(self, x) -> torch.Tensor:
        """Membership test (reference hyperrectangle.jl:163-165)."""
        return torch.all((x >= self.l) & (x <= self.u))


def homtransf(R=None, t=None, *, dtype=torch.float64,
              device=None) -> torch.Tensor:
    """4x4 homogeneous transform of a rotation R (3, 3) and a translation
    t (3,) (reference helper.jl:873-905)."""
    R = (torch.eye(3, dtype=dtype, device=device) if R is None
         else torch.as_tensor(R))
    t = (torch.zeros(3, dtype=R.dtype, device=R.device) if t is None
         else torch.as_tensor(t, dtype=R.dtype, device=R.device))
    top = torch.cat([R, t[:, None]], dim=1)
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=R.dtype,
                          device=R.device)
    return torch.cat([top, bottom], dim=0)


def hominv(T) -> torch.Tensor:
    """Inverse of a homogeneous transform (reference helper.jl:907-918)."""
    R, t = T[:3, :3], T[:3, 3]
    return homtransf(R.T, -R.T @ t)


def homdisp(T) -> torch.Tensor:
    """Translation part (reference helper.jl:920-930)."""
    return T[:3, 3]


def homrot(T) -> torch.Tensor:
    """Rotation part (reference helper.jl:932-943)."""
    return T[:3, :3]
