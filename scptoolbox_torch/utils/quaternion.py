"""Scalar-last unit quaternion algebra on tensors.

Counterpart of `scptoolbox_tpu/utils/quaternion.py` (reference
src/utils/quaternion.jl: struct :33-151, skew :190-197, product :211-244,
Log :277-282, rotate :357-363, dcm :376-379, rpy :435-440, slerp :483-490,
ddq :506-512). A quaternion is a plain (..., 4) tensor q = [qx, qy, qz, qw],
vector part first, scalar last, so every function maps and differentiates
under torch.func.
"""

from __future__ import annotations

import torch


def identity(dtype=torch.float64, device=None) -> torch.Tensor:
    """Identity (no-rotation) quaternion."""
    return torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dtype, device=device)


def from_parts(v, w) -> torch.Tensor:
    """[v; w] from the vector part v (3,) and the scalar part w."""
    v = torch.as_tensor(v)
    w = torch.as_tensor(w, dtype=v.dtype, device=v.device).reshape(1)
    return torch.cat([v, w])


def vector(q) -> torch.Tensor:
    """Vector (imaginary) part."""
    return q[..., :3]


def scalar(q) -> torch.Tensor:
    """Scalar (real) part."""
    return q[..., 3]


def from_angleaxis(alpha, axis) -> torch.Tensor:
    """Unit quaternion of a rotation by alpha radians about `axis`
    (reference quaternion.jl:80-104)."""
    axis = torch.as_tensor(axis)
    axis = axis / torch.linalg.vector_norm(axis)
    half = 0.5 * torch.as_tensor(alpha, dtype=axis.dtype, device=axis.device)
    return from_parts(axis * torch.sin(half), torch.cos(half))


def skew_L(q) -> torch.Tensor:
    """4x4 left-multiplication matrix: mul(q, p) == skew_L(q) @ p
    (reference quaternion.jl:190-197 `skew(q, :L)`)."""
    x, y, z, w = q[0], q[1], q[2], q[3]
    return torch.stack([
        torch.stack([w, -z, y, x]),
        torch.stack([z, w, -x, y]),
        torch.stack([-y, x, w, z]),
        torch.stack([-x, -y, -z, w])])


def skew_R(q) -> torch.Tensor:
    """4x4 right-multiplication matrix: mul(p, q) == skew_R(q) @ p."""
    x, y, z, w = q[0], q[1], q[2], q[3]
    return torch.stack([
        torch.stack([w, z, -y, x]),
        torch.stack([-z, w, x, y]),
        torch.stack([y, -x, w, z]),
        torch.stack([-x, -y, -z, w])])


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def mul(q, p) -> torch.Tensor:
    """Hamilton product q*p (reference quaternion.jl:211-244)."""
    qv, qw = q[..., :3], q[..., 3:4]
    pv, pw = p[..., :3], p[..., 3:4]
    v = qw * pv + pw * qv + _cross(qv, pv)
    w = qw * pw - torch.sum(qv * pv, dim=-1, keepdim=True)
    return torch.cat([v, w], dim=-1)


def conj(q) -> torch.Tensor:
    """Quaternion conjugate (the inverse of a unit quaternion)."""
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def normalize(q) -> torch.Tensor:
    """Project onto the unit sphere (an RK4 integration action, reference
    problem.jl:296-305)."""
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def log(q) -> torch.Tensor:
    """Rotation vector alpha u (3,) of q = exp([0.5 alpha u])
    (reference quaternion.jl:277-282); zero for the identity."""
    qv = q[..., :3]
    qw = q[..., 3]
    nv = torch.linalg.vector_norm(qv, dim=-1)
    safe_nv = torch.where(nv > 0, nv, torch.ones_like(nv))
    alpha = 2.0 * torch.atan2(nv, qw)
    return torch.where((nv > 0)[..., None], (alpha / safe_nv)[..., None] * qv,
                       torch.zeros_like(qv))


def rotate(q, r) -> torch.Tensor:
    """Rotate the vector r by q: q [r; 0] q* (reference :357-363)."""
    qv, qw = q[..., :3], q[..., 3:4]
    t = 2.0 * _cross(qv, r)
    return r + qw * t + _cross(qv, t)


def dcm(q) -> torch.Tensor:
    """Direction cosine matrix with dcm(q) @ r == rotate(q, r)
    (reference quaternion.jl:376-379)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - z * w)
    r02 = 2 * (x * z + y * w)
    r10 = 2 * (x * y + z * w)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - x * w)
    r20 = 2 * (x * z - y * w)
    r21 = 2 * (y * z + x * w)
    r22 = 1 - 2 * (x * x + y * y)
    return torch.stack([torch.stack([r00, r01, r02], dim=-1),
                        torch.stack([r10, r11, r12], dim=-1),
                        torch.stack([r20, r21, r22], dim=-1)], dim=-2)


def rpy(q):
    """Tait-Bryan roll, pitch, yaw (ZYX intrinsic) of the rotation
    (reference quaternion.jl:435-440)."""
    R = dcm(q)
    pitch = torch.asin(torch.clamp(-R[..., 2, 0], -1.0, 1.0))
    roll = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    yaw = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    return roll, pitch, yaw


def slerp(q0, q1, t) -> torch.Tensor:
    """Spherical linear interpolation from q0 (t = 0) to q1 (t = 1), the
    short way round; linear where the two nearly coincide
    (reference quaternion.jl:483-490)."""
    t = torch.as_tensor(t, dtype=q0.dtype, device=q0.device)
    d = torch.sum(q0 * q1, dim=-1)
    q1 = torch.where(d < 0, -q1, q1)
    d = torch.clamp(torch.abs(d), -1.0, 1.0)
    theta = torch.acos(d)
    sin_theta = torch.sin(theta)
    use_lerp = sin_theta < 1e-6
    den = torch.where(use_lerp, torch.ones_like(sin_theta), sin_theta)
    w0 = torch.where(use_lerp, 1.0 - t, torch.sin((1.0 - t) * theta) / den)
    w1 = torch.where(use_lerp, t, torch.sin(t * theta) / den)
    return normalize(w0 * q0 + w1 * q1)


def _skew3(v) -> torch.Tensor:
    z = torch.zeros((), dtype=v.dtype, device=v.device)
    return torch.stack([torch.stack([z, -v[2], v[1]]),
                        torch.stack([v[2], z, -v[0]]),
                        torch.stack([-v[1], v[0], z])])


def ddq(q, r) -> torch.Tensor:
    """Jacobian (3, 4) with respect to q of the homogeneous rotation form
    R(q) r = (qw^2 - |qv|^2) r + 2 (qv.r) qv + 2 qw (qv x r), which equals
    rotate(q, r) for a unit q (reference quaternion.jl:506-512)."""
    qv, qw = q[:3], q[3]
    rv = torch.as_tensor(r, dtype=q.dtype, device=q.device)
    I3 = torch.eye(3, dtype=q.dtype, device=q.device)
    d_dqv = 2.0 * (torch.dot(qv, rv) * I3 + torch.outer(qv, rv)
                   - torch.outer(rv, qv) - qw * _skew3(rv))
    d_dqw = 2.0 * (qw * rv + _cross(qv, rv))
    return torch.cat([d_dqv, d_dqw[:, None]], dim=1)


def from_dcm(R) -> torch.Tensor:
    """Unit quaternion of a rotation matrix: Shepperd's method, the case
    chosen by the largest of the trace and the diagonal
    (reference quaternion.jl:118-151)."""
    R = torch.as_tensor(R)
    tr = R[0, 0] + R[1, 1] + R[2, 2]
    root = lambda a: torch.sqrt(torch.clamp(a, min=1e-12)) / 2.0
    w = root(1.0 + tr)
    x = root(1.0 + R[0, 0] - R[1, 1] - R[2, 2])
    y = root(1.0 - R[0, 0] + R[1, 1] - R[2, 2])
    z = root(1.0 - R[0, 0] - R[1, 1] + R[2, 2])
    cases = torch.stack([
        torch.stack([x, (R[0, 1] + R[1, 0]) / (4 * x),
                     (R[0, 2] + R[2, 0]) / (4 * x),
                     (R[2, 1] - R[1, 2]) / (4 * x)]),
        torch.stack([(R[0, 1] + R[1, 0]) / (4 * y), y,
                     (R[1, 2] + R[2, 1]) / (4 * y),
                     (R[0, 2] - R[2, 0]) / (4 * y)]),
        torch.stack([(R[0, 2] + R[2, 0]) / (4 * z),
                     (R[1, 2] + R[2, 1]) / (4 * z), z,
                     (R[1, 0] - R[0, 1]) / (4 * z)]),
        torch.stack([(R[2, 1] - R[1, 2]) / (4 * w),
                     (R[0, 2] - R[2, 0]) / (4 * w),
                     (R[1, 0] - R[0, 1]) / (4 * w), w])])
    diag = torch.stack([R[0, 0], R[1, 1], R[2, 2]])
    idx = torch.where(tr > torch.max(diag), 3, torch.argmax(diag))
    return normalize(cases[idx])
