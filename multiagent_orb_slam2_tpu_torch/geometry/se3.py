"""Batched SE(3) rigid transforms as (quaternion, translation) pairs.

Counterpart of the JAX package's ``geometry/se3.py``. All functions broadcast
over arbitrary leading batch axes. Poses are world-to-camera (Tcw);
quaternions are (w, x, y, z), unit-norm, hemisphere-normalized on
construction.
"""
from __future__ import annotations

import torch

# Small-angle guard for exp/log Taylor branches.
_EPS = 1e-8


# ---------------------------------------------------------------------------
# Quaternion primitives (w, x, y, z)
# ---------------------------------------------------------------------------

def quat_identity(shape=(), device=None, dtype=torch.float32):
    q = torch.zeros(tuple(shape) + (4,), device=device, dtype=dtype)
    q.select(-1, 0).fill_(1.0)
    return q


def quat_normalize(q):
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp_min(_EPS)
    # hemisphere convention: w >= 0 (keeps log/interp well-behaved)
    return torch.where(q[..., :1] < 0, -q, q)


def quat_mul(a, b):
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_conj(q):
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def _cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def quat_rotate(q, v):
    """Rotate vectors v[..., 3] by unit quaternions q[..., 4]."""
    qv = q[..., 1:]
    uv = _cross(qv, v)
    uuv = _cross(qv, uv)
    return v + 2.0 * (q[..., :1] * uv + uuv)


def quat_to_matrix(q):
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def matrix_to_quat(R):
    """Rotation matrix [..., 3, 3] -> quaternion, Shepperd's branchless form."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    # four candidate constructions; pick the numerically largest pivot
    qw = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22,
                      1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], dim=-1)
    qw = torch.sqrt(qw.clamp_min(0.0)) * 0.5
    w0, x1, y2, z3 = qw[..., 0], qw[..., 1], qw[..., 2], qw[..., 3]
    c0 = torch.stack([w0, (m21 - m12) / (4 * w0 + _EPS),
                      (m02 - m20) / (4 * w0 + _EPS),
                      (m10 - m01) / (4 * w0 + _EPS)], dim=-1)
    c1 = torch.stack([(m21 - m12) / (4 * x1 + _EPS), x1,
                      (m01 + m10) / (4 * x1 + _EPS),
                      (m02 + m20) / (4 * x1 + _EPS)], dim=-1)
    c2 = torch.stack([(m02 - m20) / (4 * y2 + _EPS),
                      (m01 + m10) / (4 * y2 + _EPS), y2,
                      (m12 + m21) / (4 * y2 + _EPS)], dim=-1)
    c3 = torch.stack([(m10 - m01) / (4 * z3 + _EPS),
                      (m02 + m20) / (4 * z3 + _EPS),
                      (m12 + m21) / (4 * z3 + _EPS), z3], dim=-1)
    idx = torch.argmax(qw, dim=-1)
    cands = torch.stack([c0, c1, c2, c3], dim=-2)
    q = torch.gather(cands, -2, idx[..., None, None].expand(
        idx.shape + (1, 4)))
    return quat_normalize(q[..., 0, :])


# ---------------------------------------------------------------------------
# so(3) / se(3) exp & log
# ---------------------------------------------------------------------------

def safe_norm(x, dim=-1, keepdim=False):
    """sqrt(sum(x^2) + tiny): finite at 0, same value rule as the JAX
    package's safe_norm."""
    return torch.sqrt(torch.sum(x * x, dim=dim, keepdim=keepdim) + 1e-24)


def _sinc(x):
    """sin(x)/x with Taylor fallback."""
    small = torch.abs(x) < 1e-4
    return torch.where(small, 1.0 - x * x / 6.0,
                       torch.sin(x) / torch.where(small, torch.ones_like(x), x))


def so3_exp_quat(w):
    """Axis-angle vector [..., 3] -> unit quaternion."""
    theta = safe_norm(w, keepdim=True)
    half = 0.5 * theta
    qw = torch.cos(half)
    qv = w * 0.5 * _sinc(half[..., 0])[..., None]
    return quat_normalize(torch.cat([qw, qv], dim=-1))


def so3_log(q):
    """Unit quaternion -> axis-angle vector [..., 3]."""
    q = quat_normalize(q)
    sin_half = torch.linalg.norm(q[..., 1:], dim=-1)
    cos_half = q[..., 0]
    half = torch.atan2(sin_half, cos_half)
    scale = torch.where(sin_half < 1e-7, torch.full_like(half, 2.0),
                        2.0 * half / sin_half.clamp_min(1e-12))
    return q[..., 1:] * scale[..., None]


def hat(w):
    """[..., 3] -> skew-symmetric [..., 3, 3]."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    m = torch.stack([z, -wz, wy, wz, z, -wx, -wy, wx, z], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def se3_exp(xi):
    """Twist xi = [..., 6] (rho, phi) -> (quat, trans): xi[..., :3] is the
    translation part rho, xi[..., 3:] the rotation part phi."""
    rho, phi = xi[..., :3], xi[..., 3:]
    theta = safe_norm(phi, keepdim=True)
    q = so3_exp_quat(phi)
    # left Jacobian V of SO(3)
    Phi = hat(phi)
    Phi2 = Phi @ Phi
    t2 = (theta * theta).clamp_min(_EPS)[..., None]
    small = (theta < 1e-4)[..., None]
    A = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(theta))[..., None] / t2)
    B = torch.where(small, 1.0 / 6.0 - t2 / 120.0,
                    (theta - torch.sin(theta))[..., None]
                    / (t2 * theta[..., None] + _EPS))
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    V = eye + A * Phi + B * Phi2
    t = torch.einsum("...ij,...j->...i", V, rho)
    return q, t


def se3_log(q, t):
    """(quat, trans) -> twist [..., 6] (rho, phi)."""
    phi = so3_log(q)
    theta = torch.linalg.norm(phi, dim=-1, keepdim=True)
    Phi = hat(phi)
    Phi2 = Phi @ Phi
    half = 0.5 * theta
    small = (theta < 1e-4)[..., None]
    # V^{-1} = I - 0.5 Phi + coef Phi^2
    cot_term = torch.where(
        small,
        1.0 / 12.0 + theta[..., None] ** 2 / 720.0,
        (1.0 - half[..., None] * torch.cos(half)[..., None]
         / torch.sin(half).clamp_min(_EPS)[..., None])
        / theta.clamp_min(_EPS)[..., None] ** 2,
    )
    eye = torch.eye(3, dtype=t.dtype, device=t.device)
    Vinv = eye - 0.5 * Phi + cot_term * Phi2
    rho = torch.einsum("...ij,...j->...i", Vinv, t)
    return torch.cat([rho, phi], dim=-1)


# ---------------------------------------------------------------------------
# SE3 group ops on (quat, trans)
# ---------------------------------------------------------------------------

def compose(qa, ta, qb, tb):
    """T_a * T_b : first apply b, then a."""
    return quat_mul(qa, qb), quat_rotate(qa, tb) + ta


def inverse(q, t):
    qi = quat_conj(q)
    return qi, -quat_rotate(qi, t)


def apply(q, t, p):
    """Transform points p[..., 3]."""
    return quat_rotate(q, p) + t


def relative(qa, ta, qb, tb):
    """T_a * T_b^{-1} (pose of b's frame seen from a's)."""
    qbi, tbi = inverse(qb, tb)
    return compose(qa, ta, qbi, tbi)


def to_matrix44(q, t):
    R = quat_to_matrix(q)
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = torch.zeros(top.shape[:-2] + (1, 4), dtype=top.dtype,
                         device=top.device)
    bottom.select(-1, 3).fill_(1.0)
    return torch.cat([top, bottom], dim=-2)


def from_matrix44(T):
    return matrix_to_quat(T[..., :3, :3]), T[..., :3, 3]
