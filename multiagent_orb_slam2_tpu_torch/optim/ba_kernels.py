"""Bundle-adjustment inner pieces in plain tensor ops.

Counterpart of the JAX package's ``optim/ba_kernels.py``: per-observation
residuals / Jacobians with the small matrix indices leading and the flattened
observation axis E = P*M last (observation e belongs to point e // M), the
cost-only evaluator, the damped symmetric 3x3 inverse and block-Jacobi
preconditioned CG on the reduced camera system.

These are the arithmetic that the two CUDA kernels of the BA path repeat:
``optim/ba_prep.py`` builds its plain version from ``obs_terms_e`` and
``sym3_inv``, and ``optim/pcg.py`` uses ``pcg_solve`` as its plain version.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry.camera import Intrinsics


def _quat_rotate_cols(qw, qx, qy, qz, vx, vy, vz):
    """Componentwise quaternion rotation over [E] vectors."""
    tx = 2.0 * (qy * vz - qz * vy)
    ty = 2.0 * (qz * vx - qx * vz)
    tz = 2.0 * (qx * vy - qy * vx)
    ox = vx + qw * tx + (qy * tz - qz * ty)
    oy = vy + qw * ty + (qz * tx - qx * tz)
    oz = vz + qw * tz + (qx * ty - qy * tx)
    return ox, oy, oz


def _rot_cols(qw, qx, qy, qz):
    """Rotation matrix entries (9 arrays over [E]) from quaternion columns."""
    xx, yy, zz = qx * qx, qy * qy, qz * qz
    xy, xz, yz = qx * qy, qx * qz, qy * qz
    wx, wy, wz = qw * qx, qw * qy, qw * qz
    return (1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy))


class ObsTermsE(NamedTuple):
    r: torch.Tensor       # [3, E] residuals (obs - proj), row 2 masked mono
    Jc: torch.Tensor      # [3, 6, E] d r / d pose-twist
    Jp: torch.Tensor      # [3, 3, E] d r / d point
    w: torch.Tensor       # [E] IRLS weight (inv_sigma2 * huber * active)
    chi2: torch.Tensor    # [E]
    cost: torch.Tensor    # scalar robust cost


def _camera_points(obs_kf, q, t, pw, M):
    """Gathered quaternion columns and camera-frame coordinates over [E]."""
    g = torch.cat([q, t], dim=1)[obs_kf.long()]           # [E, 7]
    qw_, qx_, qy_, qz_ = g[:, 0], g[:, 1], g[:, 2], g[:, 3]
    px = pw[:, 0].repeat_interleave(M)                    # p-major E ordering
    py = pw[:, 1].repeat_interleave(M)
    pz = pw[:, 2].repeat_interleave(M)
    cx_, cy_, cz_ = _quat_rotate_cols(qw_, qx_, qy_, qz_, px, py, pz)
    return (qw_, qx_, qy_, qz_), cx_ + g[:, 4], cy_ + g[:, 5], cz_ + g[:, 6]


def _residual_chi2(X, Y, Z, obs_uvr_t, inv_sigma2_e, stereo_e, cam):
    z = Z.clamp_min(1e-6)
    iz = 1.0 / z
    u = cam.fx * X * iz + cam.cx
    v = cam.fy * Y * iz + cam.cy
    ur = u - cam.bf * iz
    r0 = obs_uvr_t[0] - u
    r1 = obs_uvr_t[1] - v
    r2 = torch.where(stereo_e, obs_uvr_t[2] - ur, torch.zeros_like(ur))
    chi2 = (r0 * r0 + r1 * r1 + r2 * r2) * inv_sigma2_e
    return iz, r0, r1, r2, chi2


def _robust(chi2, stereo_e, delta2_m, delta2_s, use_huber):
    """(IRLS weight factor, robust cost term) of the Huber kernel."""
    if not use_huber:
        return torch.ones_like(chi2), chi2
    delta2 = torch.where(stereo_e, delta2_s, delta2_m).to(chi2.dtype)
    root = torch.sqrt(chi2.clamp_min(1e-12))
    w_rob = torch.sqrt(delta2 / chi2.clamp_min(1e-12)).clamp_max(1.0)
    rho = torch.where(chi2 <= delta2, chi2,
                      2.0 * torch.sqrt(delta2) * root - delta2)
    return w_rob, rho


def obs_terms_e(obs_kf, obs_uvr_t, inv_sigma2_e, stereo_e, active_base,
                q, t, pw, cam: Intrinsics, delta2_m, delta2_s,
                use_huber: bool) -> ObsTermsE:
    """All residuals / Jacobians in E-major layout.

    obs_kf: [E] integer (already clipped valid / masked via active_base)
    obs_uvr_t: [3, E]; inv_sigma2_e / active_base: [E] float; stereo_e: [E]
    bool; q, t: [K, 4] / [K, 3] pose tables; pw: [P, 3]; E must equal P*M.
    """
    P = pw.shape[0]
    M = obs_kf.shape[0] // P
    quat, X, Y, Z = _camera_points(obs_kf, q, t, pw, M)
    iz, r0, r1, r2, chi2 = _residual_chi2(X, Y, Z, obs_uvr_t, inv_sigma2_e,
                                          stereo_e, cam)
    iz2 = iz * iz
    r = torch.stack([r0, r1, r2])

    active = active_base * (Z > 0.01).to(active_base.dtype)
    w_rob, rho = _robust(chi2, stereo_e, delta2_m, delta2_s, use_huber)
    w = inv_sigma2_e * w_rob * active
    cost = torch.sum(rho * active)

    # dproj/dpc rows (sign: r = obs - proj => J = -dproj)
    fx, fy, bf = cam.fx, cam.fy, cam.bf
    zero = torch.zeros_like(iz)
    a00, a01, a02 = -fx * iz, zero, fx * X * iz2
    a10, a11, a12 = zero, -fy * iz, fy * Y * iz2
    a20 = torch.where(stereo_e, -fx * iz, zero)
    a21 = zero
    a22 = torch.where(stereo_e, fx * X * iz2 - bf * iz2, zero)

    # Jc = A @ [I | -hat(pc)]: translation block A, rotation block A(-hat)
    def rotblock(a0, a1, a2):
        return (a2 * Y - a1 * Z, a0 * Z - a2 * X, a1 * X - a0 * Y)

    b00, b01, b02 = rotblock(a00, a01, a02)
    b10, b11, b12 = rotblock(a10, a11, a12)
    b20, b21, b22 = rotblock(a20, a21, a22)
    Jc = torch.stack([
        torch.stack([a00, a01, a02, b00, b01, b02]),
        torch.stack([a10, a11, a12, b10, b11, b12]),
        torch.stack([a20, a21, a22, b20, b21, b22]),
    ])                                              # [3, 6, E]

    # Jp = A @ R
    R = _rot_cols(*quat)

    def jp_row(a0, a1, a2):
        return torch.stack([a0 * R[0] + a1 * R[3] + a2 * R[6],
                            a0 * R[1] + a1 * R[4] + a2 * R[7],
                            a0 * R[2] + a1 * R[5] + a2 * R[8]])

    Jp = torch.stack([jp_row(a00, a01, a02), jp_row(a10, a11, a12),
                      jp_row(a20, a21, a22)])       # [3, 3, E]
    return ObsTermsE(r=r, Jc=Jc, Jp=Jp, w=w, chi2=chi2, cost=cost)


def cost_e(obs_kf, obs_uvr_t, inv_sigma2_e, stereo_e, active_base,
           q, t, pw, cam, delta2_m, delta2_s, use_huber: bool):
    """Robust cost only (for LM accept/reject), no Jacobians.
    Returns (cost scalar, chi2 [E])."""
    P = pw.shape[0]
    M = obs_kf.shape[0] // P
    _, X, Y, Z = _camera_points(obs_kf, q, t, pw, M)
    _, _, _, _, chi2 = _residual_chi2(X, Y, Z, obs_uvr_t, inv_sigma2_e,
                                      stereo_e, cam)
    active = active_base * (Z > 0.01).to(active_base.dtype)
    _, rho = _robust(chi2, stereo_e, delta2_m, delta2_s, use_huber)
    return torch.sum(rho * active), chi2


def sym3_inv(H, damp):
    """Inverse of symmetric 3x3 blocks given as component arrays.

    H: tuple (h00, h01, h02, h11, h12, h22) each [P]; damp (LM lambda,
    a float or a 0-d tensor) scales the diagonal. Returns the 6 component
    arrays of the inverse.
    """
    h00, h01, h02, h11, h12, h22 = H
    h00 = h00 + damp * h00 + 1e-8
    h11 = h11 + damp * h11 + 1e-8
    h22 = h22 + damp * h22 + 1e-8
    c00 = h11 * h22 - h12 * h12
    c01 = h02 * h12 - h01 * h22
    c02 = h01 * h12 - h02 * h11
    c11 = h00 * h22 - h02 * h02
    c12 = h01 * h02 - h00 * h12
    c22 = h00 * h11 - h01 * h01
    det = h00 * c00 + h01 * c01 + h02 * c02
    idet = 1.0 / torch.where(torch.abs(det) < 1e-20,
                             torch.full_like(det, 1e-20), det)
    return (c00 * idet, c01 * idet, c02 * idet,
            c11 * idet, c12 * idet, c22 * idet)


def _guard(v):
    return torch.where(torch.abs(v) < 1e-30, torch.full_like(v, 1e-30), v)


def pcg_solve(S_dense, rhs_flat, block_diag_inv, n_iters: int = 48, x0=None,
              rows_f64: bool = False):
    """Block-Jacobi preconditioned CG for the reduced camera system.

    S_dense [D, D], rhs [D], block_diag_inv [K, 6, 6] with D = 6K. Fixed
    iteration count (LM tolerates inexact steps; accept/reject guards
    descent). x0 warm-starts from the previous LM iteration's solution.
    rows_f64 sums each row of S v in float64 and rounds it once to float32,
    the arithmetic of ``csrc/pcg.cu``'s grid path; by default every row is
    summed in float32, as in the JAX package and the cluster path.
    """
    K = block_diag_inv.shape[0]

    def precond(v):
        return torch.einsum("kij,kj->ki", block_diag_inv,
                            v.reshape(K, 6)).reshape(-1)

    if rows_f64:
        S64 = S_dense.double()

        def matvec(v):
            return (S64 @ v.double()).to(v.dtype)
    else:
        def matvec(v):
            return S_dense @ v

    if x0 is None:
        x = torch.zeros_like(rhs_flat)
        r = rhs_flat
    else:
        x = x0
        r = rhs_flat - matvec(x0)
    z = precond(r)
    p = z
    rz = torch.dot(r, z)
    for _ in range(n_iters):
        Ap = matvec(p)
        alpha = rz / _guard(torch.dot(p, Ap))
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = torch.dot(r, z)
        beta = rz_new / _guard(rz)
        p = z + beta * p
        rz = rz_new
    return x
