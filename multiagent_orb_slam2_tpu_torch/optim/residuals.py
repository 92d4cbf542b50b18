"""Reprojection residuals + analytic Jacobians shared by the optimizers.

Counterpart of the JAX package's ``optim/residuals.py``. Residual =
observation - projection; poses are world-to-camera Tcw perturbed on the
left, Tcw' = exp(xi) * Tcw with xi = (rho, phi). Stereo observations are
3-vectors (u, v, u_right); monocular observations mask the third row.
"""
from __future__ import annotations

import torch

from ..geometry import se3
from ..geometry.camera import Intrinsics


def project_residual(cam: Intrinsics, q, t, pw, obs, is_stereo):
    """Residual r [..., 3] and camera-frame point pc for obs (u, v, u_r).

    Third component is zeroed for mono observations.
    """
    pc = se3.apply(q, t, pw)
    z = pc[..., 2].clamp_min(1e-6)
    inv_z = 1.0 / z
    u = cam.fx * pc[..., 0] * inv_z + cam.cx
    v = cam.fy * pc[..., 1] * inv_z + cam.cy
    ur = u - cam.bf * inv_z
    pred = torch.stack([u, v, ur], dim=-1)
    r = obs - pred
    r2 = torch.where(is_stereo, r[..., 2], torch.zeros_like(r[..., 2]))
    return torch.cat([r[..., :2], r2[..., None]], dim=-1), pc


def proj_jacobian_point(cam: Intrinsics, pc, is_stereo):
    """d(residual)/d(pc): [..., 3, 3] (sign: r = obs - proj => J = -dproj/dpc)."""
    x, y = pc[..., 0], pc[..., 1]
    z = pc[..., 2].clamp_min(1e-6)
    inv_z = 1.0 / z
    inv_z2 = inv_z * inv_z
    zero = torch.zeros_like(x)
    row_u = torch.stack([cam.fx * inv_z, zero, -cam.fx * x * inv_z2], dim=-1)
    row_v = torch.stack([zero, cam.fy * inv_z, -cam.fy * y * inv_z2], dim=-1)
    row_r = torch.stack([cam.fx * inv_z, zero,
                         -cam.fx * x * inv_z2 + cam.bf * inv_z2], dim=-1)
    row_r = torch.where(is_stereo[..., None], row_r, torch.zeros_like(row_r))
    return -torch.stack([row_u, row_v, row_r], dim=-2)


def jacobians(cam: Intrinsics, q, t, pw, is_stereo):
    """(J_pose [..., 3, 6], J_point [..., 3, 3], pc).

    J_pose columns follow xi = (rho, phi): d pc/d xi = [I | -hat(pc)].
    J_point chains through R (d pc/d pw = R).
    """
    pc = se3.apply(q, t, pw)
    Jproj = proj_jacobian_point(cam, pc, is_stereo)   # [..., 3, 3]
    dpc_dphi = -se3.hat(pc)
    J_pose = torch.cat([Jproj, Jproj @ dpc_dphi], dim=-1)
    R = se3.quat_to_matrix(q)
    J_point = Jproj @ R
    return J_pose, J_point, pc


def huber_weight(chi2, delta2):
    """Huber IRLS weight as a function of squared error:
    rho'(chi2) = min(1, delta/sqrt(chi2))."""
    return torch.sqrt(delta2 / chi2.clamp_min(1e-12)).clamp_max(1.0)
