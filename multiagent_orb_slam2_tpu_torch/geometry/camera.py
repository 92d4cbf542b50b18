"""Pinhole camera model: batched projection / unprojection, mono + stereo.

Counterpart of the JAX package's ``geometry/camera.py``. Stereo follows the
rectified convention: a right-image x coordinate u_r = u - bf / z.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import se3


class Intrinsics(NamedTuple):
    """Static per-camera parameters (from the YAML config)."""
    fx: float
    fy: float
    cx: float
    cy: float
    bf: float = 0.0           # baseline * fx (stereo/RGB-D); 0 for mono
    width: int = 640
    height: int = 480
    # radial-tangential distortion (k1, k2, p1, p2, k3)
    dist: tuple = (0.0, 0.0, 0.0, 0.0, 0.0)

    @property
    def K(self):
        """3x3 calibration matrix as a float32 CPU tensor."""
        return torch.tensor([[self.fx, 0.0, self.cx],
                             [0.0, self.fy, self.cy],
                             [0.0, 0.0, 1.0]], dtype=torch.float32)

    @property
    def baseline(self):
        return self.bf / self.fx


def _guard_z(z):
    return torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)


def project(cam: Intrinsics, pc):
    """Camera-frame points [..., 3] -> pixel coords [..., 2] (no distortion:
    the pipeline works on undistorted keypoints)."""
    inv_z = 1.0 / _guard_z(pc[..., 2])
    u = cam.fx * pc[..., 0] * inv_z + cam.cx
    v = cam.fy * pc[..., 1] * inv_z + cam.cy
    return torch.stack([u, v], dim=-1)


def project_stereo(cam: Intrinsics, pc):
    """Camera-frame points -> (u, v, u_right) [..., 3]."""
    uv = project(cam, pc)
    inv_z = 1.0 / _guard_z(pc[..., 2])
    ur = uv[..., 0] - cam.bf * inv_z
    return torch.cat([uv, ur[..., None]], dim=-1)


def project_world(cam: Intrinsics, q_cw, t_cw, pw):
    """World points through pose Tcw -> pixels; also returns depth."""
    pc = se3.apply(q_cw, t_cw, pw)
    return project(cam, pc), pc[..., 2]


def backproject(cam: Intrinsics, uv, depth):
    """Pixels [..., 2] + depth [...] -> camera-frame points [..., 3]."""
    x = (uv[..., 0] - cam.cx) / cam.fx * depth
    y = (uv[..., 1] - cam.cy) / cam.fy * depth
    return torch.stack([x, y, depth], dim=-1)


def unproject_world(cam: Intrinsics, q_cw, t_cw, uv, depth):
    """Pixels+depth -> world points via Twc."""
    pc = backproject(cam, uv, depth)
    q_wc, t_wc = se3.inverse(q_cw, t_cw)
    return se3.apply(q_wc, t_wc, pc)


def in_image(cam: Intrinsics, uv, margin=0.0):
    return ((uv[..., 0] >= margin) & (uv[..., 0] < cam.width - margin)
            & (uv[..., 1] >= margin) & (uv[..., 1] < cam.height - margin))


def distort(cam: Intrinsics, xy_norm):
    """Apply radial-tangential distortion to normalized coords [..., 2]."""
    k1, k2, p1, p2, k3 = cam.dist
    x, y = xy_norm[..., 0], xy_norm[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def undistort_points(cam: Intrinsics, uv, iters: int = 5):
    """Iteratively invert the distortion model (fixed-point scheme).
    Returns undistorted pixel coordinates."""
    if all(d == 0.0 for d in cam.dist):
        return uv
    x0 = (uv[..., 0] - cam.cx) / cam.fx
    y0 = (uv[..., 1] - cam.cy) / cam.fy
    xy0 = torch.stack([x0, y0], dim=-1)
    xy = xy0
    for _ in range(iters):
        d = distort(cam, xy) - xy
        xy = xy0 - d
    u = xy[..., 0] * cam.fx + cam.cx
    v = xy[..., 1] * cam.fy + cam.cy
    return torch.stack([u, v], dim=-1)
