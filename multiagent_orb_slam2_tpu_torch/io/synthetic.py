"""Synthetic scene rendering with exact ground truth.

The reference validates only end-to-end on TUM/KITTI/EuRoC (SURVEY.md §4);
those blobs are unavailable here, so unit and integration tests run on
ray-cast synthetic scenes instead: a textured "box corridor" (floor + two
walls + back wall) rendered per pixel, with exact per-pixel depth and exact
camera poses. Stereo pairs come from rendering a second camera displaced by
the baseline; RGB-D uses the depth buffer directly.

Rendering is plain numpy (host-side test fixture, not part of the engine).
"""
from __future__ import annotations

import numpy as np

from ..geometry.camera import Intrinsics

def _quat_to_matrix(q) -> np.ndarray:
    """Rotation matrix of a (w, x, y, z) quaternion, in float32 like the
    engine's own se3.quat_to_matrix."""
    w, x, y, z = np.asarray(q, np.float32)
    one, two = np.float32(1.0), np.float32(2.0)
    return np.array([
        [one - two * (y * y + z * z), two * (x * y - w * z), two * (x * z + w * y)],
        [two * (x * y + w * z), one - two * (x * x + z * z), two * (y * z - w * x)],
        [two * (x * z - w * y), two * (y * z + w * x), one - two * (x * x + y * y)],
    ], dtype=np.float32)


def _so3_exp_quat(w) -> np.ndarray:
    """Axis-angle vector -> unit (w, x, y, z) quaternion with w >= 0, in
    float32 (same branches as se3.so3_exp_quat)."""
    w = np.asarray(w, np.float32)
    theta = np.sqrt(np.sum(w * w) + np.float32(1e-24), dtype=np.float32)
    half = np.float32(0.5) * theta
    sinc = (np.float32(1.0) - half * half / np.float32(6.0)
            if abs(half) < 1e-4 else np.sin(half) / half)
    q = np.concatenate([[np.cos(half)], w * np.float32(0.5) * sinc]
                       ).astype(np.float32)
    q = q / max(np.linalg.norm(q), np.float32(1e-8))
    return -q if q[0] < 0 else q


DEFAULT_CAM = Intrinsics(fx=450.0, fy=450.0, cx=320.0, cy=240.0, bf=45.0,
                         width=640, height=480)


def make_texture(seed: int = 0, size: int = 1024) -> np.ndarray:
    """High-contrast, locally unique texture.

    Sharp random blocks at three scales give FAST corners across pyramid
    levels; mixing scales (32/16/8 px) plus a smooth large-scale ramp makes
    neighbouring block corners visually distinct — a single-scale block grid
    is adversarially self-similar and produces aliased matches that drag
    robust pose estimation (observed failure mode in early testing).
    """
    rng = np.random.default_rng(seed)

    def blocks(px, lo, hi):
        g = rng.uniform(lo, hi, size=(size // px, size // px))
        return np.kron(g, np.ones((px, px)))

    tex = (blocks(32, 0, 150) * 0.9
           + blocks(16, 0, 110)
           + blocks(8, -35, 35))
    # smooth large-scale ramp (bilinear upsample of a coarse grid)
    coarse = rng.uniform(-50, 50, size=(9, 9))
    yy = np.linspace(0, 8, size)
    y0 = np.clip(yy.astype(int), 0, 7)
    fy = yy - y0
    ramp_rows = (coarse[y0] * (1 - fy)[:, None] + coarse[y0 + 1] * fy[:, None])
    ramp = (ramp_rows[:, y0] * (1 - fy)[None, :]
            + ramp_rows[:, y0 + 1] * fy[None, :])
    fine = rng.uniform(-6, 6, size=(size, size))
    return np.clip(tex + ramp + fine + 20, 0, 255).astype(np.float32)


class BoxScene:
    """Axis-aligned textured box corridor.

    Geometry (world frame, camera starts at origin looking +z):
      floor  y = +1.5, ceiling y = -1.5, walls x = ±2.5, back wall z = z_far.
    Each surface gets its own texture tile; texture coordinates are the two
    free world coordinates scaled by `tex_scale` px/m.
    """

    def __init__(self, seed: int = 0, z_far: float = 30.0,
                 half_w: float = 2.5, half_h: float = 1.5,
                 tex_scale: float = 120.0):
        self.z_far = z_far
        self.half_w = half_w
        self.half_h = half_h
        self.tex_scale = tex_scale
        # texture must NOT wrap within the scene: with a 1024-px tile at
        # 120 px/m the walls repeated every ~8.5 m and the corridor became
        # perceptually periodic — place recognition then finds GENUINE
        # (descriptor- and geometry-consistent) matches between places
        # meters apart, and every such "loop closure" corrupts the map
        # (observed: false loops at frames 95/127 of the 660-frame run,
        # 40 lost frames after the bogus correction)
        size = int(min(max(1024, tex_scale * (z_far + 4.0)), 8192))
        size = -(-size // 32) * 32   # block generator needs a 32-px multiple
        self.textures = [make_texture(seed + i, size=size) for i in range(6)]

    def _sample(self, tex_id, a, b):
        """Bilinear sample texture `tex_id` at world coords (a, b) in meters."""
        tex = self.textures[tex_id]
        n = tex.shape[0]
        u = (a * self.tex_scale) % (n - 1)
        v = (b * self.tex_scale) % (n - 1)
        u0 = np.floor(u).astype(np.int64)
        v0 = np.floor(v).astype(np.int64)
        fu, fv = u - u0, v - v0
        t00 = tex[v0, u0]
        t01 = tex[v0, u0 + 1]
        t10 = tex[v0 + 1, u0]
        t11 = tex[v0 + 1, u0 + 1]
        return (t00 * (1 - fv) * (1 - fu) + t01 * (1 - fv) * fu
                + t10 * fv * (1 - fu) + t11 * fv * fu)

    def render(self, cam: Intrinsics, q_wc: np.ndarray, t_wc: np.ndarray):
        """Render (image, depth) for camera-to-world pose (q_wc wxyz, t_wc).

        Per-pixel raycast against the five box planes; nearest positive hit
        wins. Returns float32 image [H, W] (0..255) and depth [H, W] (camera
        z, meters).
        """
        h, w = cam.height, cam.width
        u, v = np.meshgrid(np.arange(w, dtype=np.float64),
                           np.arange(h, dtype=np.float64))
        dirs_c = np.stack([(u - cam.cx) / cam.fx, (v - cam.cy) / cam.fy,
                           np.ones_like(u)], axis=-1)          # [H, W, 3]
        R = _quat_to_matrix(q_wc)
        dirs_w = dirs_c @ R.T                                   # [H, W, 3]
        o = t_wc[None, None, :]

        best_t = np.full((h, w), np.inf)
        color = np.zeros((h, w), np.float32)

        # (axis, value, tex_id): floor/ceiling (y), left/right walls (x),
        # far wall (z) and near wall closing the corridor behind the start —
        # without it a camera that turns 180 degrees at the start faces open
        # void and tracking starves (observed: frames 601-617 of the 660
        # frame loop lose tracking exactly when facing backward at z~1)
        planes = [(1, self.half_h, 0), (1, -self.half_h, 1),
                  (0, -self.half_w, 2), (0, self.half_w, 3),
                  (2, self.z_far, 4), (2, -0.5, 5)]
        for axis, value, tex_id in planes:
            d_ax = dirs_w[..., axis]
            with np.errstate(divide="ignore", invalid="ignore"):
                t_hit = (value - o[..., axis]) / d_ax
            ok = (t_hit > 0.05) & np.isfinite(t_hit)
            pt = o + dirs_w * t_hit[..., None]
            # inside the box cross-section?
            for other in (0, 1, 2):
                if other == axis:
                    continue
                lim = (self.half_w, self.half_h, self.z_far)[other]
                lo = -lim if other != 2 else -0.5
                ok &= (pt[..., other] >= lo - 1e-6) & (pt[..., other] <= lim + 1e-6)
            ok &= t_hit < best_t
            ax_a, ax_b = [i for i in range(3) if i != axis]
            val = self._sample(tex_id, np.where(ok, pt[..., ax_a], 0.0),
                               np.where(ok, pt[..., ax_b], 0.0))
            color = np.where(ok, val, color)
            best_t = np.where(ok, t_hit, best_t)

        depth_cam = np.where(np.isfinite(best_t),
                             best_t * dirs_c[..., 2], 0.0)  # z = t * dir_z(=1)
        return color.astype(np.float32), depth_cam.astype(np.float32)

    def render_stereo(self, cam: Intrinsics, q_wc, t_wc):
        """(left, right, depth_left). Right camera displaced +baseline along
        the camera x axis."""
        left, depth = self.render(cam, q_wc, t_wc)
        R = _quat_to_matrix(q_wc)
        t_right = t_wc + R @ np.array([cam.baseline, 0.0, 0.0])
        right, _ = self.render(cam, q_wc, t_right)
        return left, right, depth


def corridor_trajectory(n_frames: int, step: float = 0.12,
                        yaw_rate: float = 0.0, seed: int = 0):
    """Camera-to-world poses (q_wc [n,4], t_wc [n,3]) walking down +z with
    optional constant yaw and small pose jitter."""
    rng = np.random.default_rng(seed)
    qs, ts = [], []
    for i in range(n_frames):
        yaw = yaw_rate * i
        jitter = rng.normal(0, 0.002, size=3)
        w = np.array([0.0, yaw, 0.0]) + rng.normal(0, 0.001, size=3)
        q = _so3_exp_quat(w)
        t = np.array([0.0, 0.0, step * i]) + jitter
        qs.append(q)
        ts.append(t)
    return np.stack(qs), np.stack(ts)
