"""The stream cell's imagery, rendered on the card: a copy of the port's
synthetic box corridor (``io/synthetic.BoxScene`` and ``make_texture``)
in PyTorch, and the loop path of ``analysis/make_synth_seq``.

The scene is an axis-aligned box corridor (floor and ceiling at y = +-half_h,
walls at x = +-half_w, a far wall at z = z_far and a near wall at z = -0.5),
each surface with its own texture of random blocks at three scales, a
smooth ramp and fine noise, sampled bilinearly at ``tex_scale`` px/m. Each
pixel's ray is cast against the six planes and the nearest hit inside the
box wins. The textures are drawn on the card from the seed (the host copy
draws them with numpy); given the same textures, a frame equals the host
copy's to rounding (the tests hold it to that at a small size).
"""
from __future__ import annotations

import math

import numpy as np
import torch


def texture_size(z_far: float, tex_scale: float) -> int:
    size = int(min(max(1024, tex_scale * (z_far + 4.0)), 8192))
    return -(-size // 32) * 32


def make_texture(g: torch.Generator, size: int, device) -> torch.Tensor:
    """One corridor texture [size, size] float32, drawn with `g`."""
    f32 = dict(dtype=torch.float32, device=device)

    def blocks(px, lo, hi):
        n = size // px
        b = lo + (hi - lo) * torch.rand(n, n, generator=g, **f32)
        return b.repeat_interleave(px, 0).repeat_interleave(px, 1)

    tex = blocks(32, 0, 150) * 0.9 + blocks(16, 0, 110) + blocks(8, -35, 35)
    coarse = -50 + 100 * torch.rand(9, 9, generator=g, **f32)
    yy = torch.linspace(0, 8, size, **f32)
    y0 = yy.long().clamp(0, 7)
    fy = yy - y0
    rows = coarse[y0] * (1 - fy)[:, None] + coarse[y0 + 1] * fy[:, None]
    ramp = rows[:, y0] * (1 - fy)[None, :] + rows[:, y0 + 1] * fy[None, :]
    fine = -6 + 12 * torch.rand(size, size, generator=g, **f32)
    return (tex + ramp + fine + 20).clamp(0, 255)


class CardScene:
    """The box corridor with its six textures on `device`."""

    def __init__(self, textures, z_far: float, half_w: float = 2.5,
                 half_h: float = 1.5, tex_scale: float = 120.0):
        self.textures = textures
        self.z_far, self.half_w, self.half_h = z_far, half_w, half_h
        self.tex_scale = tex_scale

    @classmethod
    def from_seed(cls, seed: int, device, z_far: float, **kw):
        g = torch.Generator(device=device)
        g.manual_seed(seed)
        size = texture_size(z_far, kw.get("tex_scale", 120.0))
        tex = [make_texture(g, size, device) for _ in range(6)]
        return cls(tex, z_far, **kw)

    def _sample(self, tex_id, a, b):
        tex = self.textures[tex_id]
        n = tex.shape[0]
        u = torch.remainder(a * self.tex_scale, n - 1)
        v = torch.remainder(b * self.tex_scale, n - 1)
        u0 = torch.floor(u).long()
        v0 = torch.floor(v).long()
        fu, fv = (u - u0).float(), (v - v0).float()
        t00, t01 = tex[v0, u0], tex[v0, u0 + 1]
        t10, t11 = tex[v0 + 1, u0], tex[v0 + 1, u0 + 1]
        return (t00 * (1 - fv) * (1 - fu) + t01 * (1 - fv) * fu
                + t10 * fv * (1 - fu) + t11 * fv * fu)

    def render(self, cam: dict, R_wc: torch.Tensor, t_wc: torch.Tensor):
        """Images [..., H, W] float32 (0..255) of camera-to-world poses
        (R_wc [..., 3, 3], t_wc [..., 3], float64), all in one pass."""
        dev = self.textures[0].device
        f64 = dict(dtype=torch.float64, device=dev)
        h, w = cam["height"], cam["width"]
        v, u = torch.meshgrid(torch.arange(h, **f64), torch.arange(w, **f64),
                              indexing="ij")
        dirs_c = torch.stack([(u - cam["cx"]) / cam["fx"],
                              (v - cam["cy"]) / cam["fy"],
                              torch.ones_like(u)], -1)
        lead = R_wc.shape[:-2]
        dirs_w = dirs_c @ R_wc.transpose(-1, -2)[..., None, :, :]
        o = t_wc[..., None, None, :]
        best = torch.full(lead + (h, w), math.inf, **f64)
        color = torch.zeros(lead + (h, w), dtype=torch.float32, device=dev)
        lims = (self.half_w, self.half_h, self.z_far)
        planes = [(1, self.half_h, 0), (1, -self.half_h, 1),
                  (0, -self.half_w, 2), (0, self.half_w, 3),
                  (2, self.z_far, 4), (2, -0.5, 5)]
        for axis, value, tex_id in planes:
            d_ax = dirs_w[..., axis]
            t_hit = (value - o[..., axis]) / d_ax
            ok = (t_hit > 0.05) & torch.isfinite(t_hit)
            pt = o + dirs_w * t_hit[..., None]
            for other in (0, 1, 2):
                if other == axis:
                    continue
                lo = -lims[other] if other != 2 else -0.5
                ok &= (pt[..., other] >= lo - 1e-6) & \
                    (pt[..., other] <= lims[other] + 1e-6)
            ok &= t_hit < best
            ax_a, ax_b = [i for i in range(3) if i != axis]
            val = self._sample(tex_id, torch.where(ok, pt[..., ax_a], 0.0),
                               torch.where(ok, pt[..., ax_b], 0.0))
            color = torch.where(ok, val, color)
            best = torch.where(ok, t_hit, best)
        return color

    def render_stereo_u8(self, cam: dict, R_wc, t_wc):
        """(left, right) uint8 on the card, [..., H, W]: the right camera
        displaced by the baseline along the camera's x axis."""
        left = self.render(cam, R_wc, t_wc)
        t_right = t_wc + R_wc[..., :, 0] * (cam["bf"] / cam["fx"])
        right = self.render(cam, R_wc, t_right)
        return (left.clamp(0, 255).to(torch.uint8),
                right.clamp(0, 255).to(torch.uint8))


def _so3_exp_quat(w):
    w = np.asarray(w, np.float32)
    theta = np.sqrt(np.sum(w * w) + np.float32(1e-24), dtype=np.float32)
    half = np.float32(0.5) * theta
    sinc = (np.float32(1.0) - half * half / np.float32(6.0)
            if abs(half) < 1e-4 else np.sin(half) / half)
    q = np.concatenate([[np.cos(half)], w * np.float32(0.5) * sinc]
                       ).astype(np.float32)
    q = q / max(np.linalg.norm(q), np.float32(1e-8))
    return -q if q[0] < 0 else q


def loop_trajectory(n_frames: int, z_lo: float, z_hi: float, seed: int):
    """Camera-to-world poses (q_wc [n, 4] (w, x, y, z), t_wc [n, 3]) of
    ``analysis/make_synth_seq.loop_trajectory``: forward along +z, a
    180-degree turn in place, back, and a turn at the start."""
    rng = np.random.default_rng(seed)
    n_turn = min(max(n_frames // 14, 24), max(n_frames // 4, 1))
    n_leg = max((n_frames - 2 * n_turn) // 2, 1)
    zs = list(np.linspace(z_lo, z_hi, n_leg))
    yaw = [0.0] * n_leg
    yaw += list(np.linspace(0.0, np.pi, n_turn))
    zs += list(np.full(n_turn, z_hi))
    zs += list(np.linspace(z_hi, z_lo, n_leg))
    yaw += [np.pi] * n_leg
    rest = n_frames - len(zs)
    yaw += list(np.linspace(np.pi, 2 * np.pi, rest))
    zs += list(np.full(rest, z_lo))
    qs, ts = [], []
    for i in range(n_frames):
        w = np.array([0.0, yaw[i], 0.0]) + rng.normal(0, 0.002, 3)
        qs.append(_so3_exp_quat(w))
        ts.append(np.array([0.35 * np.sin(i * 0.05), 0.15 * np.sin(i * 0.03),
                            zs[i]]) + rng.normal(0, 0.004, 3))
    return np.stack(qs), np.stack(ts)


def quat_to_rot_np(q) -> np.ndarray:
    w, x, y, z = np.asarray(q, np.float64)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
