"""Batched ORB feature extraction: pyramid + FAST + IC-angle + rBRIEF.

Counterpart of the JAX package's ``ops/orb.py`` (a data-parallel re-design of
the reference ORBextractor):

- image pyramid (scale 1.2) by antialiased bilinear resize;
- FAST-9/16 corner scoring as a dense score map over the whole level, with
  the 20 -> 7 dual threshold applied per 30x30 cell;
- spatial balancing via per-cell rank keys + global top-K: the best corner of
  every cell wins over any cell's second best, ties broken by score;
- intensity-centroid orientation over a circular patch;
- 7x7 sigma=2 Gaussian blur before descriptor sampling;
- 256-bit rotated-BRIEF descriptors packed as [8] int32 words (the bit
  pattern of the JAX package's uint32), from the same fixed-seed Gaussian
  point-pair pattern, so descriptors of the two packages are comparable.

All outputs are fixed-capacity tensors with validity masks.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import OrbConfig
from ..utils.torch_ops import top_k_stable
from . import hamming

# 16-point Bresenham circle of radius 3, clockwise from 12 o'clock (dy, dx).
_FAST_RING = np.array(
    [(-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
     (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1)],
    dtype=np.int32,
)
_ARC = 9  # FAST-9: corner needs 9 contiguous ring pixels brighter/darker


class Keypoints(NamedTuple):
    """Fixed-capacity keypoint set for one frame."""
    xy: torch.Tensor        # [N, 2] float32, level-0 (full-res) pixel coords
    response: torch.Tensor  # [N] float32 FAST score
    level: torch.Tensor     # [N] int32 pyramid level
    angle: torch.Tensor     # [N] float32 radians
    desc: torch.Tensor      # [N, 8] int32 packed 256-bit rBRIEF
    valid: torch.Tensor     # [N] bool

    @property
    def n(self):
        return torch.sum(self.valid.to(torch.int32))


# ---------------------------------------------------------------------------
# Pattern generation
# ---------------------------------------------------------------------------

@functools.lru_cache()
def brief_pattern(n_bits: int = 256, radius: int = 13, seed: int = 42):
    """Deterministic Gaussian BRIEF point-pair pattern [n_bits, 4] =
    (x1,y1,x2,y2); numpy, identical to the JAX package's."""
    rng = np.random.default_rng(seed)
    sigma = radius / 2.0
    pts = rng.normal(0.0, sigma, size=(n_bits, 4))
    pts = np.clip(pts, -radius, radius)
    return np.asarray(pts, dtype=np.float32)


# ---------------------------------------------------------------------------
# Pyramid + blur
# ---------------------------------------------------------------------------

@functools.lru_cache()
def _gauss_kernel7(sigma: float = 2.0):
    x = np.arange(7) - 3
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return np.asarray(k / k.sum(), dtype=np.float32)


def _pad_edge(img, py: int, px: int):
    """Replicate-pad a [H, W] image by (py, px) on each side."""
    return F.pad(img[None, None], (px, px, py, py), mode="replicate")[0, 0]


def gaussian_blur7(img):
    """Separable 7x7 Gaussian, sigma=2."""
    k = _gauss_kernel7()
    h, w = img.shape
    pad = _pad_edge(img, 3, 0)
    acc = float(k[0]) * pad[0:h]
    for i in range(1, 7):
        acc = acc + float(k[i]) * pad[i:i + h]
    pad = _pad_edge(acc, 0, 3)
    out = float(k[0]) * pad[:, 0:w]
    for i in range(1, 7):
        out = out + float(k[i]) * pad[:, i:i + w]
    return out


def pyramid_shapes(h: int, w: int, cfg: OrbConfig):
    return [(max(int(round(h / s)), 64), max(int(round(w / s)), 64))
            for s in cfg.scale_factors]


def build_pyramid(img, cfg: OrbConfig):
    """[H, W] float32 -> list of per-level images (static shapes).

    Antialiased bilinear (triangle filter widened by the scale, half-pixel
    centres): the same filter as jax.image.resize(method="linear")."""
    h, w = img.shape
    levels = [img]
    for (lh, lw) in pyramid_shapes(h, w, cfg)[1:]:
        levels.append(F.interpolate(img[None, None], size=(lh, lw),
                                    mode="bilinear", antialias=True,
                                    align_corners=False)[0, 0])
    return levels


# ---------------------------------------------------------------------------
# FAST-9/16 dense corner score
# ---------------------------------------------------------------------------

def fast_score(img):
    """Dense FAST-9 corner score map.

    score(p) = max over the 16 length-9 contiguous arcs of
               min_i |ring_i - center| such that the whole arc is brighter
               (or darker) than the center.

    The 9-wide sliding minimum over the ring is built by doubling
    (2, 4, 8, then 9 wide); min and max are exact, so the result equals the
    direct 16 x 9 evaluation bit for bit.
    """
    h, w = img.shape
    pad = _pad_edge(img, 3, 3)
    ring = torch.stack([pad[3 + dy:3 + dy + h, 3 + dx:3 + dx + w]
                        for dy, dx in _FAST_RING.tolist()])   # [16, H, W]
    d = ring - img[None]                                   # brighter: d > t
    d_ext = torch.cat([d, d[:_ARC - 1]], dim=0)            # [24, H, W]

    def arcs(red):
        m2 = red(d_ext[:-1], d_ext[1:])                    # 23
        m4 = red(m2[:-2], m2[2:])                          # 21
        m8 = red(m4[:-4], m4[4:])                          # 17
        return red(m8[:16], d_ext[8:24])                   # 16 arcs of 9

    score_b = torch.amax(arcs(torch.minimum), dim=0)
    # min over an arc of -d is -(max over the arc of d)
    score_d = torch.amax(-arcs(torch.maximum), dim=0)
    return torch.maximum(score_b, score_d)


def _cell_ids(h, w, cell, device):
    ncx = -(-w // cell)
    cy = torch.arange(h, device=device) // cell
    cx = torch.arange(w, device=device) // cell
    return cy[:, None] * ncx + cx[None, :]


def detect_level(img, budget: int, cfg: OrbConfig, border: int):
    """One pyramid level -> (xy [budget, 2] int32 level coords, score, valid).

    Pipeline: dense FAST score -> per-cell dual threshold (ini 20 else 7) ->
    3x3 NMS -> global candidate top-M -> per-cell rank keys ->
    top-`budget` selection (spatial balance).
    """
    h, w = img.shape
    dev = img.device
    score = fast_score(img)
    neg_inf = torch.full_like(score, -torch.inf)

    # border mask (EDGE_THRESHOLD=19 minus the FAST radius)
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    inb = (ys >= border) & (ys < h - border) & (xs >= border) & (xs < w - border)

    cell = cfg.cell_size
    cid = _cell_ids(h, w, cell, dev)

    # per-cell dual threshold: ini_th where the cell has any ini-strength
    # corner, else min_th. Cells are a regular grid: pad + reshape + any.
    strong = (score > cfg.ini_th_fast) & inb
    hc, wc = -(-h // cell), -(-w // cell)
    sp = F.pad(strong, (0, wc * cell - w, 0, hc * cell - h))
    blk = sp.reshape(hc, cell, wc, cell).any(dim=3).any(dim=1)   # [hc, wc]
    blk_th = torch.where(blk, float(cfg.ini_th_fast), float(cfg.min_th_fast))
    th_map = blk_th[:, None, :, None].expand(hc, cell, wc, cell).reshape(
        hc * cell, wc * cell)[:h, :w]
    valid_px = (score > th_map) & inb

    # 3x3 non-max suppression (max_pool2d pads with -inf)
    neg = torch.where(valid_px, score, neg_inf)
    pooled = F.max_pool2d(neg[None, None], kernel_size=3, stride=1,
                          padding=1)[0, 0]
    is_max = valid_px & (neg >= pooled)

    # global candidate pool (bounded): top-M by raw score, lowest index
    # first among equals
    m = min(max(4 * budget, 256), h * w)
    flat_score = torch.where(is_max, score, neg_inf).reshape(-1)
    cand_score, cand_idx = top_k_stable(flat_score, m)
    cand_valid = torch.isfinite(cand_score)
    cand_cid = cid.reshape(-1)[cand_idx]

    # rank within cell: sort candidates by (cell, -score);
    # rank = pos - first(cell). Two stable sorts make the lexicographic one.
    o1 = torch.sort(-cand_score, stable=True).indices
    o2 = torch.sort(cand_cid[o1], stable=True).indices
    order = o1[o2]
    s_cid = cand_cid[order]
    pos = torch.arange(m, device=dev)
    is_new = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                        s_cid[1:] != s_cid[:-1]])
    seg_start = torch.cummax(torch.where(is_new, pos, torch.zeros_like(pos)),
                             dim=0).values
    rank_sorted = pos - seg_start
    rank = torch.zeros(m, dtype=torch.int64, device=dev)
    rank[order] = rank_sorted

    # selection key: lower cell-rank first, then higher score
    key = torch.where(cand_valid,
                      rank.to(torch.float32) * 1e6 - cand_score,
                      torch.full_like(cand_score, torch.inf))
    _, sel = top_k_stable(-key, budget)
    sel_idx = cand_idx[sel]
    sel_score = cand_score[sel]
    sel_valid = torch.isfinite(key[sel]) & (sel_score > 0)
    xy = torch.stack([sel_idx % w, sel_idx // w], dim=-1).to(torch.int32)
    return xy, sel_score, sel_valid


# ---------------------------------------------------------------------------
# Patch gather + orientation + descriptor
# ---------------------------------------------------------------------------

def extract_patches_rect(img, xy, ry: int, rx: int):
    """Gather (2*ry+1) x (2*rx+1) patches around integer keypoints.
    xy: [N, 2] int32 (x, y) centers. One flat gather; the window start is
    clamped so the window stays inside the edge-padded image."""
    pad = _pad_edge(img, ry, rx)
    ph, w = pad.shape
    y0 = xy[:, 1].long().clamp(0, ph - (2 * ry + 1))
    x0 = xy[:, 0].long().clamp(0, w - (2 * rx + 1))
    oy = torch.arange(2 * ry + 1, device=img.device)
    ox = torch.arange(2 * rx + 1, device=img.device)
    yy = y0[:, None, None] + oy[None, :, None]            # [N, Py, 1]
    xx = x0[:, None, None] + ox[None, None, :]            # [N, 1, Px]
    idx = yy * w + xx                                      # [N, Py, Px]
    return pad.reshape(-1)[idx.reshape(-1)].reshape(idx.shape)


def extract_patches(img, xy, radius: int):
    """Gather (2r+1)^2 square patches around integer keypoints."""
    return extract_patches_rect(img, xy, radius, radius)


@functools.lru_cache()
def _circular_mask(patch: int, radius: int):
    c = patch // 2
    y, x = np.mgrid[:patch, :patch]
    m = ((y - c) ** 2 + (x - c) ** 2) <= radius ** 2
    return (np.asarray(m, dtype=np.float32),
            np.asarray(x - c, dtype=np.float32),
            np.asarray(y - c, dtype=np.float32))


@functools.lru_cache()
def _circular_mask_t(patch: int, radius: int, device_str: str):
    return tuple(torch.from_numpy(a).to(device_str)
                 for a in _circular_mask(patch, radius))


def ic_angle(patches, radius: int):
    """Intensity-centroid orientation: angle = atan2(m01, m10) over a
    circular patch."""
    mask, xrel, yrel = _circular_mask_t(patches.shape[-1], radius,
                                        str(patches.device))
    m10 = torch.sum(patches * xrel * mask, dim=(-2, -1))
    m01 = torch.sum(patches * yrel * mask, dim=(-2, -1))
    return torch.atan2(m01, m10)


def _bilinear(patches, yx):
    """Sample patches [N, P, P] at float coords yx [N, S, 2] (y, x)."""
    p = patches.shape[-1]
    y = yx[..., 0].clamp(0.0, p - 1.001)
    x = yx[..., 1].clamp(0.0, p - 1.001)
    y0f, x0f = torch.floor(y), torch.floor(x)
    fy, fx = y - y0f, x - x0f
    flat = patches.reshape(patches.shape[0], -1)
    base = y0f.long() * p + x0f.long()
    v00 = torch.gather(flat, -1, base)
    v01 = torch.gather(flat, -1, base + 1)
    v10 = torch.gather(flat, -1, base + p)
    v11 = torch.gather(flat, -1, base + p + 1)
    return (v00 * (1 - fy) * (1 - fx) + v01 * (1 - fy) * fx
            + v10 * fy * (1 - fx) + v11 * fy * fx)


@functools.lru_cache(maxsize=8)
def _brief_pattern_t(device_str: str):
    """The default pattern, uploaded once per device."""
    return torch.from_numpy(brief_pattern()).to(device_str)


def brief_descriptors(patches, angles, pattern=None):
    """Rotated-BRIEF: rotate the pattern by each keypoint's angle, sample
    bilinearly from the blurred patch, compare pairs, pack to [N, 8] int32."""
    if pattern is None:
        pattern = _brief_pattern_t(str(patches.device))
    else:
        pattern = torch.as_tensor(pattern, device=patches.device)
    c = patches.shape[-1] // 2
    ca, sa = torch.cos(angles), torch.sin(angles)         # [N]
    p1 = pattern[:, :2]
    p2 = pattern[:, 2:]

    def rot(p):  # [256, 2] -> [N, 256, 2] (y, x) patch coords
        x = p[None, :, 0] * ca[:, None] - p[None, :, 1] * sa[:, None]
        y = p[None, :, 0] * sa[:, None] + p[None, :, 1] * ca[:, None]
        return torch.stack([y + c, x + c], dim=-1)

    v1 = _bilinear(patches, rot(p1))
    v2 = _bilinear(patches, rot(p2))
    return hamming.pack_bits(v1 < v2)                  # [N, 256] -> [N, 8]


# ---------------------------------------------------------------------------
# Full extractor
# ---------------------------------------------------------------------------

@torch.no_grad()
def extract(img, cfg: OrbConfig) -> Keypoints:
    """Full ORB extraction on one grayscale image [H, W] float32 (0..255).

    Returns a fixed-capacity Keypoints with sum(level_budgets) slots.
    """
    levels = build_pyramid(img, cfg)
    budgets = cfg.level_budgets
    scales = cfg.scale_factors
    border = cfg.patch_radius + 1

    outs = []
    for lvl, (limg, budget, scale) in enumerate(zip(levels, budgets, scales)):
        if budget <= 0:
            continue
        xy, score, valid = detect_level(limg, budget, cfg, border)
        blurred = gaussian_blur7(limg)
        patches = extract_patches(blurred, xy, cfg.patch_radius)
        ang = ic_angle(patches, cfg.angle_radius)
        desc = brief_descriptors(patches, ang)
        outs.append(Keypoints(
            xy=(xy.to(torch.float32) * scale),
            response=score,
            level=torch.full((budget,), lvl, dtype=torch.int32,
                             device=img.device),
            angle=ang,
            desc=desc,
            valid=valid,
        ))
    return Keypoints(*[torch.cat([o[i] for o in outs]) for i in range(6)])


def pad_keypoints(kp: Keypoints, capacity: int) -> Keypoints:
    """Pad/truncate a Keypoints set to a fixed capacity (map-state slots)."""
    n = kp.xy.shape[0]
    if n == capacity:
        return kp

    def fix(a):
        if a.shape[0] >= capacity:
            return a[:capacity]
        return torch.cat([a, a.new_zeros((capacity - n,) + tuple(a.shape[1:]))])

    return Keypoints(*[fix(a) for a in kp])
