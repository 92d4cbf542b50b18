"""Per-frame feature data: undistortion and stereo matching.

Counterpart of the JAX package's ``ops/frame.py``:

- radius queries are dense masked comparisons over the fixed-capacity
  keypoint array (no feature grid);
- stereo matching is one masked [N, N] Hamming argmin followed by a batched
  1-D SAD correlation with parabola subpixel refinement.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import SlamConfig
from ..geometry import camera as cam_mod
from ..utils.torch_ops import const_tensor
from . import hamming, orb


class FrameFeatures(NamedTuple):
    """Fixed-capacity per-frame features."""
    xy: torch.Tensor        # [N, 2] undistorted level-0 pixel coords
    response: torch.Tensor  # [N]
    level: torch.Tensor     # [N] int32
    angle: torch.Tensor     # [N]
    desc: torch.Tensor      # [N, 8] int32 (bit pattern of uint32 words)
    valid: torch.Tensor     # [N] bool
    u_right: torch.Tensor   # [N] right-image x (< 0 if mono/no match)
    depth: torch.Tensor     # [N] depth in meters (< 0 if unknown)


def from_keypoints(kp: orb.Keypoints, cfg: SlamConfig) -> FrameFeatures:
    """Mono frame: undistort keypoints, no stereo columns."""
    n = kp.xy.shape[0]
    xy_und = cam_mod.undistort_points(cfg.camera, kp.xy)
    neg = torch.full((n,), -1.0, device=kp.xy.device)
    return FrameFeatures(xy_und, kp.response, kp.level, kp.angle, kp.desc,
                         kp.valid, neg, neg)


def sad_subpixel_refine(left_img, right_img, xy_l, x_r, valid,
                        win: int = 5, search: int = 5):
    """Batched SAD subpixel disparity refinement.

    For each match, slide an (2*win+1)^2 window in the right image over
    [x_r - search, x_r + search], take the SAD minimum, then fit a parabola
    through the three SADs around the minimum for sub-pixel correction.
    Returns refined right-x and a validity mask.

    The right-image strip is gathered once per match with its start clamped
    to the edge-padded image, exactly as the JAX package does; a strip that
    would leave the image is therefore shifted, not rejected.
    """
    w = win
    patch_l = orb.extract_patches(left_img, torch.round(xy_l).to(torch.int32), w)
    xy_c = torch.stack([torch.round(x_r).to(torch.int32),
                        torch.round(xy_l[:, 1]).to(torch.int32)], dim=-1)
    strip = orb.extract_patches_rect(right_img, xy_c, w, w + search)
    sad = torch.stack([
        torch.sum(torch.abs(strip[:, :, d:d + 2 * w + 1] - patch_l),
                  dim=(-2, -1))
        for d in range(2 * search + 1)], dim=1)               # [N, S]
    best = torch.argmin(sad, dim=-1)
    ctr = best.clamp(1, 2 * search - 1)
    s_m = torch.gather(sad, 1, (ctr - 1)[:, None])[:, 0]
    s_0 = torch.gather(sad, 1, ctr[:, None])[:, 0]
    s_p = torch.gather(sad, 1, (ctr + 1)[:, None])[:, 0]
    denom = (s_m + s_p - 2 * s_0).clamp_min(1e-6)
    delta = (0.5 * (s_m - s_p) / denom).clamp(-1.0, 1.0)
    x_refined = torch.round(x_r) + (ctr - search).to(torch.float32) + delta
    # reject if the parabola is degenerate (flat) or best hit the border
    ok = valid & (torch.abs(delta) <= 1.0) & (best > 0) & (best < 2 * search)
    return x_refined, ok


def compute_stereo_matches(left: FrameFeatures, kp_r: orb.Keypoints,
                           left_img, right_img, cfg: SlamConfig) -> FrameFeatures:
    """Match left keypoints against right keypoints along rectified rows and
    fill u_right/depth."""
    mcfg = cfg.matcher
    ocfg = cfg.orb
    cam = cfg.camera
    scales = const_tensor(ocfg.scale_factors, torch.float32, left.xy.device)

    max_d = cam.bf / max(cam.baseline, 1e-6)  # minZ = baseline -> maxD = fx
    min_d = 0.0

    # [N_l, N_r] candidate mask: row band scaled by octave, disparity window
    yl = left.xy[:, 1][:, None]
    yr = kp_r.xy[None, :, 1]
    r_band = 2.0 * scales[left.level.long()][:, None]
    row_ok = torch.abs(yl - yr) <= r_band
    disp = left.xy[:, 0][:, None] - kp_r.xy[None, :, 0]
    disp_ok = (disp >= min_d - 2.0) & (disp <= max_d)
    lvl_ok = torch.abs(left.level[:, None] - kp_r.level[None, :]) <= 1
    mask = row_ok & disp_ok & lvl_ok & left.valid[:, None] & kp_r.valid[None, :]

    dist = hamming.hamming_matrix(left.desc, kp_r.desc)
    th = (mcfg.th_high + mcfg.th_low) // 2
    idx, best, _ = hamming.masked_argmin(dist, mask)
    matched = best < th

    x_r0 = kp_r.xy[idx, 0]
    x_ref, ok = sad_subpixel_refine(left_img, right_img, left.xy, x_r0, matched)
    # disparity between the patch-aligned integer left column and the refined
    # right column (both patches are gathered at integer grid positions)
    disparity = torch.round(left.xy[:, 0]) - x_ref
    good = ok & (disparity > 0.01) & (disparity < max_d)
    neg = torch.full_like(disparity, -1.0)
    u_right = torch.where(good, left.xy[:, 0] - disparity, neg)
    depth = torch.where(good, cam.bf / disparity.clamp_min(1e-6), neg)
    return left._replace(u_right=u_right, depth=depth)


def features_in_area(feats: FrameFeatures, center_xy, radius,
                     min_level=None, max_level=None):
    """Dense mask of keypoints within the square window around each centre.

    center_xy [..., 2], radius [...] broadcastable; returns bool mask [M, N].
    """
    dev = feats.xy.device
    cx = torch.atleast_2d(torch.as_tensor(center_xy, dtype=torch.float32,
                                          device=dev))      # [M, 2]
    r = torch.as_tensor(radius, dtype=torch.float32,
                        device=dev).expand(cx.shape[0])
    dx = torch.abs(feats.xy[None, :, 0] - cx[:, None, 0])
    dy = torch.abs(feats.xy[None, :, 1] - cx[:, None, 1])
    m = (dx < r[:, None]) & (dy < r[:, None]) & feats.valid[None, :]
    if min_level is not None:
        m = m & (feats.level[None, :]
                 >= torch.as_tensor(min_level, device=dev)[..., None])
    if max_level is not None:
        m = m & (feats.level[None, :]
                 <= torch.as_tensor(max_level, device=dev)[..., None])
    return m


def _as_image(img, device):
    if isinstance(img, np.ndarray):
        img = torch.from_numpy(np.ascontiguousarray(img))
    return img.to(device=device, dtype=torch.float32)


@torch.no_grad()
def extract_frame(img, cfg: SlamConfig, right_img=None, depth_map=None,
                  device=torch.device("cuda")) -> FrameFeatures:
    """Full frame construction: ORB extraction (+ right image), undistortion,
    stereo fill. Images are numpy arrays or tensors; the work runs on
    `device`."""
    if depth_map is not None:
        raise NotImplementedError(
            "RGB-D frames (compute_stereo_from_rgbd) are not ported yet: "
            "ROADMAP.md queue 1, 'Mono, RGB-D and relocalization'")
    img = _as_image(img, device)
    kp = orb.pad_keypoints(orb.extract(img, cfg.orb), cfg.caps.max_features)
    feats = from_keypoints(kp, cfg)
    if right_img is not None:
        right_img = _as_image(right_img, device)
        kp_r = orb.pad_keypoints(orb.extract(right_img, cfg.orb),
                                 cfg.caps.max_features)
        feats = compute_stereo_matches(feats, kp_r, img, right_img, cfg)
    return feats
