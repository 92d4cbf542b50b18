"""Batched binary-descriptor matching: all ORBmatcher entry points as masked
candidate generation + packed-Hamming argmin.

Counterpart of the JAX package's ``ops/matchers.py``. Every search is:

  1. candidate mask [Q, F]   (projection window / epipolar band / all-pairs)
  2. Hamming distances       (ops.hamming)
  3. masked argmin + ratio test per query
  4. optional rotation-consistency histogram filter
  5. conflict resolution     (one query per target feature, best distance wins)

Thresholds follow the reference: TH_HIGH=100, TH_LOW=50, HISTO_LENGTH=30.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..geometry import se3
from ..geometry.camera import Intrinsics
from ..utils.torch_ops import const_tensor, set_drop
from . import hamming
from .frame import FrameFeatures


class MatchResult(NamedTuple):
    best_feat: torch.Tensor   # [Q] int64 best frame-feature per query (-1)
    best_dist: torch.Tensor   # [Q] int32
    ok: torch.Tensor          # [Q] bool


def project_points(cam: Intrinsics, q, t, pw):
    """World points -> (uv [N,2], u_right [N], depth [N], visible mask)."""
    pc = se3.apply(q, t, pw)
    z = pc[..., 2]
    inv_z = 1.0 / torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    u = cam.fx * pc[..., 0] * inv_z + cam.cx
    v = cam.fy * pc[..., 1] * inv_z + cam.cy
    ur = u - cam.bf * inv_z
    uv = torch.stack([u, v], dim=-1)
    vis = (z > 0.05) & (u >= 0) & (u < cam.width) & (v >= 0) & (v < cam.height)
    return uv, ur, z, vis


def _neg_where(ok, idx):
    return torch.where(ok, idx, torch.full_like(idx, -1))


def match_window(frame: FrameFeatures, query_desc, query_mask, pred_uv,
                 radius, pred_ur=None, pred_level=None, level_tol: int = 1,
                 th: int = 100, nn_ratio: float = 1.0) -> MatchResult:
    """Window-constrained matching of Q query descriptors into a frame.

    Covers SearchByProjection for local-map points, frame-to-frame,
    relocalization and Sim3 world points: callers differ only in how
    pred_uv/radius/level are produced.
    """
    dx = torch.abs(frame.xy[None, :, 0] - pred_uv[:, None, 0])
    dy = torch.abs(frame.xy[None, :, 1] - pred_uv[:, None, 1])
    r = torch.as_tensor(radius, dtype=torch.float32,
                        device=pred_uv.device).expand(pred_uv.shape[0])[:, None]
    cand = (dx < r) & (dy < r) & frame.valid[None, :] & query_mask[:, None]
    if pred_level is not None:
        lvl_d = frame.level[None, :] - pred_level[:, None]
        cand &= (lvl_d >= -level_tol) & (lvl_d <= level_tol)
    if pred_ur is not None:
        # stereo coherence where the frame has a right-image match
        has_r = frame.u_right[None, :] >= 0
        ur_ok = torch.abs(frame.u_right[None, :] - pred_ur[:, None]) < r
        cand &= ur_ok | ~has_r

    dist = hamming.hamming_matrix(query_desc, frame.desc)
    idx, best, second = hamming.masked_argmin(dist, cand)
    ok = query_mask & (best <= th)
    if nn_ratio < 1.0:
        ok &= best.to(torch.float32) <= nn_ratio * second.to(torch.float32)
    return MatchResult(_neg_where(ok, idx), best, ok)


def match_brute(query_desc, query_mask, frame_desc, frame_mask,
                th: int = 50, nn_ratio: float = 0.7) -> MatchResult:
    """Unconstrained descriptor matching with ratio test (serves where the
    reference restricts brute force to shared vocabulary nodes; the ratio +
    threshold gates provide the same selectivity)."""
    dist = hamming.hamming_matrix(query_desc, frame_desc)
    cand = query_mask[:, None] & frame_mask[None, :]
    idx, best, second = hamming.masked_argmin(dist, cand)
    ok = query_mask & (best <= th) \
        & (best.to(torch.float32) <= nn_ratio * second.to(torch.float32))
    return MatchResult(_neg_where(ok, idx), best, ok)


def rotation_consistency(query_angle, frame_angle, res: MatchResult,
                         histo_length: int = 30, keep_bins: int = 3):
    """Keep only matches whose angle difference falls in the `keep_bins` most
    popular histogram bins (ComputeThreeMaxima + HISTO_LENGTH=30)."""
    feat = res.best_feat.clamp(0, frame_angle.shape[0] - 1)
    dang = query_angle - frame_angle[feat]
    two_pi = 2.0 * math.pi
    dang = torch.remainder(dang, two_pi)
    bins = torch.floor(dang / two_pi * histo_length).long()
    bins = bins.clamp(0, histo_length - 1)
    hist = torch.zeros(histo_length + 1, dtype=torch.int32,
                       device=bins.device)
    hist.scatter_add_(0, torch.where(res.ok, bins,
                                     torch.full_like(bins, histo_length)),
                      res.ok.to(torch.int32))
    hist = hist[:histo_length]
    top = torch.topk(hist, keep_bins).values
    # reference rule: drop bins below 0.1x the max bin
    th = torch.maximum(top[keep_bins - 1], (0.1 * top[0]).to(hist.dtype))
    good_bin = hist >= th.clamp_min(1)
    keep = res.ok & good_bin[bins]
    return res._replace(ok=keep, best_feat=_neg_where(keep, res.best_feat))


def resolve_conflicts(res: MatchResult, n_feats: int, query_ids=None):
    """One query per frame feature: keep the smallest distance claimant.

    Returns frame_assign [F] = winning query id (-1 none) and an updated
    per-query ok mask. Ties go to the lowest claimant. Small problems use a
    dense [Q, F] masked min/argmin, large query sets a scatter-min; both give
    the same answer.
    """
    Q = res.best_feat.shape[0]
    dev = res.best_feat.device
    if query_ids is None:
        query_ids = torch.arange(Q, dtype=torch.int64, device=dev)
    query_ids = query_ids.long()
    big = 1 << 20
    best_dist = res.best_dist.to(torch.int32)
    if Q * n_feats <= 6 * 1024 * 1024:
        # dense masked min/argmin (argmin's first-minimum rule IS the
        # lowest-claimant tie-break)
        feat = _neg_where(res.ok, res.best_feat)
        claims = feat[:, None] == torch.arange(n_feats, device=dev)[None, :]
        dmat = torch.where(claims, best_dist[:, None],
                           torch.full((1, 1), big, dtype=torch.int32,
                                      device=dev))           # [Q, F]
        feat_best = torch.amin(dmat, dim=0)                   # [F]
        qwin = torch.argmin(dmat, dim=0)
        has = feat_best < big
        frame_assign = _neg_where(has, query_ids[qwin])
        fc = feat.clamp(0, n_feats - 1)
        win = res.ok & has[fc] \
            & (qwin[fc] == torch.arange(Q, device=dev)) & (feat >= 0)
        return frame_assign, res._replace(
            ok=win, best_feat=_neg_where(win, res.best_feat))
    # large query sets (the local-map call): scatter-min
    feat = torch.where(res.ok, res.best_feat,
                       torch.full_like(res.best_feat, n_feats))
    feat_best = torch.full((n_feats + 1,), big, dtype=torch.int32, device=dev)
    feat_best.scatter_reduce_(0, feat, best_dist, "amin")
    win = res.ok & (best_dist <= feat_best[feat])
    feat_winner = torch.full((n_feats + 1,), 1 << 30, dtype=torch.int64,
                             device=dev)
    feat_winner.scatter_reduce_(
        0, torch.where(win, feat, torch.full_like(feat, n_feats)),
        query_ids, "amin")
    win = win & (feat_winner[feat] == query_ids)
    frame_assign = set_drop(
        torch.full((n_feats,), -1, dtype=torch.int64, device=dev),
        torch.where(win, feat, torch.full_like(feat, n_feats)), query_ids)
    return frame_assign, res._replace(
        ok=win, best_feat=_neg_where(win, res.best_feat))


def search_epipolar(kf1_desc, kf1_xy, kf1_level, kf1_mask,
                    kf2_desc, kf2_xy, kf2_level, kf2_mask,
                    F12, scale_factors, th: int = 50,
                    check_orientation=None):
    """Epipolar-constrained matching for triangulation
    (SearchForTriangulation): feature pairs whose epipolar distance in image
    2 is below 3.84 * sigma^2 of the level.

    F12: fundamental matrix mapping image-1 points to epipolar lines in 2.
    Returns MatchResult over kf1 features (targets are kf2 features).
    """
    ones = torch.ones_like(kf1_xy[:, :1])
    x1 = torch.cat([kf1_xy, ones], dim=-1)               # [N1, 3]
    lines = x1 @ F12.T                                   # [N1, 3] lines in im2
    # distance of each kf2 point to each kf1 epipolar line
    dist_num = (lines[:, None, 0] * kf2_xy[None, :, 0]
                + lines[:, None, 1] * kf2_xy[None, :, 1]
                + lines[:, None, 2])
    dist_den = torch.sqrt(lines[:, None, 0] ** 2 + lines[:, None, 1] ** 2
                          + 1e-12)
    epi_d2 = (dist_num / dist_den) ** 2                  # [N1, N2]
    sf = const_tensor(scale_factors, torch.float32, kf1_xy.device)
    sigma2 = sf[kf2_level.long()] ** 2
    cand = (epi_d2 < 3.84 * sigma2[None, :]) & kf1_mask[:, None] \
        & kf2_mask[None, :]

    dmat = hamming.hamming_matrix(kf1_desc, kf2_desc)
    idx, best, _ = hamming.masked_argmin(dmat, cand)
    ok = kf1_mask & (best <= th)
    return MatchResult(_neg_where(ok, idx), best, ok)
