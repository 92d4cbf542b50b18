"""Pipeline steps shared by the tracker and local mapper.

Counterpart of the JAX package's ``runtime/steps.py``: each function is one
phase of the pipeline as a fixed-shape tensor program over MapState
(state in, state out). Where the JAX code uses ``lax.cond`` / ``lax.scan`` to
stay inside one compiled program, eager PyTorch branches on the host: a
Python ``if`` on one fetched scalar, a Python loop over the neighbours. The
host still reads the device a small, fixed number of times per frame: every
read goes through ``utils.torch_ops.host_fetch``, which counts them.

Keyframe slots (``kf_slot``, ``ref_kf``, ``kf1``, ``kf2``) are host integers.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..config import SlamConfig
from ..geometry import camera, se3
from ..mapstate import state as ms
from ..ops import matchers
from ..ops.frame import FrameFeatures
from ..optim import pose_opt
from . import mapping
from ..utils.torch_ops import (add_drop, const_tensor, fill_at,
                               first_true_indices, host_fetch, mask_from_ids,
                               set_drop2, top_k_stable)

NONE = ms.NONE

_ROADMAP_BA = ("local bundle adjustment is not ported yet: ROADMAP.md queue "
               "1, next slice (optim/ba.py, K2 prep kernel, K3 PCG kernel, "
               "local_ba_step, _kf_culling_core)")


def _none_where(ok, val):
    return torch.where(ok, val, torch.full_like(val, NONE))


def _scale_factors(cfg: SlamConfig, device):
    return const_tensor(cfg.orb.scale_factors, torch.float32, device)


# ---------------------------------------------------------------------------
# Initialization (stereo)
# ---------------------------------------------------------------------------

@torch.no_grad()
def stereo_init_step(state: ms.MapState, feats: FrameFeatures, frame_id,
                     agent, map_id, kf_slot: int, mp_base: int,
                     cfg: SlamConfig):
    """First-keyframe bootstrap (Tracking::StereoInitialization): identity
    pose, a map point for every feature with valid depth.
    Returns (state, frame_mp, n_new_points)."""
    K, F, P, O = state.caps
    dev = feats.xy.device
    q0 = se3.quat_identity(device=dev)
    t0 = torch.zeros(3, device=dev)

    new = feats.valid & (feats.depth > 0)
    slots = mp_base + torch.cumsum(new.to(torch.int32), 0, dtype=torch.int32) - 1
    slots = _none_where(new & (slots < P), slots)
    ok = slots >= 0

    # unproject at identity: pc == pw
    pos = camera.backproject(cfg.camera, feats.xy, feats.depth)
    norm = torch.linalg.norm(pos, dim=-1, keepdim=True).clamp_min(1e-9)
    normal = pos / norm
    sf = _scale_factors(cfg, dev)
    dist = norm[:, 0]
    max_d = dist * sf[feats.level.long()]
    min_d = max_d / sf[-1]

    state = ms.add_points(state, slots, pos, feats.desc, normal, min_d, max_d,
                          ref_kf=kf_slot, agent=agent, map_id=map_id, valid=ok)
    frame_mp = _none_where(ok, slots)
    state = ms.insert_keyframe(state, kf_slot, feats, q0, t0, frame_id, agent,
                               map_id, frame_mp, parent=NONE,
                               fixed_origin=True)
    return state, frame_mp, torch.sum(ok.to(torch.int32))


# ---------------------------------------------------------------------------
# Per-frame tracking
# ---------------------------------------------------------------------------

class TrackResult(NamedTuple):
    q: torch.Tensor
    t: torch.Tensor
    frame_mp: torch.Tensor    # [F] point slot per feature (-1)
    n_inliers: torch.Tensor


def _pose_obs_from_frame(state, feats, frame_mp, cfg):
    K, F, P, O = state.caps
    mp = frame_mp.long().clamp(0, P - 1)
    mask = (frame_mp >= 0) & feats.valid
    pw = state.mp_pos[mp]
    sf = _scale_factors(cfg, feats.xy.device)
    inv_sigma2 = 1.0 / sf[feats.level.long()] ** 2
    obs = torch.cat([feats.xy, feats.u_right[:, None]], dim=-1)
    return pose_opt.PoseObs(pw=pw, obs=obs, inv_sigma2=inv_sigma2,
                            is_stereo=feats.u_right >= 0, mask=mask)


@torch.no_grad()
def track_motion_model_step(state: ms.MapState, feats: FrameFeatures,
                            prev_feats: FrameFeatures, prev_frame_mp,
                            q_pred, t_pred, cfg: SlamConfig,
                            radius_mult: float = 1.0) -> TrackResult:
    """Frame-to-frame tracking (TrackWithMotionModel + SearchByProjection
    frame overload): project the previous frame's map points with the
    constant-velocity pose, window-match, rotation-consistency filter,
    pose-only optimize."""
    K, F, P, O = state.caps
    th = 7.0 if cfg.sensor == 1 else 15.0  # reference: 7 stereo, 15 otherwise
    mp = prev_frame_mp.long().clamp(0, P - 1)
    qmask = (prev_frame_mp >= 0) & prev_feats.valid & state.mp_valid[mp]
    pw = state.mp_pos[mp]
    uv, ur, depth, vis = matchers.project_points(cfg.camera, q_pred, t_pred, pw)
    sf = _scale_factors(cfg, feats.xy.device)
    radius = radius_mult * th * sf[prev_feats.level.long()]
    res = matchers.match_window(feats, prev_feats.desc, qmask & vis, uv,
                                radius, pred_ur=ur,
                                pred_level=prev_feats.level,
                                th=cfg.matcher.th_high)
    res = matchers.rotation_consistency(prev_feats.angle, feats.angle, res,
                                        cfg.matcher.histo_length)
    frame_assign, res = matchers.resolve_conflicts(res, F)
    frame_mp = _none_where(frame_assign >= 0,
                           prev_frame_mp[frame_assign.clamp(0, F - 1)])

    obs = _pose_obs_from_frame(state, feats, frame_mp, cfg)
    q, t, inlier, n = pose_opt.pose_optimize(q_pred, t_pred, obs, cfg.camera,
                                             cfg.optimizer)
    frame_mp = _none_where(inlier, frame_mp)
    return TrackResult(q, t, frame_mp, n)


@torch.no_grad()
def track_reference_kf_step(state: ms.MapState, feats: FrameFeatures,
                            ref_kf: int, q_init, t_init, cfg: SlamConfig
                            ) -> TrackResult:
    """Fallback: match against the reference keyframe's map points by
    unconstrained descriptor matching with ratio test
    (TrackReferenceKeyFrame + SearchByBoW; see matchers.match_brute)."""
    K, F, P, O = state.caps
    kf_desc = state.kf_desc[ref_kf]
    kf_mp = state.kf_mp[ref_kf]
    qmask = (kf_mp >= 0) & state.kf_feat_valid[ref_kf] \
        & state.mp_valid[kf_mp.long().clamp(0, P - 1)]
    res = matchers.match_brute(kf_desc, qmask, feats.desc, feats.valid,
                               th=cfg.matcher.th_low,
                               nn_ratio=cfg.matcher.nn_ratio_bow)
    res = matchers.rotation_consistency(state.kf_angle[ref_kf], feats.angle,
                                        res, cfg.matcher.histo_length)
    frame_assign, res = matchers.resolve_conflicts(res, F)
    frame_mp = _none_where(frame_assign >= 0,
                           kf_mp[frame_assign.clamp(0, F - 1)])
    obs = _pose_obs_from_frame(state, feats, frame_mp, cfg)
    q, t, inlier, n = pose_opt.pose_optimize(q_init, t_init, obs, cfg.camera,
                                             cfg.optimizer)
    frame_mp = _none_where(inlier, frame_mp)
    return TrackResult(q, t, frame_mp, n)


@torch.no_grad()
def track_local_map_step(state: ms.MapState, feats: FrameFeatures, q, t,
                         frame_mp, ref_kf: int, cfg: SlamConfig):
    """Local-map tracking (TrackLocalMap + SearchLocalPoints +
    SearchByProjection): gather the points of the reference KF's
    covisibility neighborhood, project into the frame, window-match by
    predicted scale & viewing angle, then pose-only optimize over all
    associations. Returns (TrackResult, new_state)."""
    K, F, P, O = state.caps
    LP = cfg.caps.local_points

    # local KFs: covisibility neighbors of ref_kf + ref_kf itself
    neigh = fill_at(ms.covis_neighbors_mask(state, ref_kf, 1).clone(),
                    ref_kf, True)
    # local points: observed by any local KF
    obs_of_local = _none_where(neigh[:, None].expand_as(state.kf_mp),
                               state.kf_mp)                  # [K, F]
    local_mask = mask_from_ids(obs_of_local, P) & state.mp_valid
    # exclude points already matched in this frame
    already = mask_from_ids(frame_mp, P)
    cand_mask = local_mask & ~already

    ids = first_true_indices(cand_mask, LP, P)
    id_ok = ids < P
    ids_c = ids.clamp(0, P - 1)
    pw = state.mp_pos[ids_c]

    uv, ur, depth, vis = matchers.project_points(cfg.camera, q, t, pw)
    # frustum gates (Frame::isInFrustum): distance band, viewing angle vs
    # normal < 60 deg
    q_wc, t_wc = se3.inverse(q, t)
    view = pw - t_wc
    dist = torch.linalg.norm(view, dim=-1)
    band_ok = (dist >= 0.8 * state.mp_min_dist[ids_c]) \
        & (dist <= 1.2 * state.mp_max_dist[ids_c])
    view_cos = torch.sum(view * state.mp_normal[ids_c], dim=-1) \
        / dist.clamp_min(1e-9)
    cos_ok = view_cos > 0.5
    qmask = id_ok & vis & band_ok & cos_ok

    sf = _scale_factors(cfg, feats.xy.device)
    pred_level = ms.predict_scale(dist, state.mp_max_dist[ids_c],
                                  cfg.orb.scale_factor, cfg.orb.n_levels)
    radius = torch.where(view_cos > 0.998, 2.5, 4.0) * sf[pred_level.long()]

    res = matchers.match_window(feats, state.mp_desc[ids_c], qmask, uv,
                                radius, pred_ur=ur, pred_level=pred_level,
                                th=cfg.matcher.th_high,
                                nn_ratio=cfg.matcher.nn_ratio_tracking)
    frame_assign, res = matchers.resolve_conflicts(res, F)
    # merge: keep existing associations, add new ones where free. The
    # winning query index is clipped to F - 1 exactly as the JAX package
    # clips it (runtime/steps.py:280), so both packages associate alike.
    new_mp = _none_where(frame_assign >= 0,
                         ids[frame_assign.clamp(0, F - 1)].to(torch.int32))
    frame_mp = torch.where(frame_mp >= 0, frame_mp, new_mp)

    obs = _pose_obs_from_frame(state, feats, frame_mp, cfg)
    q2, t2, inlier, n = pose_opt.pose_optimize(q, t, obs, cfg.camera,
                                               cfg.optimizer)
    frame_mp = _none_where(inlier, frame_mp)

    # visibility / found counters (IncreaseVisible/IncreaseFound)
    vis_ids = torch.where(qmask, ids, torch.full_like(ids, P))
    mp_visible = add_drop(state.mp_visible, vis_ids, 1.0)
    found_ids = torch.where(frame_mp >= 0, frame_mp.long(),
                            torch.full_like(frame_mp, P, dtype=torch.int64))
    mp_found = add_drop(state.mp_found, found_ids, 1.0)
    new_state = state._replace(mp_visible=mp_visible, mp_found=mp_found)
    return TrackResult(q2, t2, frame_mp, n), new_state


@torch.no_grad()
def track_frame_step(state: ms.MapState, feats: FrameFeatures,
                     prev_feats: FrameFeatures, prev_frame_mp, ref_kf: int,
                     last_q, last_t, vel_q, vel_t, has_velocity: bool,
                     use_min_obs_gate: bool, cfg: SlamConfig):
    """The tracking cascade: constant-velocity pose prediction -> motion
    model -> wide-window retry -> reference-KF fallback -> local-map
    tracking (Track()), with every small-scalar decision the host needs
    packed into ONE output vector [ok, n_inliers, tracked_close,
    untracked_close, ref_kf_matches].

    The cascade branches on the host: one fetch of the motion model's inlier
    count decides the retries (each retry that runs costs one more fetch),
    and the caller fetches the decision vector once. So a frame that tracks
    on the motion model costs two host reads here. The velocity update
    happens here too; (q_pred, t_pred, new velocity) stay on the device.

    Returns (TrackResult, new_state, decision [5] int32 tensor, aux).
    """
    tcfg = cfg.tracking
    if has_velocity:
        q_pred, t_pred = se3.compose(vel_q, vel_t, last_q, last_t)
    else:
        q_pred, t_pred = last_q, last_t
    tr = track_motion_model_step(state, feats, prev_feats, prev_frame_mp,
                                 q_pred, t_pred, cfg)
    n_in = int(host_fetch(tr.n_inliers))

    if n_in < tcfg.min_matches_motion_model:
        tr = track_motion_model_step(state, feats, prev_feats,
                                     prev_frame_mp, q_pred, t_pred, cfg,
                                     radius_mult=2.0)
        n_in = int(host_fetch(tr.n_inliers))

    if n_in < tcfg.min_matches_ref_kf:
        tr = track_reference_kf_step(state, feats, ref_kf, q_pred, t_pred,
                                     cfg)
        n_in = int(host_fetch(tr.n_inliers))
    ok1 = n_in >= 10

    new_state = state
    out = tr
    ok = torch.zeros((), dtype=torch.bool, device=feats.xy.device)
    if ok1:
        tr2, new_state = track_local_map_step(state, feats, tr.q, tr.t,
                                              tr.frame_mp, ref_kf, cfg)
        ok = tr2.n_inliers >= tcfg.min_inliers_track_local_map
        out = TrackResult(
            q=torch.where(ok, tr2.q, tr.q), t=torch.where(ok, tr2.t, tr.t),
            frame_mp=torch.where(ok, tr2.frame_mp, tr.frame_mp),
            n_inliers=torch.where(ok, tr2.n_inliers, tr.n_inliers))

    # keyframe-decision counters (NeedNewKeyFrame)
    close_th = tcfg.th_depth * cfg.camera.baseline
    tracked = out.frame_mp >= 0
    close = feats.valid & (feats.depth > 0) & (feats.depth < close_th)
    tracked_close = torch.sum(close & tracked)
    untracked_close = torch.sum(close & ~tracked)

    # reference-KF tracked count (min obs 3 once the map has > 2 KFs)
    K, F, P, O = state.caps
    kf_mp = state.kf_mp[ref_kf]
    kvalid = kf_mp >= 0
    if use_min_obs_gate:
        n_obs = state.mp_n_obs()[kf_mp.long().clamp(0, P - 1)]
        ref_matches = torch.sum(kvalid & (n_obs >= 3))
    else:
        ref_matches = torch.sum(kvalid)

    decision = torch.stack([ok.to(torch.int32), out.n_inliers.to(torch.int32),
                            tracked_close.to(torch.int32),
                            untracked_close.to(torch.int32),
                            ref_matches.to(torch.int32)])

    # velocity update (Tcw_cur * Twc_last) for the next frame's prediction
    new_vel_q, new_vel_t = se3.relative(out.q, out.t, last_q, last_t)
    return out, new_state, decision, (q_pred, t_pred, new_vel_q, new_vel_t)


# ---------------------------------------------------------------------------
# Keyframe creation
# ---------------------------------------------------------------------------

@torch.no_grad()
def create_keyframe_step(state: ms.MapState, feats: FrameFeatures, q, t,
                         frame_mp, frame_id, agent, map_id, kf_slot: int,
                         mp_base: int, cfg: SlamConfig):
    """Insert a keyframe + spawn stereo map points for close unmatched
    features (CreateNewKeyFrame: sorted by depth, all closer than ThDepth,
    at least the closest 100)."""
    return _create_keyframe_core(state, feats, q, t, frame_mp, frame_id,
                                 agent, map_id, kf_slot, mp_base, cfg)


def local_ba_step(state: ms.MapState, center_kf: int, cfg: SlamConfig,
                  n_iters1: int = 5, n_iters2: int = 10):
    raise NotImplementedError(_ROADMAP_BA)


def erase_observations(state: ms.MapState, erase_mask):
    """Remove observations flagged in erase_mask [P, O] from both directions
    (MapPoint::EraseObservation + KeyFrame::EraseMapPointMatch)."""
    K, F, P, O = state.caps
    kf = torch.where(erase_mask, state.mp_obs_kf, torch.full_like(
        state.mp_obs_kf, K)).reshape(-1)
    ft = torch.where(erase_mask, state.mp_obs_feat, torch.full_like(
        state.mp_obs_feat, F)).reshape(-1)
    kf_mp = set_drop2(state.kf_mp, kf, ft, NONE)
    return state._replace(
        kf_mp=kf_mp,
        mp_obs_kf=_none_where(~erase_mask, state.mp_obs_kf),
        mp_obs_feat=_none_where(~erase_mask, state.mp_obs_feat),
    )


@torch.no_grad()
def recompute_covisibility(state: ms.MapState):
    """Full covisibility rebuild from the inverse observation lists:
    every pair of KFs observing the same point adds weight 1
    (batch equivalent of calling UpdateConnections on every KF).
    The [P, O, O] pair index is built and accumulated 2048 points at a
    time."""
    K, F, P, O = state.caps
    covis = torch.zeros(K * K + 1, dtype=torch.int32,
                        device=state.mp_obs_kf.device)
    for p0 in range(0, P, 2048):
        obs = state.mp_obs_kf[p0:p0 + 2048].long()          # [p, O]
        a = torch.where(obs >= 0, obs, torch.full_like(obs, K))[:, :, None]
        b = torch.where(obs >= 0, obs, torch.full_like(obs, K))[:, None, :]
        idx = torch.where((a < K) & (b < K) & (a != b), a * K + b,
                          torch.full_like(a * K + b, K * K)).reshape(-1)
        covis.scatter_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))
    return state._replace(covis=covis[:K * K].reshape(K, K))


# ---------------------------------------------------------------------------
# Triangulation of new map points (LocalMapping::CreateNewMapPoints)
# ---------------------------------------------------------------------------

def triangulate_batch(P1, P2, x1, x2):
    """Batched linear triangulation (Initializer::Triangulate):
    P1, P2 [..., 3, 4]; x1, x2 [..., 2] -> [..., 3] points.
    (Own copy of the one function of geometry/twoview.py this slice needs.)
    """
    rows = [
        x1[..., 0:1] * P1[..., 2, :] - P1[..., 0, :],
        x1[..., 1:2] * P1[..., 2, :] - P1[..., 1, :],
        x2[..., 0:1] * P2[..., 2, :] - P2[..., 0, :],
        x2[..., 1:2] * P2[..., 2, :] - P2[..., 1, :],
    ]
    A = torch.stack(rows, dim=-2)
    _, _, vt = torch.linalg.svd(A)
    Xh = vt[..., -1, :]
    w = Xh[..., 3:]
    return Xh[..., :3] / torch.where(torch.abs(w) < 1e-12,
                                     torch.full_like(w, 1e-12), w)


@functools.lru_cache(maxsize=16)
def _k_matrices(cam, device_str):
    """(K, K^-1) as float32 tensors on the device; the inverse is taken on
    the host so the device path has no factorisation with an error check."""
    Kmat = np.asarray(cam.K.numpy(), np.float32)
    Kinv = np.linalg.inv(Kmat).astype(np.float32)
    return (torch.from_numpy(Kmat).to(device_str),
            torch.from_numpy(Kinv).to(device_str))


@torch.no_grad()
def triangulate_pair_step(state: ms.MapState, kf1: int, kf2: int,
                          mp_base, cfg: SlamConfig):
    """Triangulate new points between two keyframes
    (CreateNewMapPoints + SearchForTriangulation): epipolar-constrained
    matching of features that have no map point yet, batched DLT
    triangulation, parallax / depth / reprojection / scale gates, then
    registration in both keyframes.

    Returns (state, n_new). Slots allocated from mp_base.
    """
    state, n_new = _triangulate_pair_core(state, kf1, kf2, mp_base, cfg)
    state = ms.update_covisibility(state, kf1)
    state = ms.update_covisibility(state, kf2)
    return state, n_new


def _triangulate_pair_core(state: ms.MapState, kf1: int, kf2: int, mp_base,
                           cfg: SlamConfig):
    """Triangulation body without the covisibility refresh (the keyframe
    pipeline recomputes covisibility once after all neighbor pairs).
    mp_base is a host int or a 0-d tensor (a cursor that stays on the
    device)."""
    K, F, P, O = state.caps
    cam = cfg.camera
    dev = state.kf_q.device

    q1, t1 = state.kf_q[kf1], state.kf_t[kf1]
    q2, t2 = state.kf_q[kf2], state.kf_t[kf2]

    # fundamental matrix F12: x2^T F12 x1 = 0 -> lines in image 2
    q12, t12 = se3.relative(q2, t2, q1, t1)      # T_2<-1
    R12 = se3.quat_to_matrix(q12)
    E12 = se3.hat(t12) @ R12
    Kmat, Kinv = _k_matrices(cam, str(dev))
    F12 = Kinv.T @ E12 @ Kinv

    free1 = state.kf_feat_valid[kf1] & (state.kf_mp[kf1] < 0)
    free2 = state.kf_feat_valid[kf2] & (state.kf_mp[kf2] < 0)

    res = matchers.search_epipolar(
        state.kf_desc[kf1], state.kf_xy[kf1], state.kf_level[kf1], free1,
        state.kf_desc[kf2], state.kf_xy[kf2], state.kf_level[kf2], free2,
        F12, cfg.orb.scale_factors, th=cfg.matcher.th_low)
    frame_assign, res = matchers.resolve_conflicts(res, F)
    ok = res.ok
    f2 = res.best_feat.clamp(0, F - 1)

    # triangulate in world frame with projective camera matrices
    T1 = torch.cat([se3.quat_to_matrix(q1), t1[:, None]], -1)
    T2 = torch.cat([se3.quat_to_matrix(q2), t2[:, None]], -1)
    P1 = Kmat @ T1
    P2 = Kmat @ T2
    x1 = state.kf_xy[kf1]
    x2 = state.kf_xy[kf2][f2]
    pw_dlt = triangulate_batch(P1, P2, x1, x2)           # [F, 3]

    # stereo-aware source selection: when the bearing rays' parallax is
    # weaker than the stereo rig's own parallax at the observed depth,
    # unproject that keyframe's stereo depth instead of the DLT point.
    # Parallax comes from the PRE-triangulation bearing rays, so a
    # degenerate DLT solution can't feed a bogus parallax into the gate; and
    # the second keyframe's stereo parallax is only used when keyframe 1 has
    # no stereo depth.
    q1i, c1 = se3.inverse(q1, t1)
    q2i, c2 = se3.inverse(q2, t2)
    one = torch.ones((F, 1), device=dev)
    ray1 = se3.quat_rotate(q1i, (Kinv @ torch.cat([x1, one], -1).T).T)
    ray2 = se3.quat_rotate(q2i, (Kinv @ torch.cat([x2, one], -1).T).T)
    cosp = torch.sum(ray1 * ray2, -1) / (
        torch.linalg.norm(ray1, dim=-1) * torch.linalg.norm(ray2, dim=-1)
    ).clamp_min(1e-9)

    depth1 = state.kf_depth[kf1]                         # [F]
    depth2 = state.kf_depth[kf2][f2]
    has_st1 = depth1 > 0
    has_st2 = depth2 > 0
    b = cam.baseline
    half_b = torch.full_like(depth1, b / 2.0)
    no_st = cosp + 1.0   # reference init: cosParallaxRays + 1
    cos_st1 = torch.where(
        has_st1, torch.cos(2.0 * torch.atan2(half_b, depth1.clamp_min(1e-6))),
        no_st)
    cos_st2 = torch.where(
        ~has_st1 & has_st2,
        torch.cos(2.0 * torch.atan2(half_b, depth2.clamp_min(1e-6))), no_st)
    cos_st = torch.minimum(cos_st1, cos_st2)
    use_dlt = (cosp < cos_st) & (cosp > 0) \
        & (has_st1 | has_st2 | (cosp < 0.9998))

    pw_st1 = se3.apply(q1i, c1, camera.backproject(cam, x1, depth1))
    pw_st2 = se3.apply(q2i, c2, camera.backproject(cam, x2, depth2))
    use_st1 = ~use_dlt & has_st1 & (cos_st1 < cos_st2)
    use_st2 = ~use_dlt & ~use_st1 & has_st2 & (cos_st2 < cos_st1)
    pw = torch.where(use_st1[:, None], pw_st1,
                     torch.where(use_st2[:, None], pw_st2, pw_dlt))
    source_ok = use_dlt | use_st1 | use_st2

    # gates
    pc1 = se3.apply(q1, t1, pw)
    pc2 = se3.apply(q2, t2, pw)
    z_ok = (pc1[:, 2] > 0.05) & (pc2[:, 2] > 0.05)

    sf = _scale_factors(cfg, dev)

    def reproj_err2(pc, x, ur_obs, level):
        """chi2-normalized reprojection error; stereo rows (ur_obs >= 0)
        include the right-image residual."""
        z = pc[:, 2].clamp_min(1e-6)
        u = cam.fx * pc[:, 0] / z + cam.cx
        v = cam.fy * pc[:, 1] / z + cam.cy
        e2 = (u - x[:, 0]) ** 2 + (v - x[:, 1]) ** 2
        is_st = ur_obs >= 0
        ur = u - cam.bf / z
        e2 = e2 + torch.where(is_st, (ur - ur_obs) ** 2,
                              torch.zeros_like(e2))
        sigma2 = sf[level.long()] ** 2
        th = torch.where(is_st, 7.8, 5.991)
        return e2 / sigma2, th

    lvl1 = state.kf_level[kf1]
    lvl2 = state.kf_level[kf2][f2]
    e1, th1 = reproj_err2(pc1, x1, state.kf_right[kf1], lvl1)
    e2, th2 = reproj_err2(pc2, x2, state.kf_right[kf2][f2], lvl2)
    reproj_ok = (e1 < th1) & (e2 < th2)

    # scale consistency (ratioDist vs ratioOctave)
    d1 = torch.linalg.norm(pw - c1, dim=-1)
    d2 = torch.linalg.norm(pw - c2, dim=-1)
    ratio_d = d2 / d1.clamp_min(1e-9)
    ratio_o = sf[lvl1.long()] / sf[lvl2.long()]
    scale_ok = (ratio_d < ratio_o * 1.5 * cfg.orb.scale_factor) \
        & (ratio_d * 1.5 * cfg.orb.scale_factor > ratio_o)

    new = ok & source_ok & z_ok & reproj_ok & scale_ok
    slots = mp_base + torch.cumsum(new.to(torch.int32), 0,
                                   dtype=torch.int32) - 1
    slots = _none_where(new & (slots < P), slots.to(torch.int32))
    okslot = slots >= 0

    # point attributes from the kf1 observation
    v = pw - c1
    dist = torch.linalg.norm(v, dim=-1).clamp_min(1e-9)
    normal = v / dist[:, None]
    max_d = dist * sf[lvl1.long()]
    min_d = max_d / sf[-1]
    state = ms.add_points(state, slots, pw, state.kf_desc[kf1], normal,
                          min_d, max_d, ref_kf=kf1,
                          agent=state.kf_agent[kf1], map_id=state.kf_map[kf1],
                          valid=okslot)
    feat_idx = torch.arange(F, dtype=torch.int32, device=dev)
    state = ms.add_observations(state, kf1, feat_idx, slots, okslot)
    state = ms.add_observations(state, kf2, f2, slots, okslot)
    return state, torch.sum(okslot.to(torch.int32))


# ---------------------------------------------------------------------------
# Keyframe pipeline (KF insert + triangulation + local mapping)
# ---------------------------------------------------------------------------

@torch.no_grad()
def keyframe_pipeline_step(state: ms.MapState, feats: FrameFeatures, q, t,
                           frame_mp, frame_id, agent, map_id, kf_slot: int,
                           mp_base: int, cfg: SlamConfig, run_local_ba: bool):
    """Everything that happens when a keyframe is spawned:

      CreateNewKeyFrame -> CreateNewMapPoints over the top covisible
      neighbors -> MapPointCulling -> SearchInNeighbors (Fuse both
      directions) -> [LocalBundleAdjustment -> KeyFrameCulling, not ported].

    The host reads the device once inside (the neighbour list, so that only
    neighbours that exist are visited) and the caller once (the new-point
    count).

    Returns (state, frame_mp [F], q_kf, t_kf, n_new_points,
             cull_vec [3, 9] float32, all -1: nothing is culled without BA).
    """
    if run_local_ba:
        raise NotImplementedError(_ROADMAP_BA)
    K, F, P, O = state.caps
    dev = state.kf_q.device
    mono = cfg.sensor == 0

    # 1. keyframe insertion + close stereo point creation
    state, frame_mp2, n_created = _create_keyframe_core(
        state, feats, q, t, frame_mp, frame_id, agent, map_id, kf_slot,
        mp_base, cfg)
    cursor = mp_base + n_created

    # 2. triangulation neighbors: top covisible, baseline-gated for stereo
    nn = (2 * cfg.mapping.triangulation_neighbors if mono
          else cfg.mapping.triangulation_neighbors)
    row = fill_at(state.covis[kf_slot].clone(), kf_slot, 0)
    top_w, top_i = top_k_stable(row, min(nn, K))
    pair_ok = top_w > 0
    if not mono:
        _, c1 = se3.inverse(q, t)
        qn, tn = state.kf_q[top_i], state.kf_t[top_i]
        _, cn = se3.inverse(qn, tn)
        pair_ok = pair_ok & (torch.linalg.norm(cn - c1[None, :], dim=-1)
                             >= cfg.camera.baseline)
    fuse_ok = top_w > 0
    nb = host_fetch(torch.stack([top_i, pair_ok.long(), fuse_ok.long()]))
    neighbors = [int(k) for k in nb[0]]

    for nkf, okp in zip(neighbors, nb[1]):
        if okp:
            state, n_tri = _triangulate_pair_core(state, kf_slot, nkf,
                                                  cursor, cfg)
            cursor = cursor + n_tri

    # 3. local-mapping hygiene
    state = mapping.cull_points_step(state, kf_slot, cfg)

    for nkf, okp in zip(neighbors, nb[2]):
        if okp:
            own = state.kf_mp[kf_slot]
            own_ids = torch.where(own >= 0, own.long(),
                                  torch.full_like(own, P, dtype=torch.int64))
            state = mapping.fuse_into_kf(state, own_ids, nkf, cfg)

    # direction 2: neighbors' points into the new KF
    fused = [k for k, okp in zip(neighbors, nb[2]) if okp]
    if fused:
        cand = torch.stack([state.kf_mp[k] for k in fused])      # [NB, F]
        cand_mask = mask_from_ids(cand, P) & state.mp_valid
    else:
        cand_mask = torch.zeros(P, dtype=torch.bool, device=dev)
    ids = first_true_indices(cand_mask, cfg.caps.local_points, P)
    state = mapping.fuse_into_kf(state, ids, kf_slot, cfg)

    state = mapping.rebuild_observations(state)
    state = recompute_covisibility(state)
    touched = mask_from_ids(state.kf_mp[kf_slot], P)
    state = ms.update_point_descriptors(state, touched)
    state = ms.update_point_normals(state, touched, cfg.orb.scale_factor,
                                    cfg.orb.n_levels)

    cull_vec = torch.full((3, 9), -1.0, dtype=torch.float32, device=dev)
    frame_mp_row = state.kf_mp[kf_slot]
    n_new = (cursor - mp_base).to(torch.int32)
    return (state, frame_mp_row, state.kf_q[kf_slot], state.kf_t[kf_slot],
            n_new, cull_vec)


def _create_keyframe_core(state, feats, q, t, frame_mp, frame_id, agent,
                          map_id, kf_slot: int, mp_base, cfg):
    """Body of create_keyframe_step (also the pipeline's first stage)."""
    K, F, P, O = state.caps
    dev = feats.xy.device
    close = feats.valid & (feats.depth > 0) & (frame_mp < 0)
    depth_ok = feats.depth < cfg.tracking.th_depth * cfg.camera.baseline
    order = torch.sort(torch.where(close, feats.depth,
                                   torch.full_like(feats.depth, torch.inf)),
                       stable=True).indices
    rank = torch.zeros(F, dtype=torch.int64, device=dev)
    rank[order] = torch.arange(F, device=dev)
    new = close & (depth_ok | (rank < 100))

    slots = mp_base + torch.cumsum(new.to(torch.int32), 0,
                                   dtype=torch.int32) - 1
    slots = _none_where(new & (slots < P), slots)
    ok = slots >= 0

    pw = camera.unproject_world(cfg.camera, q, t, feats.xy, feats.depth)
    q_wc, t_wc = se3.inverse(q, t)
    v = pw - t_wc
    dist = torch.linalg.norm(v, dim=-1).clamp_min(1e-9)
    normal = v / dist[:, None]
    sf = _scale_factors(cfg, dev)
    max_d = dist * sf[feats.level.long()]
    min_d = max_d / sf[-1]

    state = ms.add_points(state, slots, pw, feats.desc, normal, min_d, max_d,
                          ref_kf=kf_slot, agent=agent, map_id=map_id, valid=ok)
    frame_mp2 = torch.where(ok, slots, frame_mp)

    state = ms.insert_keyframe(state, kf_slot, feats, q, t, frame_id, agent,
                               map_id, frame_mp2, parent=NONE)
    row = fill_at(state.covis[kf_slot].clone(), kf_slot, 0)
    parent = torch.argmax(row)
    has_parent = torch.amax(row) > 0
    kf_parent = state.kf_parent.clone()
    kf_parent[kf_slot] = _none_where(has_parent, parent).to(torch.int32)
    state = state._replace(kf_parent=kf_parent)

    touched = mask_from_ids(frame_mp2, P)
    state = ms.update_point_descriptors(state, touched)
    state = ms.update_point_normals(state, touched, cfg.orb.scale_factor,
                                    cfg.orb.n_levels)
    return state, frame_mp2, torch.sum(ok.to(torch.int32))
