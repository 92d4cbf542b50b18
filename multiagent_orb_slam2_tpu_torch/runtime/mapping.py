"""Local-mapping hygiene: point culling, duplicate fusion, observation rebuild.

Counterpart of the JAX package's ``runtime/mapping.py`` (MapPointCulling,
SearchInNeighbors with ORBmatcher::Fuse, MapPoint::Replace).

- point merges are expressed as a rewrite table map_to[P]; the forward map
  kf_mp is rewired by one gather, and the inverse observation lists are then
  rebuilt from scratch (`rebuild_observations`);
- merge chains (a->b->c in one pass) resolve over successive keyframes.

Keyframe culling (kf_redundancy, erase_keyframe_step, keyframe_culling),
fuse_into_neighborhood and local_mapping_pass are not ported yet: they are
reached only with local BA, loop closing or the server (ROADMAP.md queue 1).
"""
from __future__ import annotations

import torch

from ..config import SlamConfig
from ..geometry import se3
from ..mapstate import state as ms
from ..ops import matchers
from ..ops.frame import FrameFeatures
from ..utils.torch_ops import const_tensor, set_drop, set_drop2

NONE = ms.NONE


def _none_where(ok, val):
    return torch.where(ok, val, torch.full_like(val, NONE))


@torch.no_grad()
def rebuild_observations(state: ms.MapState):
    """Reconstruct mp_obs_kf/mp_obs_feat from the forward map kf_mp.

    The forward map is the source of truth after fusion/culling edits.
    """
    K, F, P, O = state.caps
    dev = state.kf_mp.device
    flat_mp = state.kf_mp.reshape(-1).long()              # [K*F]
    kf_ids = torch.arange(K, dtype=torch.int32,
                          device=dev).repeat_interleave(F)
    ft_ids = torch.arange(F, dtype=torch.int32, device=dev).repeat(K)
    ok = (flat_mp >= 0) & state.kf_valid[kf_ids.long()] \
        & state.kf_feat_valid.reshape(-1)
    key = torch.where(ok, flat_mp, torch.full_like(flat_mp, P))
    s_mp, order = torch.sort(key, stable=True)
    pos = torch.arange(K * F, device=dev)
    is_new = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                        s_mp[1:] != s_mp[:-1]])
    seg_start = torch.cummax(torch.where(is_new, pos, torch.zeros_like(pos)),
                             dim=0).values
    rank = pos - seg_start
    keep = (s_mp < P) & (rank < O)
    row = torch.where(keep, s_mp, torch.full_like(s_mp, P))
    col = torch.where(keep, rank, torch.zeros_like(rank))
    empty = torch.full((P, O), NONE, dtype=torch.int32, device=dev)
    obs_kf = set_drop2(empty, row, col, kf_ids[order])
    obs_ft = set_drop2(empty, row, col, ft_ids[order])
    return state._replace(mp_obs_kf=obs_kf, mp_obs_feat=obs_ft)


def _apply_point_rewrite(state: ms.MapState, map_to):
    """Rewire kf_mp through map_to [P] (identity for untouched points) and
    invalidate merged-away points."""
    K, F, P, O = state.caps
    lut = torch.cat([map_to, map_to.new_full((1,), NONE)])
    kf_mp = _none_where(state.kf_mp >= 0,
                        lut[state.kf_mp.long().clamp(0, P)])
    merged_away = map_to != torch.arange(P, dtype=map_to.dtype,
                                         device=map_to.device)
    return state._replace(
        kf_mp=kf_mp,
        mp_valid=state.mp_valid & ~merged_away)


@torch.no_grad()
def fuse_into_kf(state: ms.MapState, point_ids, target_kf: int,
                 cfg: SlamConfig):
    """Project candidate points into target_kf and fuse duplicates
    (ORBmatcher::Fuse): window-match each projected point against the
    keyframe's features; a hit on a feature that already observes another
    point merges the two (the point with more observations wins,
    MapPoint::Replace); a hit on a free feature adds an association.

    Returns the updated state. point_ids: [Q] integer (P = padding).
    """
    K, F, P, O = state.caps
    dev = state.kf_mp.device
    point_ids = point_ids.long()
    ids_c = point_ids.clamp(0, P - 1)
    q_mask = (point_ids < P) & state.mp_valid[ids_c]
    pw = state.mp_pos[ids_c]
    q_kf = state.kf_q[target_kf]
    t_kf = state.kf_t[target_kf]

    uv, ur, depth, vis = matchers.project_points(cfg.camera, q_kf, t_kf, pw)
    q_wc, t_wc = se3.inverse(q_kf, t_kf)
    view = pw - t_wc
    dist = torch.linalg.norm(view, dim=-1)
    band_ok = (dist >= 0.8 * state.mp_min_dist[ids_c]) \
        & (dist <= 1.2 * state.mp_max_dist[ids_c])
    view_cos = torch.sum(view * state.mp_normal[ids_c], -1) \
        / dist.clamp_min(1e-9)
    q_mask = q_mask & vis & band_ok & (view_cos > 0.5)

    sf = const_tensor(cfg.orb.scale_factors, torch.float32, dev)
    pred_level = ms.predict_scale(dist, state.mp_max_dist[ids_c],
                                  cfg.orb.scale_factor, cfg.orb.n_levels)
    radius = 3.0 * sf[pred_level.long()]

    # target KF features as a pseudo-frame
    feats = FrameFeatures(
        xy=state.kf_xy[target_kf], response=None,
        level=state.kf_level[target_kf], angle=state.kf_angle[target_kf],
        desc=state.kf_desc[target_kf], valid=state.kf_feat_valid[target_kf],
        u_right=state.kf_right[target_kf], depth=state.kf_depth[target_kf])

    res = matchers.match_window(feats, state.mp_desc[ids_c], q_mask, uv,
                                radius, pred_ur=ur, pred_level=pred_level,
                                th=cfg.matcher.th_low)
    frame_assign, res = matchers.resolve_conflicts(res, F)
    # frame_assign: [F] -> index into point_ids (query), -1 none
    hit = frame_assign >= 0
    Q = point_ids.shape[0]
    pt = _none_where(hit, point_ids[frame_assign.clamp(0, min(P, Q) - 1)])
    pt = _none_where(hit & (pt < P), pt)

    existing = state.kf_mp[target_kf].long()              # [F]
    n_obs = state.mp_n_obs()

    # case A: free feature -> new association
    add = (pt >= 0) & (existing < 0)
    kf_mp_row = torch.where(add, pt, existing)

    # case B: occupied feature with a different point -> merge
    merge = (pt >= 0) & (existing >= 0) & (existing != pt)
    a = pt.clamp(0, P - 1)
    b = existing.clamp(0, P - 1)
    a_wins = n_obs[a] >= n_obs[b]
    winner = torch.where(a_wins, a, b)
    loser = torch.where(a_wins, b, a)
    kf_mp_row = torch.where(merge, winner, kf_mp_row)

    map_to = torch.arange(P, dtype=torch.int32, device=dev)
    map_to = set_drop(map_to, torch.where(merge, loser,
                                          torch.full_like(loser, P)),
                      torch.where(merge, winner, torch.zeros_like(winner)))

    kf_mp = state.kf_mp.clone()
    kf_mp[target_kf] = kf_mp_row.to(torch.int32)
    state = state._replace(kf_mp=kf_mp)
    return _apply_point_rewrite(state, map_to)


@torch.no_grad()
def cull_points_step(state: ms.MapState, newest_kf_slot: int,
                     cfg: SlamConfig):
    """MapPointCulling: drop points whose found/visible ratio is below 0.25,
    and recent points (created within the last 2 keyframes) that failed to
    accumulate observations.

    Age is measured in creation-sequence numbers (kf_seq), NOT slot indices:
    slots are recycled after culling, so slot distance is meaningless.
    """
    K, F, P, O = state.caps
    ratio = state.mp_found / state.mp_visible.clamp_min(1.0)
    seq_new = state.kf_seq[newest_kf_slot]
    seq_first = state.kf_seq[state.mp_first_kf.long().clamp(0, K - 1)]
    age = seq_new - seq_first                          # in KF creations
    n_obs = state.mp_n_obs()
    bad = state.mp_valid & (
        (ratio < cfg.mapping.mp_cull_found_ratio)
        | ((age >= 2) & (age <= 3) & (n_obs <= cfg.mapping.mp_cull_min_obs)))
    # rewire: culled points simply disappear from the forward map
    lut_bad = torch.cat([bad, bad.new_zeros(1)])
    kf_mp = _none_where(
        ~(lut_bad[state.kf_mp.long().clamp(0, P)] & (state.kf_mp >= 0)),
        state.kf_mp)
    return state._replace(kf_mp=kf_mp, mp_valid=state.mp_valid & ~bad)


def _not_ported(name):
    def stub(*args, **kwargs):
        raise NotImplementedError(
            f"runtime.mapping.{name} is not ported yet: ROADMAP.md queue 1, "
            "next slice (local BA + keyframe culling) and loop closing")
    stub.__name__ = name
    return stub


fuse_into_neighborhood = _not_ported("fuse_into_neighborhood")
kf_redundancy = _not_ported("kf_redundancy")
erase_keyframe_step = _not_ported("erase_keyframe_step")
keyframe_culling = _not_ported("keyframe_culling")
local_mapping_pass = _not_ported("local_mapping_pass")
