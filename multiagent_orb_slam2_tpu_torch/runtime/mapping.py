"""Local-mapping hygiene: point culling, duplicate fusion, observation rebuild.

Counterpart of the JAX package's ``runtime/mapping.py`` (MapPointCulling,
SearchInNeighbors with ORBmatcher::Fuse, MapPoint::Replace).

- point merges are expressed as a rewrite table map_to[P]; the forward map
  kf_mp is rewired by one gather, and the inverse observation lists are then
  rebuilt from scratch (`rebuild_observations`);
- merge chains (a->b->c in one pass) resolve over successive keyframes.

Keyframe culling (kf_redundancy, erase_keyframe_step, keyframe_culling)
follows the reference's 90 % redundancy rule.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import SlamConfig
from ..geometry import se3
from ..mapstate import state as ms
from ..ops import matchers
from ..ops.frame import FrameFeatures
from ..utils.torch_ops import (const_tensor, fill_at, first_true_indices,
                               host_fetch, mask_from_ids, set_drop, set_drop2,
                               top_k_stable)

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


# keyframe creations one agent may make: SharedMap.kf_agent_seq offsets each
# agent's creation ordinals by agent * AGENT_SEQ_STRIDE, so that two agents'
# keyframes are never a few creations apart
AGENT_SEQ_STRIDE = 1 << 20


@torch.no_grad()
def cull_points_step(state: ms.MapState, newest_kf_slot: int,
                     cfg: SlamConfig, agent_seq: torch.Tensor):
    """MapPointCulling: drop points whose found/visible ratio is below 0.25,
    and recent points (created within the last 2 keyframes) that failed to
    accumulate observations.

    Age is measured in creation-sequence numbers, NOT slot indices: slots
    are recycled after culling, so slot distance is meaningless. The
    sequence is `agent_seq` [K] (SharedMap.kf_agent_seq): each keyframe's
    ordinal among its own agent's keyframe creations plus agent *
    AGENT_SEQ_STRIDE, read where kf_seq marks the slot live. So a point ages
    only with its own agent's keyframes and only that agent's keyframes
    cull it for age. The JAX package reads kf_seq, the creation uid that
    every agent advances, and its age test then culls another agent's young
    map (ROADMAP.md, fault 11). The reference's MapPointCulling runs over
    one agent's recently added points, but ages them in KeyFrame::mnId,
    which every agent advances too; the port departs from it there on
    purpose: its observation count counts keyframes where the reference's
    Observations() counts a stereo observation twice, and with ages in
    every agent's creations an agent's second keyframe of a 2-agent split
    culls its initial map (PERF.md). With one agent the two sequences are
    equal.
    """
    K, F, P, O = state.caps
    ratio = state.mp_found / state.mp_visible.clamp_min(1.0)
    seq = torch.where(state.kf_seq >= 0, agent_seq,
                      torch.full_like(agent_seq, ms.NONE))
    seq_new = seq[newest_kf_slot]
    seq_first = seq[state.mp_first_kf.long().clamp(0, K - 1)]
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


@torch.no_grad()
def fuse_into_neighborhood(state: ms.MapState, point_ids, center_kf: int,
                           cfg: SlamConfig, n_max: int = 15):
    """Fuse a point set into center_kf and its strongest covisible
    neighbors (the SearchAndFuse loops of loop closing and map fusion: the
    reference iterates the corrected neighborhood keyframe by keyframe).
    One host read: the neighbour list."""
    K = state.kf_q.shape[0]
    row = fill_at(state.covis[center_kf].clone(), center_kf, 0)
    top_w, top_i = top_k_stable(row, min(n_max - 1, K))
    targets = torch.cat([torch.full_like(top_i[:1], center_kf), top_i])
    ok = torch.cat([torch.ones_like(top_w[:1], dtype=torch.bool), top_w > 0])
    ok = ok & state.kf_valid[targets]
    fetched = host_fetch(torch.stack([targets, ok.long()]))
    for tgt, o in zip(fetched[0], fetched[1]):
        if o:
            state = fuse_into_kf(state, point_ids, int(tgt), cfg)
    return state


@torch.no_grad()
def local_mapping_pass(state: ms.MapState, kf_slot: int, cfg: SlamConfig,
                       agent_seq: torch.Tensor):
    """The synchronous equivalent of one LocalMapping::Run iteration for a
    freshly inserted keyframe: cull -> fuse with covisibility neighbors
    (both directions) -> rebuild inverse obs -> refresh covis + point
    attributes. Local BA follows separately (steps.local_ba_step).
    `agent_seq` as cull_points_step's.
    """
    from . import steps
    K, F, P, O = state.caps
    state = cull_points_step(state, kf_slot, cfg, agent_seq)

    # top covisibility neighbors (reference: 10 for stereo, 20 mono)
    nb = cfg.mapping.triangulation_neighbors
    top_w, top_i = top_k_stable(state.covis[kf_slot], min(nb, K))
    fetched = host_fetch(torch.stack([top_i, (top_w > 0).long()]))
    neighbors = [int(i) for i, w in zip(fetched[0], fetched[1]) if w]

    # direction 1: new KF's points into each neighbor
    own = state.kf_mp[kf_slot]
    own_ids = torch.where(own >= 0, own.long(),
                          torch.full_like(own, P, dtype=torch.int64))
    for n in neighbors:
        state = fuse_into_kf(state, own_ids, n, cfg)

    # direction 2: neighbors' points into the new KF
    if neighbors:
        cand = torch.stack([state.kf_mp[k] for k in neighbors])   # [NB, F]
        cand_mask = mask_from_ids(cand, P) & state.mp_valid
        ids = first_true_indices(cand_mask, cfg.caps.local_points, P)
        state = fuse_into_kf(state, ids, kf_slot, cfg)

    state = rebuild_observations(state)
    state = steps.recompute_covisibility(state)
    touched = mask_from_ids(own, P)
    state = ms.update_point_descriptors(state, touched)
    state = ms.update_point_normals(state, touched, cfg.orb.scale_factor,
                                    cfg.orb.n_levels)
    return state


# ---------------------------------------------------------------------------
# Keyframe culling (LocalMapping::KeyFrameCulling)
# ---------------------------------------------------------------------------

@torch.no_grad()
def kf_redundancy(state: ms.MapState, kf_slot, cfg: SlamConfig):
    """Fraction of a keyframe's tracked points that are observed by at least
    3 OTHER keyframes at the same or finer pyramid level (the 90% redundancy
    rule). kf_slot is a host int, or a 1-D tensor of slots (one result per
    slot, no host read). Returns (ratio, n_tracked)."""
    K, F, P, O = state.caps
    single = not torch.is_tensor(kf_slot)
    slots = (torch.full((1,), kf_slot, dtype=torch.int64,
                        device=state.kf_mp.device) if single
             else kf_slot.long())
    mp = state.kf_mp[slots]                            # [S, F]
    mp_ok = (mp >= 0) & state.kf_feat_valid[slots]
    mp_c = mp.long().clamp(0, P - 1)
    own_level = state.kf_level[slots]                  # [S, F]

    obs_kf = state.mp_obs_kf[mp_c]                     # [S, F, O]
    obs_ft = state.mp_obs_feat[mp_c].long().clamp(0, F - 1)
    obs_valid = (obs_kf >= 0) & (obs_kf != slots[:, None, None])
    obs_level = state.kf_level[obs_kf.long().clamp(0, K - 1), obs_ft]
    fine = obs_valid & (obs_level <= own_level[..., None] + 1)
    n_fine = torch.sum(fine, dim=-1)
    redundant = mp_ok & (n_fine >= cfg.mapping.kf_cull_min_obs)
    n_tracked = torch.sum(mp_ok, dim=-1)
    ratio = torch.sum(redundant, dim=-1) / n_tracked.clamp_min(1)
    if single:
        return ratio[0], n_tracked[0]
    return ratio, n_tracked


@torch.no_grad()
def erase_keyframe_step(state: ms.MapState, kf_slot):
    """SetBadFlag: drop the keyframe, detach its observations, reattach its
    spanning-tree children to its parent. kf_slot is a host int or a 0-d
    tensor on the device (no host read either way); K, one past the last
    slot, erases nothing."""
    K, F, P, O = state.caps
    dev = state.kf_mp.device
    if not torch.is_tensor(kf_slot):
        kf_slot = torch.full((), kf_slot, dtype=torch.int64, device=dev)
    kf_slot = kf_slot.long()
    hit = torch.arange(K, device=dev) == kf_slot       # all False for K
    # (index_select: indexing with a 0-d device tensor reads it back)
    parent = state.kf_parent.index_select(
        0, kf_slot.clamp(0, K - 1).reshape(1))[0]
    children = state.kf_parent == kf_slot
    kf_parent = torch.where(children, parent, state.kf_parent)
    return state._replace(
        kf_valid=state.kf_valid & ~hit,
        kf_mp=_none_where(~hit[:, None], state.kf_mp),
        kf_feat_valid=state.kf_feat_valid & ~hit[:, None],
        kf_parent=_none_where(~hit, kf_parent),
        kf_seq=_none_where(~hit, state.kf_seq),
        covis=torch.where(hit[:, None] | hit[None, :],
                          torch.zeros_like(state.covis), state.covis),
    )


@torch.no_grad()
def keyframe_culling(state: ms.MapState, center_kf: int, cfg: SlamConfig,
                     max_cull: int = 3):
    """Cull redundant covisibility neighbors of a fresh keyframe, one at a
    time on the host (the keyframe pipeline uses steps._kf_culling_core,
    which reads nothing back). Origin keyframes are exempt. Returns (state,
    culled_slot_list, cull_info) where cull_info maps slot -> (parent_slot,
    rel_q, rel_t), the pose relative to the spanning-tree parent at cull
    time, needed to re-chain exported trajectories through erased reference
    keyframes."""
    from . import steps
    row = host_fetch(state.covis[center_kf])
    fixed = host_fetch(state.kf_fixed_origin)
    valid = host_fetch(state.kf_valid)
    culled = []
    cull_info = {}
    for k in np.argsort(-row):
        if len(culled) >= max_cull or row[k] <= 0:
            break
        if fixed[k] or not valid[k] or k == center_kf:
            continue
        ratio, n_tracked = host_fetch(torch.stack(
            [a.to(torch.float32) for a in kf_redundancy(state, int(k), cfg)]))
        if ratio > cfg.mapping.kf_cull_redundancy and n_tracked > 20:
            parent = int(host_fetch(state.kf_parent[k]))
            if parent >= 0:
                rel_q, rel_t = se3.relative(
                    state.kf_q[k], state.kf_t[k],
                    state.kf_q[parent], state.kf_t[parent])
                cull_info[int(k)] = (parent, host_fetch(rel_q),
                                     host_fetch(rel_t))
            state = erase_keyframe_step(state, int(k))
            culled.append(int(k))
    if culled:
        state = rebuild_observations(state)
        state = steps.recompute_covisibility(state)
    return state, culled, cull_info
