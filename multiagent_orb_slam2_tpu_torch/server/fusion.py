"""Map fusion: Sim3-merge two logical maps inside the shared MapState.

Counterpart of the JAX package's ``server/fusion.py`` (reference
MapFusion::FuseMaps, CovisibilityDiscovery and the post-fusion global BA).
With all maps in one state, the reference's ownership move is a relabel of
kf_map / mp_map; the Sim3 pose and point correction is one batched
transform over the masked current map; the spanning-tree reversal is a
parent-pointer rewrite along the query's chain, on the host.

Host waits: ``merge_maps`` reads the parents once (the tree rewrite) and the
neighbour list of the seam once (``mapping.fuse_into_neighborhood``);
``covisibility_discovery`` reads the candidate masks of all moved keyframes
once, then fuses every (moved, candidate) pair without a wait.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..config import SlamConfig
from ..geometry import se3, sim3
from ..mapstate import state as ms
from ..runtime import mapping, steps
from ..runtime.loop_closing import Sim3Match
from ..utils.torch_ops import host_fetch
from ..vocab import bow as bow_mod
from ..vocab import kfdb as kfdb_mod

NONE = ms.NONE


def _sync(device: torch.device):
    """End a timed stage: its time is the card's work, not the queueing."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def correct_map(st: ms.MapState, map_mask_kf, map_mask_mp, kf_q: int,
                s, q, t):
    """Sim3-correct a whole logical map given the corrected Sim3 (world ->
    query camera) of one of its keyframes.

    Every keyframe i of the map: T_iw_new = (T_iq_old as a Sim3) * S_qw,
    the translation divided by the scale to recover an SE3 pose. Every point
    is re-anchored through the query camera: p_new = S_qw^-1 (T_qw_old p).
    """
    K = st.kf_q.shape[0]
    P = st.mp_pos.shape[0]
    q_old, t_old = st.kf_q[kf_q], st.kf_t[kf_q]
    qi_rel, ti_rel = se3.relative(st.kf_q, st.kf_t, q_old, t_old)
    s_i, q_i, t_i = sim3.compose(torch.ones(K, device=s.device), qi_rel,
                                 ti_rel, s.expand(K), q.expand(K, 4),
                                 t.expand(K, 3))
    q_new, t_new = sim3.to_se3(s_i, q_i, t_i)
    q_new = se3.quat_normalize(q_new)

    pc = se3.apply(q_old, t_old, st.mp_pos)
    si, qi, ti = sim3.inverse(s, q, t)
    p_new = sim3.apply(si.expand(P), qi.expand(P, 4), ti.expand(P, 3), pc)
    return st._replace(
        kf_q=torch.where(map_mask_kf[:, None], q_new, st.kf_q),
        kf_t=torch.where(map_mask_kf[:, None], t_new, st.kf_t),
        mp_pos=torch.where(map_mask_mp[:, None], p_new, st.mp_pos))


@torch.no_grad()
def reverse_spanning_tree(st: ms.MapState, kf_q: int, kf_m: int):
    """Reverse the parent chain from the query keyframe up to its map's
    origin and attach the query to the matched keyframe. One fetch of the
    parents, one upload."""
    parent = host_fetch(st.kf_parent).copy()
    chain = []
    k = kf_q
    seen = set()
    while k >= 0 and k not in seen:
        seen.add(k)
        chain.append(k)
        k = int(parent[k])
    # each node's new parent is its old child on the chain
    for child, par in zip(chain[:-1], chain[1:]):
        parent[par] = child
    parent[kf_q] = kf_m
    return st._replace(kf_parent=torch.from_numpy(parent).to(
        st.kf_parent.device))


@torch.no_grad()
def merge_maps(shared, multimap, match: Sim3Match, cur_map: int,
               dst_map: int, cfg: SlamConfig):
    """FuseMaps: correct and relabel the current map into the matched map,
    fuse the matched points around the seam, rewire the spanning tree and
    update the registry. The masks cover every slot labelled cur_map, live
    or culled, as in the JAX package (a culled slot keeps its label)."""
    st = shared.state
    dev = st.kf_q.device
    kf_q, kf_m = match.kf_query, match.kf_match
    cur_kf = st.kf_map == cur_map
    cur_mp = st.mp_map == cur_map

    # corrected Sim3 of the query: S_qw = S_qm * T_mw (the match keyframe's
    # world pose)
    sqt = torch.from_numpy(np.concatenate(
        [[match.s], match.q, match.t]).astype(np.float32)).to(dev)
    s_c, q_c, t_c = sim3.compose(
        sqt[0], sqt[1:5], sqt[5:8],
        *sim3.from_se3(st.kf_q[kf_m], st.kf_t[kf_m]))
    st = correct_map(st, cur_kf, cur_mp, kf_q, s_c, q_c, t_c)
    # relabel ownership (the reference's keyframe / point move); the
    # absorbed map's origin stops being a gauge anchor of BA
    st = st._replace(
        kf_map=torch.where(cur_kf, dst_map, st.kf_map),
        mp_map=torch.where(cur_mp, dst_map, st.mp_map),
        kf_fixed_origin=st.kf_fixed_origin & ~cur_kf)
    st = reverse_spanning_tree(st, kf_q, kf_m)

    # fuse duplicate points around the seam (SearchAndFuse)
    st = mapping.fuse_into_neighborhood(st, match.point_ids, kf_q, cfg)
    st = mapping.rebuild_observations(st)
    shared.state = steps.recompute_covisibility(st)
    multimap.merge(cur_map, dst_map)


@torch.no_grad()
def cd_candidates(db: kfdb_mod.KFDatabase, vocab: bow_mod.Vocabulary,
                  st: ms.MapState, slots, moved_mask):
    """Candidate masks [Nm, K] of every moved keyframe, queued without a
    host read (the JAX package vmaps the same per-keyframe query): the BoW
    transform of the keyframe's descriptors, its vector, and
    DetectCovisibilityCandidates with the moved set ignored."""
    rows = []
    for k in slots:
        valid = st.kf_feat_valid[k]
        words = bow_mod.transform_words(vocab, st.kf_desc[k], valid)
        vec = bow_mod.bow_vector(vocab, words, valid)
        cand, _ = kfdb_mod.detect_covisibility_candidates(
            db, words, valid, vec, moved_mask, st.covis)
        rows.append(cand)
    return torch.stack(rows)


@torch.no_grad()
def cd_fuse_pairs(st: ms.MapState, pairs, cfg: SlamConfig):
    """Fuse candidate -> moved keyframe and moved keyframe -> candidate for
    every (moved, candidate) pair in order (ORBmatcher::Fuse per candidate
    pair, both directions). No host read."""
    P = st.mp_pos.shape[0]
    for k, c in pairs:
        ids = st.kf_mp[c]
        st = mapping.fuse_into_kf(
            st, torch.where(ids >= 0, ids, torch.full_like(ids, P)), k, cfg)
        ids = st.kf_mp[k]
        st = mapping.fuse_into_kf(
            st, torch.where(ids >= 0, ids, torch.full_like(ids, P)), c, cfg)
    return st


@torch.no_grad()
def covisibility_discovery(shared, server_db, vocab, moved_kf_slots,
                           cfg: SlamConfig):
    """Cross-agent duplicate-point discovery over the moved keyframes
    (MapFusion::CovisibilityDiscovery): for each moved keyframe, find the
    BoW-similar keyframes outside the moved set and fuse each one's points
    into it, both directions. Every moved keyframe and every candidate, no
    cap. The caller passes live keyframes only.

    Returns (n_processed, per_kf_ms): the number of fused pairs and the
    per-keyframe times of the stats columns (the fuse loop has no host
    wait, so its time is split evenly, as in the JAX package)."""
    if not moved_kf_slots:
        return 0, []
    st = shared.state
    K = st.kf_q.shape[0]
    slots = np.asarray(moved_kf_slots, np.int64)
    moved = torch.zeros(K, dtype=torch.bool, device=st.kf_q.device)
    moved.index_fill_(0, torch.from_numpy(slots).to(moved.device), True)
    cand = host_fetch(cd_candidates(server_db, vocab, st, slots.tolist(),
                                    moved))
    kk, cc = np.nonzero(cand)
    n_processed = len(kk)
    if n_processed == 0:
        return 0, []
    t0 = time.perf_counter()
    st = cd_fuse_pairs(st, zip(slots[kk].tolist(), cc.tolist()), cfg)
    st = mapping.rebuild_observations(st)
    shared.state = steps.recompute_covisibility(st)
    _sync(st.kf_q.device)
    total_ms = (time.perf_counter() - t0) * 1e3
    return n_processed, [total_ms / len(slots)] * len(slots)
