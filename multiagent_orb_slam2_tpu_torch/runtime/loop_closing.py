"""Loop closing: detection, Sim3 estimation, loop correction, global BA.

Counterpart of the JAX package's ``runtime/loop_closing.py`` (the
reference's LoopClosing thread): DetectLoop (BoW candidates + covisibility
consistency groups >= 3), ComputeSim3 (descriptor matches >= 20 -> Sim3
RANSAC -> OptimizeSim3 >= 20 inliers -> projection matches >= 40),
CorrectLoop (Sim3 propagation over the covisibility neighbourhood, point
correction, duplicate fusion, essential-graph optimization) and the global
bundle adjustment that follows it.

Host / device split, as in the JAX package: the candidate bookkeeping
(consistency groups), the pair lists of ComputeSim3 and the edge list of the
essential graph are host logic; matching, RANSAC, Sim3 refinement, the pose
graph and global BA are tensor programs over MapState. Every read of the
device goes through ``utils.torch_ops.host_fetch``, so it is counted: one
[K] candidate mask per detection, the covisibility matrix when there are
candidates, and a few per Sim3 attempt and per correction.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import SlamConfig, Sensor
from ..geometry import horn, se3, sim3
from ..mapstate import state as ms
from ..ops import matchers
from ..ops.frame import FrameFeatures
from ..optim import ba as ba_mod
from ..optim import pose_graph as pg
from ..optim import sim3_opt
from ..utils import diag
from ..utils.torch_ops import (fill_at, first_true_indices, host_fetch,
                               mask_from_ids)
from ..vocab import bow as bow_mod
from ..vocab import kfdb as kfdb_mod
from . import mapping, steps

NONE = ms.NONE


@dataclasses.dataclass
class LoopCandidateState:
    """Host-side covisibility-consistency bookkeeping (the reference's
    mvConsistentGroups)."""
    groups: list          # list of (set_of_kf_slots, consistency_count)


@dataclasses.dataclass
class Sim3Match:
    kf_query: int
    kf_match: int
    s: float              # S_qm: maps match-KF camera coords -> query camera
    q: np.ndarray
    t: np.ndarray
    point_ids: torch.Tensor  # [local_points] map point slots near the match
    #                          keyframe (P = padding), on the map's device
    n_matches: int


def _upload(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _kf_features(st: ms.MapState, k: int) -> FrameFeatures:
    """Keyframe k's features as a pseudo-frame for the window matcher."""
    return FrameFeatures(
        xy=st.kf_xy[k], response=None, level=st.kf_level[k],
        angle=st.kf_angle[k], desc=st.kf_desc[k],
        valid=st.kf_feat_valid[k], u_right=st.kf_right[k],
        depth=st.kf_depth[k])


def _project(cam, pc):
    z = pc[..., 2]
    zc = z.clamp_min(1e-6)
    uv = torch.stack([cam.fx * pc[..., 0] / zc + cam.cx,
                      cam.fy * pc[..., 1] / zc + cam.cy], -1)
    vis = (z > 0.05) & (uv[..., 0] >= 0) & (uv[..., 0] < cam.width) \
        & (uv[..., 1] >= 0) & (uv[..., 1] < cam.height)
    return uv, vis


class LoopCloser:
    """Per-agent loop closing (one per System)."""

    def __init__(self, cfg: SlamConfig, vocab: bow_mod.Vocabulary):
        self.cfg = cfg
        self.vocab = vocab
        self.db = kfdb_mod.empty_database(cfg.caps.max_keyframes, vocab,
                                          cfg.caps.max_features)
        self.consistency = LoopCandidateState(groups=[])
        self.last_loop_kf = -1e9
        # loop pairs stored by keyframe UID, not slot: slots are recycled
        # after culling, so a slot-keyed edge could bind an unrelated new
        # keyframe into every later pose-graph solve
        self.loop_edges: list = []   # [(uid_i, uid_j)]

    # -- detection ---------------------------------------------------------

    def process_keyframe(self, shared, kf_slot: int) -> Optional[Sim3Match]:
        """Detect and verify a loop for a freshly inserted keyframe. Adds the
        keyframe to the database either way (the reference adds it after the
        query). Returns a verified Sim3Match or None."""
        st = shared.state
        self.db, cand_mask, words, valid, vec = _detect_loop_query(
            self.db, self.vocab, st, kf_slot,
            self.cfg.mapping.covis_edge_min_weight)
        # refractory window in creation-sequence numbers, not slots
        uid = int(shared.kf_uid[kf_slot])
        if uid - self.last_loop_kf < self.cfg.loop.refractory_kfs \
                or shared.n_created < self.cfg.loop.refractory_kfs:
            return None
        # the reference also gates on the live map size
        if len(shared.uid_slot) < self.cfg.loop.refractory_kfs:
            return None

        cand = self._detect(shared, kf_slot, cand_mask, words, valid, vec)
        for c in cand:
            m = self.compute_sim3(shared, kf_slot, c)
            if m is not None:
                return m
        return None

    def _detect(self, shared, kf_slot, cand_mask, words, valid, vec):
        cands = np.nonzero(host_fetch(cand_mask))[0].tolist()
        if not cands:
            self.consistency.groups = []
            enough = []
        else:
            enough = self._consistency_filter(shared, cands)
        if diag.recall_sink().enabled:
            st = shared.state
            db = kfdb_mod.erase_keyframe(self.db, kf_slot)
            diag.log_recall_query(
                "loop", -1, kf_slot, int(st.kf_frame_id[kf_slot]), db,
                words, valid, vec, st.covis.cpu().numpy(), None, -1,
                cands, enough,
                [c for (_, c) in self.consistency.groups])
        return enough

    def _consistency_filter(self, shared, cands):
        """Covisibility-consistency groups (one read of the covisibility
        matrix)."""
        covis = host_fetch(shared.state.covis)
        th = self.cfg.loop.consistency_th
        new_groups = []
        enough = []
        for c in cands:
            group = set(np.nonzero(covis[c] > 0)[0].tolist()) | {c}
            best = 0
            for (g, count) in self.consistency.groups:
                if group & g:
                    best = max(best, count + 1)
            new_groups.append((group, best))
            if best >= th:
                enough.append(c)
        self.consistency.groups = new_groups
        return enough

    # -- Sim3 verification (ComputeSim3) -------------------------------------

    @torch.no_grad()
    def compute_sim3(self, shared, kf_q: int, kf_m: int
                     ) -> Optional[Sim3Match]:
        cfg = self.cfg
        st = shared.state
        dev = st.kf_q.device
        fix_scale = cfg.sensor != Sensor.MONOCULAR

        def log_stage(stage, **kw):
            if diag.recall_sink().enabled:
                diag.recall_sink().write(dict(
                    kind="sim3", kf_q=kf_q, kf_m=kf_m, stage=stage, **kw))

        # 1. descriptor matches between the two keyframes' map points
        res = matchers.match_brute(
            st.kf_desc[kf_q],
            (st.kf_mp[kf_q] >= 0) & st.kf_feat_valid[kf_q],
            st.kf_desc[kf_m],
            (st.kf_mp[kf_m] >= 0) & st.kf_feat_valid[kf_m],
            th=cfg.matcher.th_low, nn_ratio=0.75)
        ok, best_feat, row_q, row_m = host_fetch(torch.stack([
            res.ok.long(), res.best_feat.long(), st.kf_mp[kf_q].long(),
            st.kf_mp[kf_m].long()]))
        n = int(ok.sum())
        if n < cfg.loop.min_bow_matches:
            log_stage("bow_matches", n=n)
            return None

        # matched pairs: query feature fq <-> match feature fm
        fq = np.nonzero(ok)[0]
        fm = best_feat[fq]
        mp_q, mp_m = row_q[fq], row_m[fm]
        good = (mp_q >= 0) & (mp_m >= 0)
        fq, fm, mp_q, mp_m = fq[good], fm[good], mp_q[good], mp_m[good]
        npairs = len(fq)
        if npairs < cfg.loop.min_bow_matches:
            log_stage("mp_pairs", n=npairs)
            return None
        pc_q, pc_m, uv_q, uv_m, s2_q, s2_m = self._pair_geometry(
            st, kf_q, kf_m, fq, fm, mp_q, mp_m)

        # 2. Sim3 RANSAC (S maps match-camera coordinates -> query camera:
        # horn(p1=pc_m, p2=pc_q))
        rr = horn.sim3_ransac(pc_m, pc_q, uv_m, uv_q, s2_m, s2_q,
                              torch.ones(npairs, dtype=torch.bool,
                                         device=dev),
                              cfg.camera, seed=kf_q * 1000 + kf_m,
                              n_iters=cfg.loop.sim3_ransac_iters,
                              min_inliers=cfg.loop.sim3_ransac_min_inliers,
                              fix_scale=fix_scale)
        if not bool(host_fetch(rr.ok)):
            log_stage("sim3_ransac", n=npairs)
            return None

        # 2b. SearchBySim3: grow the match set by projecting each keyframe's
        # points into the other through the RANSAC Sim3; new pairs join the
        # refinement as inliers
        extra = self._search_by_sim3(st, kf_q, kf_m, rr.s, rr.q, rr.t,
                                     row_q, row_m)
        if extra is not None:
            fq2, fm2, mp_q2, mp_m2 = extra
            known = set(zip(fq.tolist(), fm.tolist()))
            keep = [i for i in range(len(fq2))
                    if (fq2[i], fm2[i]) not in known]
            if keep:
                fq = np.concatenate([fq, fq2[keep]])
                fm = np.concatenate([fm, fm2[keep]])
                mp_q = np.concatenate([mp_q, mp_q2[keep]])
                mp_m = np.concatenate([mp_m, mp_m2[keep]])
                npairs = len(fq)
                pc_q, pc_m, uv_q, uv_m, s2_q, s2_m = self._pair_geometry(
                    st, kf_q, kf_m, fq, fm, mp_q, mp_m)
                rr = rr._replace(inliers=torch.cat([
                    rr.inliers, torch.ones(len(keep), dtype=torch.bool,
                                           device=dev)]))

        # 3. refine (S12 convention of optimize_sim3: x1 in the query camera
        # frame, x2 in the match camera frame, S12 maps x2 -> x1)
        opt = sim3_opt.optimize_sim3(
            rr.s, rr.q, rr.t, pc_q, pc_m, uv_q, uv_m,
            1.0 / s2_q, 1.0 / s2_m, rr.inliers, cfg.camera,
            fix_scale=fix_scale)
        n_inliers = int(host_fetch(opt.n_inliers))
        if n_inliers < cfg.loop.sim3_opt_min_inliers:
            log_stage("sim3_opt", n=n_inliers, npairs=npairs)
            return None

        # 4. guided projection of the match-side neighbourhood points into
        # the query frame; total matches >= 40
        P = st.mp_pos.shape[0]
        neigh = fill_at(ms.covis_neighbors_mask(st, kf_m, 1).clone(), kf_m,
                        True)
        obs_sel = torch.where(neigh[:, None], st.kf_mp,
                              torch.full_like(st.kf_mp, NONE))
        cand_mask = mask_from_ids(obs_sel, P) & st.mp_valid
        ids = first_true_indices(cand_mask, cfg.caps.local_points, P)
        # corrected query pose: Scw = S_qm * Tmw (match world -> query cam)
        s_c, q_c, t_c = sim3.compose(
            opt.s, opt.q, opt.t, *sim3.from_se3(st.kf_q[kf_m], st.kf_t[kf_m]))
        total = self._count_projection_matches(st, kf_q, ids, s_c, q_c, t_c)
        sqt_total = host_fetch(torch.cat([opt.s[None], opt.q, opt.t,
                                          total[None].to(opt.s.dtype)]))
        total = int(sqt_total[8])
        if total < cfg.loop.min_total_matches:
            log_stage("total_proj", n=total, opt_inliers=n_inliers)
            return None

        log_stage("ACCEPT", n=total, s=float(sqt_total[0]))
        self.last_loop_kf = int(shared.kf_uid[kf_q])
        return Sim3Match(kf_query=kf_q, kf_match=kf_m,
                         s=float(sqt_total[0]), q=sqt_total[1:5].copy(),
                         t=sqt_total[5:8].copy(), point_ids=ids,
                         n_matches=total)

    def _pair_geometry(self, st, kf_q, kf_m, fq, fm, mp_q, mp_m):
        """Camera-frame coordinates, pixels and level variances of matched
        pairs (one upload of the pair list)."""
        idx = _upload(np.stack([fq, fm, mp_q, mp_m]).astype(np.int64),
                      st.kf_q.device)
        fq_t, fm_t, mp_q_t, mp_m_t = idx
        pc_q = se3.apply(st.kf_q[kf_q], st.kf_t[kf_q], st.mp_pos[mp_q_t])
        pc_m = se3.apply(st.kf_q[kf_m], st.kf_t[kf_m], st.mp_pos[mp_m_t])
        sf = steps._scale_factors(self.cfg, st.kf_q.device)
        s2_q = sf[st.kf_level[kf_q][fq_t].long()] ** 2
        s2_m = sf[st.kf_level[kf_m][fm_t].long()] ** 2
        return (pc_q, pc_m, st.kf_xy[kf_q][fq_t], st.kf_xy[kf_m][fm_t],
                s2_q, s2_m)

    def _search_by_sim3(self, st, kf_q, kf_m, s, q, t, row_q, row_m):
        """Sim3-guided bidirectional windowed matching between the two
        keyframes' map points (SearchBySim3): match-side points projected
        into the query frame through S_qm * T_mw, query-side points into the
        match frame through S_qm^-1 * T_qw; only pairs on which both
        directions agree survive. row_q / row_m are the two keyframes'
        feature -> point rows, already on the host. Returns new (fq, fm,
        mp_q, mp_m) arrays or None. One read of the device."""
        cfg = self.cfg
        F = st.kf_mp.shape[1]
        P = st.mp_pos.shape[0]
        radius = torch.full((), 7.5, device=st.kf_q.device)

        def project_dir(src_kf, dst_kf, s_c, q_c, t_c):
            mp_row = st.kf_mp[src_kf]
            mask = (mp_row >= 0) & st.kf_feat_valid[src_kf]
            pw = st.mp_pos[mp_row.long().clamp(0, P - 1)]
            uv, vis = _project(cfg.camera, sim3.apply(s_c, q_c, t_c, pw))
            res = matchers.match_window(_kf_features(st, dst_kf),
                                        st.kf_desc[src_kf], mask & vis, uv,
                                        radius=radius, th=cfg.matcher.th_high)
            _, res = matchers.resolve_conflicts(res, F)
            # [F] over src features: matched dst feature or -1
            return torch.where(res.ok, res.best_feat,
                               torch.full_like(res.best_feat, -1))

        # forward: match-KF points -> query image (S_qm * T_mw)
        fwd = project_dir(kf_m, kf_q, *sim3.compose(
            s, q, t, *sim3.from_se3(st.kf_q[kf_m], st.kf_t[kf_m])))
        # reverse: query-KF points -> match image (S_qm^-1 * T_qw)
        rev = project_dir(kf_q, kf_m, *sim3.compose(
            *sim3.inverse(s, q, t),
            *sim3.from_se3(st.kf_q[kf_q], st.kf_t[kf_q])))
        fwd, rev = host_fetch(torch.stack([fwd, rev]))

        # agreement check: fwd[fm] == fq and rev[fq] == fm
        fm2 = np.nonzero(fwd >= 0)[0]
        fq2 = fwd[fm2]
        agree = rev[fq2] == fm2
        fm2, fq2 = fm2[agree], fq2[agree]
        if len(fm2) == 0:
            return None
        mp_m2, mp_q2 = row_m[fm2], row_q[fq2]
        good = (mp_q2 >= 0) & (mp_m2 >= 0)
        return fq2[good], fm2[good], mp_q2[good], mp_m2[good]

    def _count_projection_matches(self, st, kf_q, ids, s_c, q_c, t_c):
        """SearchByProjection of world points through a Sim3 camera pose:
        the number of matches (existing ones included), on the device."""
        cfg = self.cfg
        P = st.mp_pos.shape[0]
        ids_c = ids.clamp(0, P - 1)
        valid = (ids < P) & st.mp_valid[ids_c]
        uv, vis = _project(cfg.camera, sim3.apply(s_c, q_c, t_c,
                                                  st.mp_pos[ids_c]))
        res = matchers.match_window(
            _kf_features(st, kf_q), st.mp_desc[ids_c], valid & vis, uv,
            radius=torch.full((), 8.0, device=ids.device),
            th=cfg.matcher.th_high)
        return torch.sum(res.ok)

    # -- correction (CorrectLoop) -------------------------------------------

    @torch.no_grad()
    def correct_loop(self, shared, match: Sim3Match, run_gba: bool = True):
        """Apply a verified loop: Sim3-correct the query neighbourhood, fuse
        duplicate points, optimize the essential graph, then (run_gba) a
        global bundle adjustment."""
        cfg = self.cfg
        st = shared.state
        dev = st.kf_q.device
        kf_q, kf_m = match.kf_query, match.kf_match
        fix_scale = cfg.sensor != Sensor.MONOCULAR

        # corrected world -> query Sim3: S_qw = S_qm * T_mw (match.s/q/t is
        # the camera-to-camera Sim3 of compute_sim3)
        sqt = _upload(np.concatenate([[match.s], match.q, match.t])
                      .astype(np.float32), dev)
        s_c, q_c, t_c = sim3.compose(
            sqt[0], sqt[1:5], sqt[5:8],
            *sim3.from_se3(st.kf_q[kf_m], st.kf_t[kf_m]))
        # pre-correction snapshot: the essential graph's measurements of
        # non-loop edges come from these (NonCorrectedSim3)
        q_pre, t_pre = st.kf_q, st.kf_t
        shared.state = correct_neighborhood(st, kf_q, s_c, q_c, t_c, cfg)

        # fuse the matched map points into the corrected neighbourhood
        shared.state = mapping.fuse_into_neighborhood(
            shared.state, torch.as_tensor(match.point_ids, device=dev), kf_q,
            cfg)
        shared.state = mapping.rebuild_observations(shared.state)
        shared.state = steps.recompute_covisibility(shared.state)

        # essential graph (loop edges resolved uid -> current slot; culled
        # endpoints drop out)
        self.loop_edges.append((int(shared.kf_uid[kf_q]),
                                int(shared.kf_uid[kf_m])))
        edges = build_essential_edges(shared.state,
                                      self.resolve_loop_edges(shared), cfg,
                                      q_noncorr=q_pre, t_noncorr=t_pre)
        st = shared.state
        K = st.kf_q.shape[0]
        res = pg.optimize_pose_graph(
            torch.ones(K, device=dev), st.kf_q, st.kf_t, st.kf_valid,
            fill_at(st.kf_fixed_origin.clone(), kf_m, True),
            edges, fix_scale=fix_scale,
            n_iters=cfg.optimizer.essential_graph_iters)
        shared.state = apply_pose_graph_result(st, res, cfg)

        if run_gba:
            shared.state = global_bundle_adjustment(shared.state, cfg)
        return shared.state

    def resolve_loop_edges(self, shared):
        """Stored (uid, uid) loop edges as current slots, dropping edges
        with culled endpoints."""
        out = []
        for ua, ub in self.loop_edges:
            a = shared.uid_slot.get(ua)
            b = shared.uid_slot.get(ub)
            if a is not None and b is not None:
                out.append((a, b))
        return out


# ---------------------------------------------------------------------------
# tensor programs (shared with map fusion once the server is ported)
# ---------------------------------------------------------------------------

@torch.no_grad()
def _detect_loop_query(db, vocab, st: ms.MapState, kf_slot: int,
                       covis_min_edge: int = 15):
    """Database insert + minScore scan + DetectLoopCandidates, no host read.

    minScore = lowest BoW similarity against the query's direct covisibles;
    the query excludes its covisible neighbourhood and its own fresh row."""
    valid = st.kf_feat_valid[kf_slot]
    db2, words, vec = kfdb_mod.add_keyframe(db, vocab, kf_slot,
                                            st.kf_desc[kf_slot], valid)
    covis_row = st.covis[kf_slot]
    neigh = covis_row >= covis_min_edge
    scores, _ = kfdb_mod.score_and_common(db2, words, valid, vec)
    neigh_scores = torch.where(neigh & db2.active, scores,
                               torch.full_like(scores, torch.inf))
    lowest = torch.min(neigh_scores)
    min_score = torch.where(torch.isfinite(lowest), lowest,
                            torch.full_like(lowest, 1e-3)).clamp_min(1e-3)
    dbq = kfdb_mod.erase_keyframe(db2, kf_slot)
    cand_mask, _ = kfdb_mod.detect_loop_candidates(
        dbq, vocab, words, valid, vec, covis_row, kf_slot, st.covis,
        min_score)
    return db2, cand_mask, words, valid, vec


@torch.no_grad()
def correct_neighborhood(st: ms.MapState, kf_q: int, s, q, t,
                         cfg: SlamConfig):
    """Sim3-propagate the loop correction over kf_q's covisibility
    neighbourhood and their map points. (s, q, t) is the corrected Sim3
    world -> query camera; each neighbour i becomes T_iq * S_qw (T_iq its
    old pose relative to the query), recovered to SE3 by dividing the
    translation by the scale; each point observed by the neighbourhood moves
    with the first neighbour that observes it."""
    K = st.kf_q.shape[0]
    P = st.mp_pos.shape[0]
    neigh = fill_at(ms.covis_neighbors_mask(st, kf_q, 1).clone(), kf_q,
                    True) & st.kf_valid

    q_old, t_old = st.kf_q[kf_q], st.kf_t[kf_q]
    qi_rel, ti_rel = se3.relative(st.kf_q, st.kf_t, q_old, t_old)
    s_i, q_i, t_i = sim3.compose(torch.ones(K, device=s.device), qi_rel,
                                 ti_rel, s.expand(K), q.expand(K, 4),
                                 t.expand(K, 3))
    q_new, t_new = sim3.to_se3(s_i, q_i, t_i)

    obs_sel = torch.where(neigh[:, None], st.kf_mp,
                          torch.full_like(st.kf_mp, NONE))
    pmask = mask_from_ids(obs_sel, P) & st.mp_valid
    obs_kf = st.mp_obs_kf.long()
    in_neigh = (obs_kf >= 0) & neigh[obs_kf.clamp(0, K - 1)]
    anchor_slot = torch.argmax(in_neigh.to(torch.int32), dim=-1)
    has_anchor = torch.any(in_neigh, dim=-1)
    anchor = obs_kf.gather(1, anchor_slot[:, None])[:, 0].clamp(0, K - 1)

    pc = se3.apply(st.kf_q[anchor], st.kf_t[anchor], st.mp_pos)  # old cam
    si_a, qi_a, ti_a = sim3.inverse(s_i[anchor], q_i[anchor], t_i[anchor])
    p_new = sim3.apply(si_a, qi_a, ti_a, pc)
    upd = (pmask & has_anchor)[:, None]
    return st._replace(
        kf_q=torch.where(neigh[:, None], q_new, st.kf_q),
        kf_t=torch.where(neigh[:, None], t_new, st.kf_t),
        mp_pos=torch.where(upd, p_new, st.mp_pos))


@torch.no_grad()
def build_essential_edges(st: ms.MapState, loop_edges, cfg: SlamConfig,
                          q_noncorr=None, t_noncorr=None
                          ) -> pg.PoseGraphEdges:
    """Edge set of the essential graph: spanning tree + stored loop edges +
    strong covisibility (>= strong_covis_min_feat shared points).

    Spanning-tree and covisibility edges are measured from the
    pre-correction poses (q_noncorr / t_noncorr when given), loop edges from
    the current corrected ones (NonCorrectedSim3): measured all from the
    current mixed state, the graph would be self-consistent and the solve a
    no-op. The edge list is built on the host from one read of the
    covisibility matrix, validity and parents, padded to a multiple of 512
    and never truncated, and uploaded once."""
    K = st.kf_q.shape[0]
    dev = st.kf_q.device
    host = host_fetch(torch.cat([st.covis, st.kf_valid.to(torch.int32)[None],
                                 st.kf_parent[None]]))
    covis, valid, parent = host[:K], host[K].astype(bool), host[K + 1]

    # spanning tree: (parent[k], k) for every valid KF with a valid parent
    sp_ok = valid & (parent >= 0) & valid[np.clip(parent, 0, K - 1)]
    sp_j = np.nonzero(sp_ok)[0]
    sp_i = parent[sp_j]
    # strong covisibility (upper triangle)
    th = cfg.optimizer.strong_covis_min_feat
    cv = (np.triu(covis, 1) >= th) & valid[:, None] & valid[None, :]
    cv_i, cv_j = np.nonzero(cv)
    lp = np.asarray(loop_edges, np.int64).reshape(-1, 2)
    if len(lp):   # drop loop rows whose endpoint slots are not live
        lp = lp[valid[lp[:, 0]] & valid[lp[:, 1]]]
    ei = np.concatenate([sp_i, cv_i, lp[:, 0]]).astype(np.int32)
    ej = np.concatenate([sp_j, cv_j, lp[:, 1]]).astype(np.int32)
    n = len(ei)
    E = max(512, -(-n // 512) * 512)
    cols = np.zeros((4, E), np.int32)      # i, j, valid, is_loop
    cols[0, :n] = ei
    cols[1, :n] = ej
    cols[2, :n] = 1
    cols[3, n - len(lp):n] = 1
    i_t, j_t, v_t, lp_t = _upload(cols, dev)
    ii, jj = i_t.long(), j_t.long()
    ones = torch.ones(E, device=dev)
    if q_noncorr is None:
        q_src, t_src, q_dst, t_dst = st.kf_q[ii], st.kf_t[ii], st.kf_q[jj], \
            st.kf_t[jj]
    else:
        is_lp = (lp_t > 0)[:, None]
        q_src = torch.where(is_lp, st.kf_q[ii], q_noncorr[ii])
        t_src = torch.where(is_lp, st.kf_t[ii], t_noncorr[ii])
        q_dst = torch.where(is_lp, st.kf_q[jj], q_noncorr[jj])
        t_dst = torch.where(is_lp, st.kf_t[jj], t_noncorr[jj])
    sm, qm, tm = pg.make_edge_measurements(ones, q_src, t_src, ones, q_dst,
                                           t_dst)
    return pg.PoseGraphEdges(i=i_t, j=j_t, s=sm, q=qm, t=tm, valid=v_t > 0)


@torch.no_grad()
def apply_pose_graph_result(st: ms.MapState, res: pg.PoseGraphResult,
                            cfg: SlamConfig):
    """Write the corrected poses back and move each point with its first
    observing keyframe."""
    K = st.kf_q.shape[0]
    q_new, t_new = sim3.to_se3(res.s, res.q, res.t)
    q_new = se3.quat_normalize(q_new)
    obs0 = st.mp_obs_kf[:, 0].long()
    anchor = obs0.clamp(0, K - 1)
    pc = se3.apply(st.kf_q[anchor], st.kf_t[anchor], st.mp_pos)
    si, qi, ti = sim3.inverse(res.s[anchor], res.q[anchor], res.t[anchor])
    p_new = sim3.apply(si, qi, ti, pc)
    upd = (st.mp_valid & (obs0 >= 0))[:, None]
    valid = st.kf_valid[:, None]
    return st._replace(
        kf_q=torch.where(valid, q_new, st.kf_q),
        kf_t=torch.where(valid, t_new, st.kf_t),
        mp_pos=torch.where(upd, p_new, st.mp_pos))


@torch.no_grad()
def global_bundle_adjustment(st: ms.MapState, cfg: SlamConfig,
                             n_iters: int = None):
    """Full-map BA (GlobalBundleAdjustment and the correction it applies),
    through ``optim.ba.ba_solve_fast``, so its Schur preparation and PCG run
    through the kernels' wrappers."""
    n_iters = n_iters or cfg.optimizer.global_ba_iters
    K, F, P, O = st.caps
    obs_kf = st.mp_obs_kf
    obs_feat = st.mp_obs_feat.long().clamp(0, F - 1)
    kf_c = obs_kf.long().clamp(0, K - 1)
    uv = st.kf_xy[kf_c, obs_feat]
    ur = st.kf_right[kf_c, obs_feat]
    level = st.kf_level[kf_c, obs_feat]
    sf = steps._scale_factors(cfg, obs_kf.device)
    obs_mask = (obs_kf >= 0) & st.mp_valid[:, None] & st.kf_valid[kf_c]

    prob = ba_mod.BAProblem(
        q=st.kf_q, t=st.kf_t,
        pose_valid=st.kf_valid,
        pose_fixed=st.kf_fixed_origin,
        pw=st.mp_pos,
        point_valid=st.mp_valid,
        obs_kf=torch.where(obs_mask, obs_kf, torch.full_like(obs_kf, NONE)),
        obs_uvr=torch.cat([uv, ur[..., None]], -1),
        obs_inv_sigma2=1.0 / sf[level.long()] ** 2,
        obs_stereo=ur >= 0,
        obs_mask=obs_mask,
    )
    res = ba_mod.ba_solve_fast(prob, cfg.camera, n_iters=n_iters,
                               use_huber=True, chunk=steps._ba_chunk(P))
    moved = (st.kf_valid & ~st.kf_fixed_origin)[:, None]
    return st._replace(
        kf_q=torch.where(moved, res.q, st.kf_q),
        kf_t=torch.where(moved, res.t, st.kf_t),
        mp_pos=torch.where(st.mp_valid[:, None], res.pw, st.mp_pos))
