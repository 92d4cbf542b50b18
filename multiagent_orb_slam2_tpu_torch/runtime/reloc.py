"""Relocalization: recover a lost tracker from the keyframe database.

Counterpart of the JAX package's ``runtime/reloc.py`` (reference
Tracking::Relocalization): BoW candidate query -> per-candidate brute
descriptor matching -> EPnP RANSAC -> robust pose optimization (K1) -> up
to two projection match-growth rounds -> accept at ``reloc_min_inliers``
(50) inliers.

The candidate set can be scoped to one map (``map_id``): relocalizing into
another agent's map before a verified fusion would alias two world frames.

The host decides, so the host waits: one read for the candidates and their
scores, then per candidate one for the match count, one for the RANSAC
verdict and one for the inlier count after each pose optimization, and one
for the new matches of each growth round; EPnP's eigendecompositions add two
more (``geometry/epnp.py``). All of them happen on LOST frames only.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import SlamConfig
from ..geometry import epnp
from ..mapstate import state as ms
from ..ops import matchers
from ..optim import pose_opt
from ..utils.torch_ops import const_tensor, host_fetch, set_drop
from ..vocab import bow as bow_mod
from ..vocab import kfdb as kfdb_mod
from .tracker import Tracker, TrackerState

MAX_CANDIDATES = 5
MIN_BRUTE_MATCHES = 15
RANSAC_HYPOTHESES = 200
# (window radius at level 0 in pixels, descriptor threshold) of the two
# match-growth rounds (src/Tracking.cc:1452-1502)
GROWTH_ROUNDS = ((10.0, 100), (3.0, 64))


@torch.no_grad()
def relocalize(tracker: Tracker, db: kfdb_mod.KFDatabase,
               vocab: bow_mod.Vocabulary, feats, cfg: SlamConfig,
               map_id: Optional[int] = None) -> bool:
    """Attempt to relocalize `tracker` on frame features `feats`.

    map_id: restrict candidate keyframes to this map (None = all maps).
    On success the tracker is switched back to OK with the recovered pose,
    reference keyframe and frame->point associations; its latest trajectory
    record is rewritten in place. Returns True on success."""
    sh = tracker.shared
    st = sh.state
    dev = feats.xy.device
    words = bow_mod.transform_words(vocab, feats.desc, feats.valid)
    vec = bow_mod.bow_vector(vocab, words, feats.valid)
    cand_mask, scores = kfdb_mod.detect_reloc_candidates(
        db, words, feats.valid, vec, st.covis)
    rows = [cand_mask.to(torch.float32), scores]
    if map_id is not None:
        rows.append(st.kf_map.to(torch.float32))
    host = host_fetch(torch.stack(rows))
    cand = host[0] > 0
    if map_id is not None:
        cand &= host[2] == map_id
    cands = np.nonzero(cand)[0]
    # numpy's argsort on the same float32 scores: ties break as in the JAX
    # package
    order = np.argsort(-host[1][cands])
    P = st.mp_pos.shape[0]
    F = feats.xy.shape[0]
    sf = const_tensor(cfg.orb.scale_factors, torch.float32, dev)
    for c in cands[order][:MAX_CANDIDATES]:
        c = int(c)
        kf_mp = st.kf_mp[c]
        mp = kf_mp.long().clamp(0, P - 1)
        qmask = (kf_mp >= 0) & st.kf_feat_valid[c] & st.mp_valid[mp]
        res = matchers.match_brute(st.kf_desc[c], qmask, feats.desc,
                                   feats.valid, th=cfg.matcher.th_low,
                                   nn_ratio=0.75)
        if int(host_fetch(torch.sum(res.ok))) < MIN_BRUTE_MATCHES:
            continue
        sel = res.ok
        pw = st.mp_pos[mp]
        feat = res.best_feat.clamp(0, F - 1)
        uv = feats.xy[feat]
        sigma2 = sf[feats.level[feat].long()] ** 2
        rr = epnp.epnp_ransac(pw, uv, sigma2, sel, cfg.camera, seed=c,
                              n_iters=RANSAC_HYPOTHESES)
        if not bool(host_fetch(rr.ok)):
            continue
        # polish with robust pose optimization over the matches
        obs = pose_opt.PoseObs(
            pw=pw, obs=torch.cat([uv, feats.u_right[feat][:, None]], -1),
            inv_sigma2=1.0 / sigma2, is_stereo=feats.u_right[feat] >= 0,
            mask=sel & rr.inliers)
        q, t, inlier, n = pose_opt.pose_optimize(rr.q, rr.t, obs, cfg.camera,
                                                 cfg.optimizer)
        n = int(host_fetch(n))
        # match-growth rounds: when the EPnP solution has too few inliers,
        # project the candidate keyframe's points with the current estimate
        # and window-match to add observations, re-optimize; a second,
        # narrower round if still short of the bar
        feat_cur = feat
        radius_scale = sf[st.kf_level[c].long()]
        for radius_px, th_d in GROWTH_ROUNDS:
            if n >= cfg.tracking.reloc_min_inliers:
                break
            uvp, _, _, visp = matchers.project_points(cfg.camera, q, t, pw)
            grow_mask = qmask & ~inlier & visp
            res2 = matchers.match_window(feats, st.kf_desc[c], grow_mask,
                                         uvp, radius_px * radius_scale,
                                         th=th_d)
            _, res2 = matchers.resolve_conflicts(res2, F)
            new_ok = res2.ok & ~inlier
            if int(host_fetch(torch.sum(new_ok))) == 0:
                continue
            feat_cur = torch.where(inlier, feat_cur,
                                   res2.best_feat.clamp(0, F - 1))
            sigma2_2 = sf[feats.level[feat_cur].long()] ** 2
            obs2 = pose_opt.PoseObs(
                pw=pw,
                obs=torch.cat([feats.xy[feat_cur],
                               feats.u_right[feat_cur][:, None]], -1),
                inv_sigma2=1.0 / sigma2_2,
                is_stereo=feats.u_right[feat_cur] >= 0,
                mask=inlier | new_ok)
            q, t, inlier, n = pose_opt.pose_optimize(q, t, obs2, cfg.camera,
                                                     cfg.optimizer)
            n = int(host_fetch(n))
        if n < cfg.tracking.reloc_min_inliers:
            continue
        # success: adopt the pose, rebuild the frame association
        frame_mp = set_drop(
            torch.full((F,), ms.NONE, dtype=torch.int32, device=dev),
            torch.where(inlier, feat_cur, torch.full_like(feat_cur, F)),
            torch.where(inlier, kf_mp, torch.full_like(kf_mp, ms.NONE)))
        tracker.state = TrackerState.OK
        tracker.last_q, tracker.last_t = q, t
        tracker.last_feats = feats
        tracker.last_frame_mp = frame_mp
        tracker.ref_kf = c
        tracker.has_velocity = False
        if tracker.trajectory:
            # re-anchor the record on the relocalization keyframe: the
            # pre-lost reference would re-chain this frame through a
            # keyframe unrelated to the recovered pose
            snap = host_fetch(torch.cat([q, t, st.kf_q[c], st.kf_t[c]]))
            rec = tracker.trajectory[-1]
            rec.q, rec.t = snap[:4], snap[4:7]
            rec.lost = False
            rec.ref_kf = c
            rec.ref_uid = int(sh.kf_uid[c])
            rec.ref_q, rec.ref_t = snap[7:11], snap[11:14]
        return True
    return False
