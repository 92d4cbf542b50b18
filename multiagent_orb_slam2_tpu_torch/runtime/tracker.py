"""Host-side tracking orchestrator: the Tracking state machine.

Counterpart of the JAX package's ``runtime/tracker.py`` (reference Tracking
thread + the LocalMapping consumer for the synchronous phases). The host
never touches image or descriptor data: it sequences the steps of
``runtime.steps`` and makes the small-scalar decisions (state transitions,
keyframe need, slot allocation).

Stereo, RGB-D and monocular tracking (the monocular two-view bootstrap
included), with local bundle adjustment and keyframe culling on every
keyframe once the tracker's map has three, and localization-only mode.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import SlamConfig, Sensor
from ..geometry import se3, twoview
from ..mapstate import state as ms
from ..ops import frame as frame_mod
from ..ops import matchers
from ..utils.torch_ops import fill_at, host_fetch
from . import loop_closing as lc
from . import mapping, steps


class TrackerState:
    NOT_INITIALIZED = 0
    OK = 1
    LOST = 2


class SharedMap:
    """Owns the MapState tensors + slot allocation / recycling bookkeeping.

    Slot lifecycle:
    - keyframes: culled slots go to `pending_release` until the database
      owner has erased their rows, then to the `free_kf` list and are reused
      by alloc_kf. Every allocation gets a monotonically increasing uid;
      uids drive age arithmetic (kf_seq) and trajectory-export re-chaining,
      so slot reuse never aliases a dead keyframe.
    - points: creation is contiguous from n_mp; when free capacity drops
      below one frame's worth, `compact_points` packs the surviving points
      to the front (one gather per array + a kf_mp rewrite) and rewinds
      n_mp. Creation beyond capacity is dropped and counted in
      n_point_stalls.

    The host also keeps the map id of every live keyframe slot
    (`kf_map_of`, -1 for a free, culled or invalidated slot), so that
    `n_kf_in_map` (the reference's Map::KeyFramesInMap) needs no device
    read. `n_kf` is the slot high-water mark and counts every agent's
    keyframes, dead slots included; the JAX package's keyframe-count gates
    read it.

    `kf_agent_seq` [K] (device) holds each allocated slot's ordinal among
    its agent's keyframe creations plus agent * mapping.AGENT_SEQ_STRIDE,
    written without a wait; map-point culling counts a point's age in it
    (mapping.cull_points_step).
    """

    def __init__(self, cfg: SlamConfig, device=torch.device("cuda")):
        self.cfg = cfg
        self.device = torch.device(device)
        self.state = ms.empty_map_state(cfg, self.device)
        self.n_kf = 0          # slot high-water mark
        self.n_mp = 0
        self.n_created = 0     # total keyframes ever created (uid counter)
        self.kf_uid = np.full(cfg.caps.max_keyframes, -1, np.int64)
        self.kf_map_of = np.full(cfg.caps.max_keyframes, -1, np.int64)
        self.kf_agent_seq = torch.full((cfg.caps.max_keyframes,), ms.NONE,
                                       dtype=torch.int32, device=self.device)
        self.n_created_of: dict[int, int] = {}   # agent -> its creations
        self.uid_slot: dict[int, int] = {}   # live uid -> slot
        self.free_kf: list[int] = []
        self.pending_release: list[int] = []
        self.trackers: list = []             # for compaction remaps
        self.n_point_stalls = 0
        self.n_compactions = 0
        # uid -> (parent_uid, rel_q, rel_t) at cull time, used by the
        # trajectory export to re-chain frames whose reference keyframe was
        # later erased
        self.cull_info: dict[int, tuple] = {}

    def alloc_kf(self, map_id: int = 0, agent: int = 0) -> int:
        """A slot for a new keyframe of map `map_id`, made by `agent`."""
        if self.free_kf:
            slot = self.free_kf.pop()
        elif self.n_kf < self.cfg.caps.max_keyframes:
            slot = self.n_kf
            self.n_kf += 1
        else:
            raise RuntimeError(
                "keyframe capacity exhausted (no culled slots to recycle)")
        uid = self.n_created
        self.n_created += 1
        self.kf_uid[slot] = uid
        self.uid_slot[uid] = slot
        self.kf_map_of[slot] = map_id
        n_own = self.n_created_of.get(agent, 0)
        self.n_created_of[agent] = n_own + 1
        fill_at(self.kf_agent_seq, slot,
                agent * mapping.AGENT_SEQ_STRIDE + n_own)
        self.state = self.state._replace(
            kf_seq=fill_at(self.state.kf_seq.clone(), slot, uid))
        return slot

    def note_culled(self, slot: int, parent_slot, rel_q, rel_t):
        """Record a culled keyframe's relative-pose chain entry and queue
        its slot for reuse (after upstream database erasure)."""
        uid = int(self.kf_uid[slot])
        if uid >= 0:
            if parent_slot is not None and parent_slot >= 0:
                self.cull_info[uid] = (int(self.kf_uid[parent_slot]),
                                       rel_q, rel_t)
            self.uid_slot.pop(uid, None)
        self.kf_map_of[slot] = -1
        self.pending_release.append(slot)

    def note_invalidated(self, slot: int):
        """Keyframe invalidated without chain info (agent reset)."""
        uid = int(self.kf_uid[slot])
        self.uid_slot.pop(uid, None)
        self.kf_map_of[slot] = -1
        self.pending_release.append(slot)

    def relabel_map(self, src: int, dst: int):
        """Every live keyframe of map `src` now belongs to map `dst` (a
        fusion)."""
        self.kf_map_of[self.kf_map_of == src] = dst

    def n_kf_in_map(self, map_id: int) -> int:
        """Live keyframes of map `map_id`, from the host's labels."""
        return int(np.count_nonzero(self.kf_map_of == map_id))

    def reclaim_slots(self):
        """Move database-erased slots to the free list."""
        self.free_kf.extend(self.pending_release)
        self.pending_release.clear()

    def mp_base(self) -> int:
        return self.n_mp

    def commit_mp(self, n_new: int):
        if self.n_mp + n_new > self.cfg.caps.max_points:
            self.n_point_stalls += (self.n_mp + n_new
                                    - self.cfg.caps.max_points)
        self.n_mp = min(self.n_mp + n_new, self.cfg.caps.max_points)
        # keep a full keyframe-pipeline's worth of headroom: one keyframe
        # can allocate several neighbor-pairs' worth of new points before
        # the host sees the count
        if self.cfg.caps.max_points - self.n_mp \
                < 4 * self.cfg.caps.max_features:
            self.compact_points()

    @torch.no_grad()
    def compact_points(self):
        """Pack surviving points to the front of the point arrays, reclaiming
        slots of culled/merged points. One host read of mp_valid + a
        permutation-gather; every tracker's live frame->point row is
        remapped through the same LUT."""
        P = self.cfg.caps.max_points
        valid = host_fetch(self.state.mp_valid)
        idx_valid = np.nonzero(valid)[0]
        n_valid = len(idx_valid)
        if n_valid >= self.n_mp:
            return  # nothing to reclaim
        perm = np.concatenate([idx_valid,
                               np.nonzero(~valid)[0]]).astype(np.int64)
        lut = np.full(P + 1, ms.NONE, np.int32)
        lut[idx_valid] = np.arange(n_valid, dtype=np.int32)
        perm_t = torch.from_numpy(perm).to(self.device)
        lut_t = torch.from_numpy(lut).to(self.device)
        self.state = _compact_points_apply(self.state, perm_t, lut_t)
        for t in self.trackers:
            if t.last_frame_mp is not None:
                old = t.last_frame_mp
                t.last_frame_mp = torch.where(
                    old >= 0, lut_t[old.long().clamp(0, P)],
                    torch.full_like(old, ms.NONE))
        self.n_mp = n_valid
        self.n_compactions += 1


def _compact_points_apply(state: ms.MapState, perm, lut):
    """Permute every point-axis array by `perm` (valid points first) and
    rewrite the forward map kf_mp through `lut` (old slot -> new slot).
    The inverse observation rows ride the same permutation, so no rebuild
    is needed."""
    P = state.mp_pos.shape[0]
    kf_mp = torch.where(state.kf_mp >= 0,
                        lut[state.kf_mp.long().clamp(0, P)],
                        torch.full_like(state.kf_mp, ms.NONE))
    point_fields = [f for f in state._fields if f.startswith("mp_")]
    return state._replace(
        kf_mp=kf_mp, **{f: getattr(state, f)[perm] for f in point_fields})


@dataclasses.dataclass
class FrameRecord:
    """Per-frame trajectory record. The absolute pose q/t is the track-time
    estimate; ref_kf plus the reference KF's pose snapshot (ref_q/ref_t,
    taken the same frame) let export re-chain each frame against the CURRENT
    keyframe pose so later corrections fix the whole trajectory."""
    frame_id: int
    q: np.ndarray
    t: np.ndarray
    lost: bool
    ref_kf: int = -1
    ref_uid: int = -1          # creation uid of ref_kf (slots are recycled)
    ref_q: Optional[np.ndarray] = None
    ref_t: Optional[np.ndarray] = None


class Tracker:
    """Per-agent front end (one per System)."""

    def __init__(self, cfg: SlamConfig, shared: SharedMap, agent: int = 0,
                 map_id: int = 0, run_local_ba: bool = True,
                 device=torch.device("cuda")):
        self.cfg = cfg
        self.shared = shared
        self.device = torch.device(device)
        if self.device != shared.device:
            raise ValueError(f"Tracker on {self.device} but its SharedMap "
                             f"is on {shared.device}")
        self.agent = agent
        self.map_id = map_id
        self.run_local_ba = run_local_ba
        self.state = TrackerState.NOT_INITIALIZED
        self.last_q = None
        self.last_t = None
        self.last_feats = None
        self.last_frame_mp = None
        self.vel_q = se3.quat_identity(device=self.device)
        self.vel_t = torch.zeros(3, device=self.device)
        self.has_velocity = False
        self.ref_kf = -1
        self.last_kf_frame = -1
        self.frame_id = -1
        # localization-only mode (mbOnlyTracking) and its temporal points
        self.only_tracking = False
        self.vo = False          # mbVO: tracking on temporal points only
        self.last_vo_pw = None
        self.last_vo_mask = None
        # monocular bootstrap: the stored reference frame (feats, frame id)
        # and the RANSAC's sample draw, (mask, n_iters, seed) -> [n, 8]
        # indices, seeded with the frame id as the JAX package keys its
        # PRNG; replaceable, so that a parity run can inject JAX's draws
        self.mono_init_ref = None
        self.draw_twoview_samples = twoview.draw_samples
        self.trajectory: list[FrameRecord] = []
        self.n_resets = 0
        self.new_kf_slots: list[int] = []    # queue for loop-closing stage
        self.culled_kf_slots: list[int] = []  # for database erasure upstream
        # multi-agent reset hook (set by the server once it is ported)
        self.on_reset = None
        self._last_decision = None
        shared.trackers.append(self)         # for point-compaction remaps

    # -- public API (System::TrackStereo equivalents) -----------------------

    def track_stereo(self, img_left, img_right, frame_id: Optional[int] = None):
        feats = frame_mod.extract_frame(img_left, self.cfg,
                                        right_img=img_right,
                                        device=self.device)
        return self._track(feats, frame_id)

    def track_mono(self, img, frame_id: Optional[int] = None):
        feats = frame_mod.extract_frame(img, self.cfg, device=self.device)
        return self._track(feats, frame_id)

    def track_rgbd(self, img, depth, frame_id: Optional[int] = None):
        feats = frame_mod.extract_frame(img, self.cfg, depth_map=depth,
                                        device=self.device)
        return self._track(feats, frame_id)

    def track_features(self, feats: frame_mod.FrameFeatures,
                       frame_id: Optional[int] = None):
        """Track pre-extracted features (used by tests and batched drivers)."""
        return self._track(feats, frame_id)

    # -- core state machine (Tracking::Track) -------------------------------

    @torch.no_grad()
    def _track(self, feats, frame_id):
        self.frame_id = self.frame_id + 1 if frame_id is None else frame_id
        self._last_decision = None
        if self.state == TrackerState.NOT_INITIALIZED:
            ok = self._initialize(feats)
            self._record(lost=not ok)
            return (self.last_q, self.last_t) if ok else None

        sh = self.shared

        if self.state == TrackerState.LOST or self.only_tracking:
            q_pred, t_pred = self._predict_pose()

        if self.state == TrackerState.LOST:
            # auto-reset when lost with a barely-started map (reference:
            # KeyFramesInMap() <= 5 -> full Reset): a garbage 3-KF map would
            # otherwise pin the agent to relocalization luck forever
            st = sh.state
            n_mine = int(host_fetch(torch.sum(
                (st.kf_agent == self.agent) & st.kf_valid)))
            if n_mine <= self.cfg.tracking.reset_lost_max_kfs:
                self.reset()
                ok = self._initialize(feats)
                self._record(lost=not ok)
                return (self.last_q, self.last_t) if ok else None
            # once lost, only relocalization recovers (the System facade
            # owns that step): dead-reckon so the trajectory stays continuous
            self.last_q, self.last_t = q_pred, t_pred
            self.last_feats = feats
            self.last_frame_mp = self._no_matches()
            self._record(lost=True)
            return None

        if self.only_tracking:
            return self._track_localization_only(feats, q_pred, t_pred)

        # the cascade: motion model -> wide retry -> ref-KF -> local map,
        # with the host's small-scalar decisions packed into a single [5]
        # vector (one device fetch here)
        tr, new_state, decision, aux = steps.track_frame_step(
            sh.state, feats, self.last_feats, self.last_frame_mp,
            self.ref_kf, self.last_q, self.last_t, self.vel_q, self.vel_t,
            self.has_velocity, sh.n_kf_in_map(self.map_id) > 2, self.cfg)
        q_pred, t_pred, vel_q, vel_t = aux
        decision = host_fetch(decision)
        ok = bool(decision[0])
        sh.state = new_state
        self._last_decision = decision

        if not ok:
            # dead-reckon on the motion model; the System facade then
            # relocalizes
            self.state = TrackerState.LOST
            self.last_q, self.last_t = q_pred, t_pred
            self.last_feats = feats
            self.last_frame_mp = self._no_matches()
            self._record(lost=True)
            return None

        self.state = TrackerState.OK
        # velocity (computed in-step): Tcw_cur * Twc_last
        self.vel_q, self.vel_t = vel_q, vel_t
        self.has_velocity = True

        need_kf = self._need_new_keyframe(feats, tr)
        frame_mp = tr.frame_mp
        if need_kf:
            # _create_keyframe returns the keyframe's own pose: the recorded
            # frame pose must match the reference-KF snapshot taken in
            # _record (Tcr is identity for a frame that spawned a keyframe)
            frame_mp, q_kf, t_kf = self._create_keyframe(feats, tr)
            tr = tr._replace(q=q_kf, t=t_kf)

        self.last_q, self.last_t = tr.q, tr.t
        self.last_feats = feats
        self.last_frame_mp = frame_mp
        self._record(lost=False)
        return self.last_q, self.last_t

    # -- localization-only mode (mbOnlyTracking) -----------------------------

    def set_localization_mode(self, on: bool):
        """ActivateLocalizationMode / DeactivateLocalizationMode: in
        localization mode the map is frozen (no keyframes, no new map
        points, no local BA) and tracking adds temporal VO points,
        unprojected from the last frame's depth, to the motion model; the
        reference keyframe follows the frame (best_covisible_kf), as the
        reference's UpdateLocalKeyFrames moves it.

        Leaving the mode, the last frame it tracked becomes a keyframe
        where NeedNewKeyFrame (_need_new_keyframe, on that frame's local-map
        counts) asks for one and the frame was tracked on the map, not on
        VO points (ROADMAP.md, fault 13). The mode held back every
        keyframe, so the map ends where the mode began; a camera that went
        on past it finds too few of the map's points on the first frame out
        of the mode (on the corridor 5 m past the last keyframe: 23
        local-map inliers against the 30 tracking needs, the reference's
        threshold too), loses track and resets a young map. The keyframe
        maps the place the camera is at, and tracking goes on from it.
        Neither the JAX package nor the C++ reference does this: the
        reference's NeedNewKeyFrame declines in the mode and its next frame
        out of it is tracked against the old map, as the JAX package's;
        the JAX package's reference keyframe stays the last keyframe made."""
        leaving = self.only_tracking and not on
        was_vo = self.vo
        self.only_tracking = on
        if not on:
            self.vo = False
            self.last_vo_pw = None
            self.last_vo_mask = None
        # _last_decision is the last frame's only when its local map ran
        if leaving and self.state == TrackerState.OK and not was_vo \
                and self._last_decision is not None \
                and self._need_new_keyframe(self.last_feats, None):
            tr = steps.TrackResult(self.last_q, self.last_t,
                                   self.last_frame_mp, None)
            self.last_frame_mp, self.last_q, self.last_t = \
                self._create_keyframe(self.last_feats, tr)

    def _track_localization_only(self, feats, q_pred, t_pred):
        """One frame in localization mode. The host reads the device twice
        on a frame that tracks: the motion model's [n_inliers,
        n_map_inliers, best covisible keyframe] in one fetch (one more when
        the wide-window retry runs) and the local map's inlier count with
        NeedNewKeyFrame's counters (the decision vector, read when the mode
        is left); _record reads once more."""
        sh = self.shared
        F = self.cfg.caps.max_features
        tcfg = self.cfg.tracking
        if self.last_vo_pw is None:
            self.last_vo_pw = torch.zeros((F, 3), device=self.device)
            self.last_vo_mask = torch.zeros((F,), dtype=torch.bool,
                                            device=self.device)

        def motion_model(radius_mult):
            tr = steps.track_motion_model_vo_step(
                sh.state, feats, self.last_feats, self.last_frame_mp,
                self.last_vo_pw, self.last_vo_mask, q_pred, t_pred, self.cfg,
                radius_mult=radius_mult)
            return tr, host_fetch(torch.stack([
                tr.n_inliers.to(torch.int64), tr.n_map_inliers.to(torch.int64),
                steps.best_covisible_kf(sh.state, tr.frame_mp)]))

        tr, (n_in, n_map, best_kf) = motion_model(1.0)
        if n_in < tcfg.min_matches_motion_model:
            tr, (n_in, n_map, best_kf) = motion_model(2.0)
        ok = n_in >= 10      # the reference's 20 counts VO matches too
        # mbVO: fewer than 10 matches to real map points
        self.vo = bool(n_map < 10)
        frame_mp = tr.frame_mp
        q_cur, t_cur = tr.q, tr.t
        if ok and not self.vo:
            # TrackLocalMap: the local map around the keyframe that shares
            # the most points with the frame, which becomes the reference
            if best_kf >= 0:
                self.ref_kf = int(best_kf)
            tr2, new_state = steps.track_local_map_step(
                sh.state, feats, tr.q, tr.t, tr.frame_mp, self.ref_kf,
                self.cfg)
            sh.state = new_state
            decision = host_fetch(torch.cat([
                torch.ones(1, dtype=torch.int32, device=self.device),
                tr2.n_inliers.to(torch.int32).reshape(1),
                steps.keyframe_counters(
                    sh.state, feats, tr2.frame_mp, self.ref_kf,
                    sh.n_kf_in_map(self.map_id) > 2, self.cfg)]))
            if int(decision[1]) >= tcfg.min_inliers_track_local_map:
                q_cur, t_cur, frame_mp = tr2.q, tr2.t, tr2.frame_mp
                self._last_decision = decision
            else:
                ok = False

        if not ok:
            self.state = TrackerState.LOST
            self.last_q, self.last_t = q_pred, t_pred
            self.last_feats = feats
            self.last_frame_mp = self._no_matches()
            self.last_vo_pw = None
            self.last_vo_mask = None
            self._record(lost=True)
            return None

        self.state = TrackerState.OK
        if self.last_q is not None:
            self.vel_q, self.vel_t = se3.relative(q_cur, t_cur, self.last_q,
                                                  self.last_t)
            self.has_velocity = True
        self.last_q, self.last_t = q_cur, t_cur
        self.last_feats = feats
        self.last_frame_mp = frame_mp
        if self.cfg.sensor != Sensor.MONOCULAR:
            self.last_vo_pw, self.last_vo_mask = steps.make_vo_points(
                sh.state, feats, frame_mp, q_cur, t_cur, self.cfg)
        self._record(lost=False)
        return self.last_q, self.last_t

    # -- internals ---------------------------------------------------------

    def _no_matches(self):
        return torch.full((self.cfg.caps.max_features,), ms.NONE,
                          dtype=torch.int32, device=self.device)

    def _initialize(self, feats) -> bool:
        if self.cfg.sensor == Sensor.MONOCULAR:
            return self._initialize_mono(feats)
        # the reference requires 500 keypoints; scaled-down test scenes use
        # smaller budgets, so gate on usable depth instead
        n_depth = int(host_fetch(torch.sum(feats.valid & (feats.depth > 0))))
        if n_depth < 100:
            return False
        sh = self.shared
        kf_slot = sh.alloc_kf(self.map_id, self.agent)
        sh.state, frame_mp, n_new = steps.stereo_init_step(
            sh.state, feats, self.frame_id, self.agent, self.map_id,
            kf_slot, sh.mp_base(), self.cfg)
        sh.commit_mp(int(host_fetch(n_new)))
        self.state = TrackerState.OK
        self.last_q = se3.quat_identity(device=self.device)
        self.last_t = torch.zeros(3, device=self.device)
        self.last_feats = feats
        self.last_frame_mp = frame_mp
        self.ref_kf = kf_slot
        self.last_kf_frame = self.frame_id
        self.new_kf_slots.append(kf_slot)
        return True

    def _initialize_mono(self, feats) -> bool:
        """Two-view monocular bootstrap (MonocularInitialization +
        SearchForInitialization): window matching against a stored
        reference frame, the H / F RANSAC, the initial two-keyframe map with
        median-depth normalization, and a 20-iteration global BA (K2 and
        K3). Host reads: the feature count, the match count, the two-view
        verdict and the point count, plus the SVDs' own waits
        (geometry/twoview.py)."""
        n_feat = int(host_fetch(torch.sum(feats.valid)))
        ref = self.mono_init_ref
        if ref is None or n_feat < 100:
            if n_feat >= 100:
                self.mono_init_ref = (feats, self.frame_id)
            return False
        ref_feats, ref_frame_id = ref

        res = matchers.match_window(
            feats, ref_feats.desc, ref_feats.valid, ref_feats.xy,
            radius=100.0, th=self.cfg.matcher.th_low, nn_ratio=0.9)
        _, res = matchers.resolve_conflicts(res, self.cfg.caps.max_features)
        n_matches = int(host_fetch(torch.sum(res.ok)))
        if n_matches < 100:
            self.mono_init_ref = (feats, self.frame_id)  # as the reference
            return False

        F = self.cfg.caps.max_features
        ok = res.ok
        cur_idx = res.best_feat.long().clamp(0, F - 1)
        samples = self.draw_twoview_samples(ok, 200, self.frame_id)
        tv = twoview.initialize_two_view(ref_feats.xy, feats.xy[cur_idx], ok,
                                         self.cfg.camera, samples)
        if not bool(host_fetch(tv.ok)):
            return False

        sh = self.shared
        kf0 = sh.alloc_kf(self.map_id, self.agent)
        kf1 = sh.alloc_kf(self.map_id, self.agent)
        sh.state, frame_mp, scale, n_pts = steps.mono_init_map_step(
            sh.state, ref_feats, feats, tv.q, tv.t, tv.points,
            tv.inliers & ok, torch.arange(F, dtype=torch.int32,
                                          device=self.device),
            cur_idx, ref_frame_id, self.frame_id, self.agent, self.map_id,
            kf0, kf1, sh.mp_base(), self.cfg)
        n_pts = int(host_fetch(n_pts))
        sh.commit_mp(n_pts)
        if n_pts < 80:
            # as the JAX package: the two keyframes stay in the map
            return False

        # initial global BA (the reference's 20 iterations)
        sh.state = lc.global_bundle_adjustment(sh.state, self.cfg, n_iters=20)

        self.state = TrackerState.OK
        self.last_q = sh.state.kf_q[kf1]
        self.last_t = sh.state.kf_t[kf1]
        self.last_feats = feats
        self.last_frame_mp = sh.state.kf_mp[kf1]
        self.ref_kf = kf1
        self.last_kf_frame = self.frame_id
        self.new_kf_slots += [kf0, kf1]
        self.mono_init_ref = None
        return True

    def _predict_pose(self):
        if self.has_velocity:
            return se3.compose(self.vel_q, self.vel_t, self.last_q, self.last_t)
        return self.last_q, self.last_t

    def _need_new_keyframe(self, feats, tr) -> bool:
        """Reference NeedNewKeyFrame, without the mapping-idle conditions
        (phases are synchronous here). All device counters come pre-packed
        in the decision vector ([ok, n_inliers, tracked_close,
        untracked_close, ref_kf_matches]) of track_frame_step or of a
        localization-mode frame: no device reads here."""
        tcfg = self.cfg.tracking
        frames_since = self.frame_id - self.last_kf_frame
        dec = self._last_decision
        n_in = int(dec[1])
        tracked_close = int(dec[2])
        untracked_close = int(dec[3])
        ref_matches = int(dec[4])
        need_close = tracked_close < 100 and untracked_close > 70

        c1a = frames_since >= tcfg.max_frames_between_kf
        c1c = self.cfg.sensor != Sensor.MONOCULAR and \
            (n_in < ref_matches * 0.25 or need_close)
        c2 = (n_in < ref_matches * 0.75 or need_close) and n_in > 15
        return bool(c1a or ((c1c or frames_since >= tcfg.min_frames_between_kf)
                            and c2))

    def _create_keyframe(self, feats, tr):
        """KF insert + triangulation + local mapping + local BA + culling
        (steps.keyframe_pipeline_step) with three device fetches: the
        neighbour list inside the step, the new-point count and, when local
        BA ran, the cull report."""
        sh = self.shared
        kf_slot = sh.alloc_kf(self.map_id, self.agent)
        run_ba = bool(self.run_local_ba and sh.n_kf_in_map(self.map_id) >= 3)
        (sh.state, frame_mp, q_kf, t_kf, n_new,
         cull_vec) = steps.keyframe_pipeline_step(
            sh.state, feats, tr.q, tr.t, tr.frame_mp, self.frame_id,
            self.agent, self.map_id, kf_slot, sh.mp_base(), self.cfg,
            run_ba, sh.kf_agent_seq)
        n_comp = sh.n_compactions
        sh.commit_mp(int(host_fetch(n_new)))
        if sh.n_compactions != n_comp:
            # commit triggered a point compaction, which permuted every
            # point slot; the frame_mp row from the PRE-compaction state
            # would feed stale ids into the next frame's motion model
            frame_mp = sh.state.kf_mp[kf_slot]
        self.ref_kf = kf_slot
        self.last_kf_frame = self.frame_id
        self.new_kf_slots.append(kf_slot)
        if run_ba:
            for row in host_fetch(cull_vec):
                slot = int(row[0])
                if slot < 0:
                    continue
                parent = int(row[1])
                self.culled_kf_slots.append(slot)
                sh.note_culled(slot, parent if parent >= 0 else None,
                               row[2:6].copy(), row[6:9].copy())
        return frame_mp, q_kf, t_kf

    def _record(self, lost: bool):
        """Append the per-frame trajectory record with ONE device fetch: a
        single [14] snapshot of the frame pose and the reference keyframe's
        pose."""
        ref_uid = -1
        has_q = self.last_q is not None
        dev = self.device
        q_now = self.last_q if has_q else se3.quat_identity(device=dev)
        t_now = self.last_t if has_q else torch.zeros(3, device=dev)
        if self.ref_kf >= 0:
            st = self.shared.state
            ref_uid = int(self.shared.kf_uid[self.ref_kf])
            snap = host_fetch(torch.cat([
                q_now, t_now, st.kf_q[self.ref_kf], st.kf_t[self.ref_kf]]))
            q, t = snap[:4], snap[4:7]
            ref_q, ref_t = snap[7:11], snap[11:14]
        else:
            if has_q:
                snap = host_fetch(torch.cat([q_now, t_now]))
                q, t = snap[:4], snap[4:7]
            else:
                q, t = np.array([1.0, 0, 0, 0]), np.zeros(3)
            ref_q = ref_t = None
        self.trajectory.append(FrameRecord(
            frame_id=self.frame_id, q=q, t=t,
            lost=lost, ref_kf=self.ref_kf, ref_uid=ref_uid,
            ref_q=ref_q, ref_t=ref_t))

    @torch.no_grad()
    def reset(self):
        """Tracking::Reset (src/Tracking.cc:1522-1572): drop this agent's
        map content and restart from NOT_INITIALIZED. The JAX package leaves
        the state as it was (a LOST tracker stays LOST after the auto-reset,
        and its own test_auto_reset_when_lost_early fails); the port follows
        the reference."""
        self.n_resets += 1
        sh = self.shared
        st = sh.state
        mine_kf = (st.kf_agent == self.agent) & st.kf_valid
        mine_mp = (st.mp_agent == self.agent) & st.mp_valid
        for k in np.nonzero(host_fetch(mine_kf))[0]:
            self.culled_kf_slots.append(int(k))
            sh.note_invalidated(int(k))
        st = st._replace(
            kf_valid=st.kf_valid & ~mine_kf,
            kf_feat_valid=st.kf_feat_valid & ~mine_kf[:, None],
            kf_mp=torch.where(mine_kf[:, None],
                              torch.full_like(st.kf_mp, ms.NONE), st.kf_mp),
            mp_valid=st.mp_valid & ~mine_mp)
        st = mapping.rebuild_observations(st)
        st = steps.recompute_covisibility(st)
        sh.state = st
        # pre-reset frame records are unrecoverable: their reference
        # keyframes were just invalidated, so they drop out of the export
        for rec in self.trajectory:
            rec.lost = True
        self.last_q = None
        self.last_t = None
        self.last_feats = None
        self.last_frame_mp = None
        self.has_velocity = False
        self.ref_kf = -1
        self.mono_init_ref = None
        self.state = TrackerState.NOT_INITIALIZED
        self.new_kf_slots.clear()
        if self.on_reset is not None:
            self.on_reset(self)

    # -- trajectory export (System::SaveTrajectory*) -------------------------

    def export_poses(self):
        """Re-chained camera poses for every recorded frame: each frame's
        pose is its track-time pose RELATIVE to its reference keyframe,
        re-anchored on that keyframe's CURRENT pose; if the reference
        keyframe was culled, the relative pose is chained through the
        spanning tree via the snapshots taken at cull time. Chains are keyed
        by keyframe UID, not slot.
        Returns [(frame_id, lost, q_cw, t_cw)].
        """
        sh = self.shared
        st = sh.state
        kf_valid = st.kf_valid.cpu().numpy()
        kf_q = st.kf_q.cpu().numpy()
        kf_t = st.kf_t.cpu().numpy()
        cull_info = sh.cull_info
        out = []
        # frames whose reference-KF chain dead-ends fall back to raw
        # track-time poses; counted so degraded exports are visible
        self.export_fallbacks = 0
        for rec in self.trajectory:
            q_cw, t_cw = rec.q, rec.t
            if rec.ref_kf >= 0 and rec.ref_q is not None:
                # T_frame<-ref at track time
                rel_q, rel_t = _np_relative(rec.q, rec.t, rec.ref_q, rec.ref_t)
                uid = rec.ref_uid
                ok = True
                while uid not in sh.uid_slot:
                    info = cull_info.get(uid)
                    if info is None:
                        ok = False
                        self.export_fallbacks += 1
                        break
                    parent_uid, cq, ct = info
                    rel_q, rel_t = _np_compose(rel_q, rel_t, cq, ct)
                    uid = parent_uid
                if ok:
                    k = sh.uid_slot[uid]
                    if kf_valid[k]:
                        q_cw, t_cw = _np_compose(rel_q, rel_t, kf_q[k],
                                                 kf_t[k])
                    else:
                        self.export_fallbacks += 1
            out.append((rec.frame_id, rec.lost, q_cw, t_cw))
        return out

    def trajectory_tum(self, timestamps=None):
        """TUM format rows: t tx ty tz qx qy qz qw (camera-to-world).
        Lost frames are skipped as in the reference."""
        rows = []
        for frame_id, lost, q_cw_, t_cw_ in self.export_poses():
            if lost:
                continue
            ts = (timestamps[frame_id] if timestamps is not None
                  and 0 <= frame_id < len(timestamps) else float(frame_id))
            q_wc, t_wc = _np_inverse(_np_normalize(q_cw_), t_cw_)
            rows.append((ts, *t_wc, q_wc[1], q_wc[2], q_wc[3], q_wc[0]))
        return rows


# -- tiny numpy SE3 helpers (export-time; no device round trips) ------------

def _np_normalize(q):
    q = np.asarray(q, np.float64)
    q = q / max(np.linalg.norm(q), 1e-12)
    return -q if q[0] < 0 else q


def _np_qmul(a, b):
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                     w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                     w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                     w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2])


def _np_qrot(q, v):
    uv = np.cross(q[1:], v)
    uuv = np.cross(q[1:], uv)
    return np.asarray(v) + 2.0 * (q[0] * uv + uuv)


def _np_compose(qa, ta, qb, tb):
    """T_a * T_b."""
    return _np_normalize(_np_qmul(qa, qb)), _np_qrot(qa, np.asarray(tb)) + ta


def _np_inverse(q, t):
    qi = np.array([q[0], -q[1], -q[2], -q[3]])
    return qi, -_np_qrot(qi, np.asarray(t))


def _np_relative(qa, ta, qb, tb):
    """T_a * T_b^-1."""
    qbi, tbi = _np_inverse(np.asarray(qb, np.float64),
                           np.asarray(tb, np.float64))
    return _np_compose(np.asarray(qa, np.float64),
                       np.asarray(ta, np.float64), qbi, tbi)
