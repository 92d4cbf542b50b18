"""Host-side tracking orchestrator: the Tracking state machine.

Counterpart of the JAX package's ``runtime/tracker.py`` (reference Tracking
thread + the LocalMapping consumer for the synchronous phases). The host
never touches image or descriptor data: it sequences the steps of
``runtime.steps`` and makes the small-scalar decisions (state transitions,
keyframe need, slot allocation).

Ported: the stereo path without local bundle adjustment. Monocular
bootstrap, localization-only mode and local BA raise NotImplementedError
naming their ROADMAP.md item.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import SlamConfig, Sensor
from ..geometry import se3
from ..mapstate import state as ms
from ..ops import frame as frame_mod
from ..utils.torch_ops import fill_at, host_fetch
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
    """

    def __init__(self, cfg: SlamConfig, device=torch.device("cuda")):
        self.cfg = cfg
        self.device = torch.device(device)
        self.state = ms.empty_map_state(cfg, self.device)
        self.n_kf = 0          # slot high-water mark
        self.n_mp = 0
        self.n_created = 0     # total keyframes ever created (uid counter)
        self.kf_uid = np.full(cfg.caps.max_keyframes, -1, np.int64)
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

    def alloc_kf(self) -> int:
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
        self.pending_release.append(slot)

    def note_invalidated(self, slot: int):
        """Keyframe invalidated without chain info (agent reset)."""
        uid = int(self.kf_uid[slot])
        self.uid_slot.pop(uid, None)
        self.pending_release.append(slot)

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
        if run_local_ba:
            raise NotImplementedError(
                "Tracker(run_local_ba=True): " + steps._ROADMAP_BA)
        if cfg.sensor != Sensor.STEREO:
            raise NotImplementedError(
                "only Sensor.STEREO is ported; monocular and RGB-D tracking "
                "are ROADMAP.md queue 1, 'Mono, RGB-D and relocalization'")
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
        self.only_tracking = False
        self.trajectory: list[FrameRecord] = []
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
        raise NotImplementedError(
            "monocular tracking is not ported yet: ROADMAP.md queue 1, "
            "'Mono, RGB-D and relocalization'")

    def track_rgbd(self, img, depth, frame_id: Optional[int] = None):
        raise NotImplementedError(
            "RGB-D tracking is not ported yet: ROADMAP.md queue 1, "
            "'Mono, RGB-D and relocalization'")

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

        if self.state == TrackerState.LOST:
            q_pred, t_pred = self._predict_pose()
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
            # once lost, only relocalization recovers, and that is not
            # ported: dead-reckon so the trajectory stays continuous
            self.last_q, self.last_t = q_pred, t_pred
            self.last_feats = feats
            self.last_frame_mp = self._no_matches()
            self._record(lost=True)
            return None

        # the cascade: motion model -> wide retry -> ref-KF -> local map,
        # with the host's small-scalar decisions packed into a single [5]
        # vector (one device fetch here)
        tr, new_state, decision, aux = steps.track_frame_step(
            sh.state, feats, self.last_feats, self.last_frame_mp,
            self.ref_kf, self.last_q, self.last_t, self.vel_q, self.vel_t,
            self.has_velocity, sh.n_kf > 2, self.cfg)
        q_pred, t_pred, vel_q, vel_t = aux
        decision = host_fetch(decision)
        ok = bool(decision[0])
        sh.state = new_state
        self._last_decision = decision

        if not ok:
            # dead-reckon on the motion model (the reference would
            # relocalize; relocalization is not ported)
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

    def set_localization_mode(self, on: bool):
        if on:
            raise NotImplementedError(
                "localization-only mode (_track_localization_only, VO "
                "points) is not ported yet: ROADMAP.md queue 1, 'Mono, "
                "RGB-D and relocalization'")
        self.only_tracking = False

    # -- internals ---------------------------------------------------------

    def _no_matches(self):
        return torch.full((self.cfg.caps.max_features,), ms.NONE,
                          dtype=torch.int32, device=self.device)

    def _initialize(self, feats) -> bool:
        # the reference requires 500 keypoints; scaled-down test scenes use
        # smaller budgets, so gate on usable depth instead
        n_depth = int(host_fetch(torch.sum(feats.valid & (feats.depth > 0))))
        if n_depth < 100:
            return False
        sh = self.shared
        kf_slot = sh.alloc_kf()
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

    def _predict_pose(self):
        if self.has_velocity:
            return se3.compose(self.vel_q, self.vel_t, self.last_q, self.last_t)
        return self.last_q, self.last_t

    def _need_new_keyframe(self, feats, tr) -> bool:
        """Reference NeedNewKeyFrame, without the mapping-idle conditions
        (phases are synchronous here). All device counters come pre-packed
        in the track_frame_step decision vector ([ok, n_inliers,
        tracked_close, untracked_close, ref_kf_matches]): no device reads
        here."""
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
        """KF insert + triangulation + local mapping
        (steps.keyframe_pipeline_step) with two device fetches: the
        neighbour list inside the step and the new-point count here."""
        sh = self.shared
        kf_slot = sh.alloc_kf()
        (sh.state, frame_mp, q_kf, t_kf, n_new,
         _cull_vec) = steps.keyframe_pipeline_step(
            sh.state, feats, tr.q, tr.t, tr.frame_mp, self.frame_id,
            self.agent, self.map_id, kf_slot, sh.mp_base(), self.cfg,
            False)
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
        """Tracking::Reset: drop this agent's map content. The tracker's
        `state` is left as it is, as in the JAX package: the caller
        re-initialises explicitly."""
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
