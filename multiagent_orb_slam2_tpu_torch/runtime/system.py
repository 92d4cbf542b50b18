"""Per-agent System facade: tracking + loop closing + relocalization +
trajectory export + checkpointing.

Counterpart of the JAX package's ``runtime/system.py`` (reference System).
Stereo, RGB-D and monocular tracking with local bundle adjustment and
keyframe culling, localization-only mode, loop closing with its keyframe
database and global bundle adjustment (on by default, as in the JAX
package), relocalization of a LOST tracker through that database
(``runtime/reloc.py``), the trajectory writers and map checkpoints in the
JAX package's file layout.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import SlamConfig
from ..io import trajectory as traj_mod
from ..mapstate import checkpoint as ckpt
from ..ops import frame as frame_mod
from ..vocab import bow as bow_mod
from ..vocab import kfdb as kfdb_mod
from . import loop_closing as lc
from . import mapping
from . import reloc as reloc_mod
from .tracker import (SharedMap, Tracker, TrackerState, _np_inverse,
                      _np_normalize)


class System:
    """Single-agent SLAM engine.

    With a vocabulary (``vocab.bow.load_vocabulary()`` reads the committed
    asset), every keyframe is registered in the keyframe database and, with
    loop closing on (the default), queried for loops; a verified loop is
    corrected and followed by a global BA (``run_gba``); a LOST tracker is
    relocalized against the database on every frame until it recovers.
    Without one (``System(cfg, None, enable_loop_closing=False)``) there is
    no keyframe database: nothing is registered, culled slots are reusable
    at once, and a tracker that gets LOST stays LOST (it dead-reckons on the
    motion model). Loop closing without a vocabulary raises ValueError.
    """

    def __init__(self, cfg: SlamConfig, vocab: Optional[bow_mod.Vocabulary],
                 shared: Optional[SharedMap] = None, agent: int = 0,
                 enable_loop_closing: bool = True, run_gba: bool = True,
                 device=torch.device("cuda")):
        if vocab is None and enable_loop_closing:
            raise ValueError(
                "loop closing needs a vocabulary (vocab.bow.load_vocabulary() "
                "reads the committed one), or pass enable_loop_closing=False")
        self.cfg = cfg
        self.vocab = vocab
        self.device = torch.device(device)
        self.shared = shared or SharedMap(cfg, device=self.device)
        self.tracker = Tracker(cfg, self.shared, agent=agent, map_id=agent,
                               device=self.device)
        self.loop_closer = (lc.LoopCloser(cfg, vocab) if vocab is not None
                            else None)
        self.enable_loop_closing = enable_loop_closing
        self.run_gba = run_gba
        self.n_relocalizations = 0

    # -- tracking entry points (reference System::Track*) ------------------

    def track_stereo(self, left, right, frame_id=None):
        feats = frame_mod.extract_frame(left, self.cfg, right_img=right,
                                        device=self.device)
        return self._track(feats, frame_id)

    def track_rgbd(self, img, depth, frame_id=None):
        feats = frame_mod.extract_frame(img, self.cfg, depth_map=depth,
                                        device=self.device)
        return self._track(feats, frame_id)

    def track_mono(self, img, frame_id=None):
        feats = frame_mod.extract_frame(img, self.cfg, device=self.device)
        return self._track(feats, frame_id)

    def activate_localization_mode(self):
        """Freeze mapping and track only (ActivateLocalizationMode)."""
        self.tracker.set_localization_mode(True)

    def deactivate_localization_mode(self):
        self.tracker.set_localization_mode(False)

    def _track(self, feats, frame_id):
        """Track one frame, relocalize if the tracker is LOST (with a
        keyframe database), then drain the keyframe queues."""
        out = self.tracker.track_features(feats, frame_id)
        if self.tracker.state == TrackerState.LOST and self._relocalize(feats):
            out = (self.tracker.last_q, self.tracker.last_t)
        self._process_keyframes()
        return out

    def _process_keyframes(self):
        """Drain the tracker's keyframe queues: erase culled keyframes from
        the database, after which their slots are reusable; then register
        each new keyframe (loop closing off) or run loop detection on it and
        correct a verified loop. Without a database culled slots are
        reusable at once and new keyframes need no registration."""
        lcl = self.loop_closer
        if self.tracker.culled_kf_slots:
            if lcl is not None:
                for k in self.tracker.culled_kf_slots:
                    lcl.db = kfdb_mod.erase_keyframe(lcl.db, k)
            self.tracker.culled_kf_slots.clear()
            self.shared.reclaim_slots()
        while self.tracker.new_kf_slots:
            kf_slot = self.tracker.new_kf_slots.pop(0)
            if lcl is None:
                continue
            if not self.enable_loop_closing:
                # registered all the same, for relocalization
                st = self.shared.state
                lcl.db, _, _ = kfdb_mod.add_keyframe(
                    lcl.db, self.vocab, kf_slot, st.kf_desc[kf_slot],
                    st.kf_feat_valid[kf_slot])
                continue
            match = lcl.process_keyframe(self.shared, kf_slot)
            if match is not None:
                lcl.correct_loop(self.shared, match, run_gba=self.run_gba)

    # -- relocalization (Tracking::Relocalization) -------------------------

    def _relocalize(self, feats) -> bool:
        if self.loop_closer is None:
            return False
        ok = reloc_mod.relocalize(self.tracker, self.loop_closer.db,
                                  self.vocab, feats, self.cfg)
        if ok:
            self.n_relocalizations += 1
        return ok

    # -- export / checkpoint -------------------------------------------------

    def save_trajectory_tum(self, path, timestamps=None):
        traj_mod.write_tum(path, self.tracker.trajectory_tum(timestamps))

    def save_trajectory_kitti(self, path):
        """KITTI format: every frame, re-chained through its reference KF."""
        qs, ts = [], []
        for _, _, q_cw, t_cw in self.tracker.export_poses():
            q_wc, t_wc = _np_inverse(_np_normalize(q_cw), t_cw)
            qs.append(q_wc)
            ts.append(t_wc)
        mats = traj_mod.poses_to_matrices(np.stack(qs), np.stack(ts))
        traj_mod.write_kitti(path, mats[:, :3])

    def save_keyframe_trajectory_tum(self, path, timestamps=None):
        st = self.shared.state
        kf_valid = st.kf_valid.cpu().numpy()
        kf_q = st.kf_q.cpu().numpy()
        kf_t = st.kf_t.cpu().numpy()
        kf_fid = st.kf_frame_id.cpu().numpy()
        rows = []
        for k in np.nonzero(kf_valid)[0]:
            fid = int(kf_fid[k])
            ts = timestamps[fid] if timestamps is not None else float(fid)
            q_wc, t_wc = _np_inverse(kf_q[k].astype(np.float64),
                                     kf_t[k].astype(np.float64))
            rows.append((ts, *t_wc, q_wc[1], q_wc[2], q_wc[3], q_wc[0]))
        traj_mod.write_tum(path, rows)

    def save_map(self, path):
        """The map and the host's slot counters in the JAX package's npz
        layout. n_created persists, so a restored session never reissues
        the uid of a keyframe culled before the save."""
        ckpt.save_map(path, self.shared.state, self.shared.n_kf,
                      self.shared.n_mp,
                      extra={"n_created": self.shared.n_created})

    def load_map(self, path):
        """Restore a map saved by either package. The slot tables are
        rebuilt from the persisted kf_seq column, the cull chains of the old
        session are dropped, and every restored keyframe is registered in
        the keyframe database again."""
        state, meta = ckpt.load_map(path, self.device)
        sh = self.shared
        sh.state = state
        sh.n_kf = meta["n_kf"]
        sh.n_mp = meta["n_mp"]
        seq = state.kf_seq.cpu().numpy()
        valid = state.kf_valid.cpu().numpy()
        sh.kf_uid[:] = -1
        sh.kf_uid[: len(seq)] = seq
        sh.kf_map_of[:] = -1
        sh.kf_map_of[: len(seq)] = np.where(valid,
                                            state.kf_map.cpu().numpy(), -1)
        sh.uid_slot = {int(seq[k]): int(k)
                       for k in np.nonzero(valid & (seq >= 0))[0]}
        floor = int(seq.max()) + 1 if (seq >= 0).any() else 0
        sh.n_created = max(floor, int(meta.get("n_created", 0)))
        # one tracker continues the restored map: the creation uids are its
        # ordinals, and its next keyframes follow them
        agent = self.tracker.agent
        sh.kf_agent_seq = torch.where(
            state.kf_seq >= 0, state.kf_seq + agent * mapping.AGENT_SEQ_STRIDE,
            state.kf_seq)
        sh.n_created_of = {agent: sh.n_created}
        sh.free_kf = [int(k) for k in range(sh.n_kf) if not valid[k]]
        sh.pending_release = []
        # cull chains and trajectories belong to the session before the
        # restore: dropping them keeps a reissued-looking uid from re-chaining
        # an exported frame onto an unrelated keyframe
        sh.cull_info = {}
        if self.loop_closer is not None:
            lcl = self.loop_closer
            for k in np.nonzero(valid)[0]:
                lcl.db, _, _ = kfdb_mod.add_keyframe(
                    lcl.db, self.vocab, int(k), state.kf_desc[int(k)],
                    state.kf_feat_valid[int(k)])

    def shutdown(self):
        self._process_keyframes()
