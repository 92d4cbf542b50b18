"""Per-agent System facade: tracking + loop closing + trajectory export.

Counterpart of the JAX package's ``runtime/system.py`` (reference System).
Ported: stereo tracking with local bundle adjustment and keyframe culling,
loop closing with its keyframe database and global bundle adjustment (on by
default, as in the JAX package), and the trajectory writers.
Relocalization, RGB-D and monocular entry points and map checkpoints raise
NotImplementedError naming their ROADMAP.md item. A tracker that gets LOST
stays LOST (it dead-reckons on the motion model): the JAX ``System._track``
calls ``_relocalize`` there, which is not ported.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import SlamConfig
from ..io import trajectory as traj_mod
from ..ops import frame as frame_mod
from ..vocab import bow as bow_mod
from ..vocab import kfdb as kfdb_mod
from . import loop_closing as lc
from .tracker import (SharedMap, Tracker, _np_inverse, _np_normalize)


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported yet: ROADMAP.md queue 1 item {item}")


class System:
    """Single-agent SLAM engine.

    With a vocabulary (``vocab.bow.load_vocabulary()`` reads the committed
    asset), every keyframe is registered in the keyframe database and, with
    loop closing on (the default), queried for loops; a verified loop is
    corrected and followed by a global BA (``run_gba``). Without one
    (``System(cfg, None, enable_loop_closing=False)``) there is no keyframe
    database: nothing is registered and culled slots are reusable at once.
    Loop closing without a vocabulary raises ValueError.
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
        raise _not_ported("System.track_rgbd",
                          "13, 'Mono, RGB-D and relocalization'")

    def track_mono(self, img, frame_id=None):
        raise _not_ported("System.track_mono",
                          "13, 'Mono, RGB-D and relocalization'")

    def activate_localization_mode(self):
        self.tracker.set_localization_mode(True)

    def deactivate_localization_mode(self):
        self.tracker.set_localization_mode(False)

    def _track(self, feats, frame_id):
        """Track one frame, then drain the keyframe queues. The JAX System
        calls ``_relocalize`` when the tracker is LOST; relocalization is
        not ported (ROADMAP.md queue 1 item 13), so a LOST tracker stays
        LOST here."""
        out = self.tracker.track_features(feats, frame_id)
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

    # -- export -------------------------------------------------------------

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
        raise _not_ported("System.save_map",
                          "15, 'Tail' (mapstate/checkpoint.py)")

    def load_map(self, path):
        raise _not_ported("System.load_map",
                          "15, 'Tail' (mapstate/checkpoint.py)")

    def shutdown(self):
        self._process_keyframes()
