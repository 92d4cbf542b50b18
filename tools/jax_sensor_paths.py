"""The JAX package's values for chip_smoke.py's RGB-D, monocular and
localization-only paths, on the CPU.

    JAX_PLATFORMS=cpu python tools/jax_sensor_paths.py [--frames 60]

Renders the KITTI-shaped corridor chip_smoke.py drives (BoxScene seed 0,
z_far 60, corridor_trajectory step 0.25; 1241x376, 2000 ORB features,
Capacities(64, 32768, 2048, 8192)) and runs the JAX package over it:

- RGB-D: a Tracker on the left images and the renderer's exact depth
  (what chip_smoke.py's System(..., None, enable_loop_closing=False) runs:
  no keyframe database); ATE without alignment, frames lost, keyframes.
- Mono: System(cfg, the committed vocabulary) on the left images; the
  initialization frame, frames lost after it, keyframes created, the
  scale-free ATE (Umeyama with scale over the tracked frames).
- Localization-only: a stereo Tracker maps frames 0-29, tracks 30-49 in
  localization mode and 50-59 out of it; keyframe and point counts before
  and after the mode, frames in VO, frames lost, the ATE of frames 30-49
  and of all frames, keyframes created in 50-59.

Prints one JSON object per path. chip_smoke.py prints these values beside
its own gates (JAX_RGBD_*, JAX_MONO_*, JAX_LOC_*); nothing gates on them.
One process, a few GB of memory; about 15-30 minutes on a CPU.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402

from multiagent_orb_slam2_tpu.config import (Capacities, OrbConfig,  # noqa
                                             Sensor, SlamConfig,
                                             TrackingConfig)
from multiagent_orb_slam2_tpu.drivers import common  # noqa: E402
from multiagent_orb_slam2_tpu.geometry.camera import Intrinsics  # noqa
from multiagent_orb_slam2_tpu.io import synthetic  # noqa: E402
from multiagent_orb_slam2_tpu.io import trajectory as traj  # noqa: E402
from multiagent_orb_slam2_tpu.runtime.system import System  # noqa: E402
from multiagent_orb_slam2_tpu.runtime.tracker import (SharedMap,  # noqa
                                                      Tracker)
from multiagent_orb_slam2_tpu.vocab import bow  # noqa: E402

CAM = Intrinsics(fx=718.9, fy=718.9, cx=620.5, cy=188.0, bf=386.1,
                 width=1241, height=376)
CFG = SlamConfig(
    camera=CAM, sensor=Sensor.STEREO,
    orb=OrbConfig(n_features=2000),
    tracking=TrackingConfig(max_frames_between_kf=10, th_depth=35.0),
    caps=Capacities(max_keyframes=64, max_points=32768, max_features=2048,
                    local_points=8192))
LOC_MAP, LOC_END = 30, 50


def centres(records):
    """Camera centres of trajectory records (track-time poses)."""
    out = []
    for r in records:
        q = np.asarray(r.q, np.float64)
        q = q / np.linalg.norm(q)
        w, x, y, z = q
        R = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
        out.append(-R.T @ np.asarray(r.t, np.float64))
    return np.stack(out)


def rmse(est, gt):
    return float(np.sqrt(np.mean(np.sum((est - gt) ** 2, axis=-1))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--paths", default="rgbd,mono,localization")
    args = ap.parse_args(argv)
    n = args.frames
    scene = synthetic.BoxScene(seed=0, z_far=60.0)
    q_gt, t_gt = synthetic.corridor_trajectory(n, step=0.25)
    t0 = time.perf_counter()
    frames = [scene.render_stereo(CAM, q_gt[i], t_gt[i]) for i in range(n)]
    print(f"rendered {n} frames in {time.perf_counter() - t0:.1f} s",
          flush=True)
    paths = args.paths.split(",")

    if "rgbd" in paths:
        cfg = CFG.replace(sensor=Sensor.RGBD)
        shared = SharedMap(cfg)
        tracker = Tracker(cfg, shared)
        t0 = time.perf_counter()
        for i, (left, _, depth) in enumerate(frames):
            tracker.track_rgbd(left, depth, frame_id=i)
        tr = tracker.trajectory
        print(json.dumps({"path": "rgbd", "frames": n,
                          "lost": [r.frame_id for r in tr[1:] if r.lost],
                          "ate_m": rmse(centres(tr), t_gt),
                          "keyframes_created": shared.n_created,
                          "seconds": time.perf_counter() - t0}), flush=True)

    if "mono" in paths:
        cfg = CFG.replace(sensor=Sensor.MONOCULAR)
        system = System(cfg, bow.load_vocabulary(common.DEFAULT_VOCAB))
        t0 = time.perf_counter()
        for i, (left, _, _) in enumerate(frames):
            system.track_mono(left, frame_id=i)
        tr = system.tracker.trajectory
        lost = [r.lost for r in tr]
        init = lost.index(False) if False in lost else None
        tracked = [r for r in tr if not r.lost]
        ate = (traj.ate(centres(tracked), t_gt[[r.frame_id for r in tracked]],
                        with_scale=True) if len(tracked) >= 3 else None)
        print(json.dumps({
            "path": "mono", "frames": n, "init_frame": init,
            "lost_after_init": ([r.frame_id for r in tr[init:] if r.lost]
                                if init is not None else None),
            "keyframes_created": system.shared.n_created,
            "ate_m_scale_free": ate["rmse"] if ate else None,
            "scale": float(ate["scale"]) if ate else None,
            "seconds": time.perf_counter() - t0}), flush=True)

    if "localization" in paths:
        shared = SharedMap(CFG)
        tracker = Tracker(CFG, shared)
        t0 = time.perf_counter()
        vo = []
        for i, (left, right, _) in enumerate(frames[:LOC_END]):
            if i == LOC_MAP:
                before = (shared.n_kf, shared.n_mp, shared.n_created)
                tracker.set_localization_mode(True)
            tracker.track_stereo(left, right, frame_id=i)
            if i >= LOC_MAP:
                vo.append(bool(tracker.vo))
        after = (shared.n_kf, shared.n_mp, shared.n_created)
        tracker.set_localization_mode(False)
        for i, (left, right, _) in enumerate(frames[LOC_END:], start=LOC_END):
            tracker.track_stereo(left, right, frame_id=i)
        tr = tracker.trajectory
        est = centres(tr)
        print(json.dumps({
            "path": "localization", "frames": n,
            "map_before": before, "map_after": after,
            "vo_frames": int(sum(vo)),
            "lost": [r.frame_id for r in tr[1:] if r.lost],
            "ate_m_localization": rmse(est[LOC_MAP:LOC_END],
                                       t_gt[LOC_MAP:LOC_END]),
            "ate_m": rmse(est, t_gt[:len(est)]),
            "keyframes_after_mode": shared.n_created - after[2],
            "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
