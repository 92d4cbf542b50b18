"""Single-agent driver: the reference's mono_* / stereo_* / rgbd_* examples
in one CLI.

Counterpart of the JAX package's ``drivers/run_single.py``, on the port's
``System``: load a dataset, track it frame by frame (stereo, rectified
first when the settings carry LEFT./RIGHT. blocks; RGB-D; monocular),
print the per-frame timing, save the TUM (and, for KITTI, KITTI)
trajectories, the keyframe trajectory and the map. Runs on the CUDA device
unless ``--device`` names another.

  python -m multiagent_orb_slam2_tpu_torch.drivers.run_single \\
      -t stereo_synth -d SEQ -s SEQ/settings.json -o OUT [--max-frames N]
"""
from __future__ import annotations

import argparse
import os

import torch

from ..io import datasets
from ..runtime.system import System
from ..utils import diag
from . import common


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-t", "--type", required=True,
                    choices=sorted(datasets.LOADERS))
    ap.add_argument("-d", "--data", required=True)
    ap.add_argument("-s", "--settings", required=True)
    ap.add_argument("-v", "--vocab", default="")
    ap.add_argument("-o", "--out", default=".")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--no-loop-closing", action="store_true")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def run(argv=None):
    """Track the sequence and write the outputs; returns (System, summary).
    The System is what a caller keeps to go on tracking or to inspect the
    map; ``main`` returns the summary only."""
    args = parse_args(argv)
    device = torch.device(args.device)
    sensor = common.SENSOR_OF[args.type.split("_")[0]]
    cfg = common.metric_depth(common.load_settings(args.settings, sensor))
    seq = datasets.LOADERS[args.type](args.data)
    vocab = common.get_vocabulary(args.vocab, [seq], cfg, device=device)
    rect = common.get_rectifier(args.settings, device)
    sys_ = System(cfg, vocab, enable_loop_closing=not args.no_loop_closing,
                  device=device)

    n = len(seq) if not args.max_frames else min(args.max_frames, len(seq))
    timer = common.FrameTimer(device)
    for i in range(n):
        left, right, depth = seq.load(i)
        with timer:
            if right is not None:
                if rect is not None:
                    left, right = rect(left, right)
                sys_.track_stereo(left, right, frame_id=i)
            elif depth is not None:
                sys_.track_rgbd(left, depth, frame_id=i)
            else:
                sys_.track_mono(left, frame_id=i)
        diag.log_frame(0, i, sys_.tracker, sys_.shared)
    sys_.shutdown()
    timer.report()

    os.makedirs(args.out, exist_ok=True)
    ts = seq.timestamps()[:n]
    sys_.save_trajectory_tum(os.path.join(args.out, "CameraTrajectory.txt"),
                             ts)
    sys_.save_keyframe_trajectory_tum(
        os.path.join(args.out, "KeyFrameTrajectory.txt"), seq.timestamps())
    if "kitti" in args.type:
        sys_.save_trajectory_kitti(
            os.path.join(args.out, "CameraTrajectoryKITTI.txt"))
    sys_.save_map(os.path.join(args.out, "map.npz"))
    print(f"saved trajectories + map to {args.out}")
    sh = sys_.shared
    summary = {
        "frames": n,
        "lost": sum(r.lost for r in sys_.tracker.trajectory),
        "relocalizations": sys_.n_relocalizations,
        "resets": sys_.tracker.n_resets,
        "loops_corrected": (len(sys_.loop_closer.loop_edges)
                            if sys_.loop_closer is not None else 0),
        "keyframes_created": sh.n_created,
        "keyframes_live": len(sh.uid_slot),
    }
    return sys_, summary


def main(argv=None) -> dict:
    return run(argv)[1]


if __name__ == "__main__":
    print(main())
