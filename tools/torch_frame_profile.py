#!/usr/bin/env python3
"""Where a tracked frame's time goes in the PyTorch / CUDA port.

    python3 tools/torch_frame_profile.py [--frames 14] [--profiled 4] [--trace FILE]

Runs the port's main path (System.track_stereo, full KITTI-shaped width, the
configuration of chip_smoke.py) on a rendered corridor, and traces the last
`--profiled` frames with torch.profiler. Prints one JSON object: wall time
per frame without the profiler (median of the frames before the traced
window; tracing itself slows the host several times over), the card's busy
time per frame (sum of kernel durations in the traced window), the idle
share that follows from the two, the number of kernels launched per frame,
and the kernels and host operators that take the most time. Needs one CUDA
device; --trace FILE also writes the chrome trace there (tens of MB).
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402  (configuration, camera, profile summary)
from multiagent_orb_slam2_tpu_torch.io import synthetic  # noqa: E402
from multiagent_orb_slam2_tpu_torch.runtime import steps  # noqa: E402
from multiagent_orb_slam2_tpu_torch.runtime import system as system_mod  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=14)
    ap.add_argument("--profiled", type=int, default=4)
    ap.add_argument("--trace", metavar="FILE", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    cam, cfg = chip_smoke.CAM, chip_smoke.CFG
    scene = synthetic.BoxScene(seed=0, z_far=60.0)
    q, t = synthetic.corridor_trajectory(args.frames, step=0.25)
    frames = [scene.render_stereo(cam, q[i], t[i])[:2]
              for i in range(args.frames)]
    system = system_mod.System(cfg, None, enable_loop_closing=False)
    first = args.frames - args.profiled
    plain_ms = []
    for i in range(first):
        n_kf = system.shared.n_kf
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        system.track_stereo(*frames[i], frame_id=i)
        torch.cuda.synchronize()
        if i >= 2 and system.shared.n_kf == n_kf:   # warm, no keyframe
            plain_ms.append((time.perf_counter() - t0) * 1e3)
    wall_ms = statistics.median(plain_ms)
    n_kf_before = system.shared.n_kf
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(first, args.frames):
            system.track_stereo(*frames[i], frame_id=i)
        torch.cuda.synchronize()
    traced_wall_ms = (time.perf_counter() - t0) * 1e3 / args.profiled
    out = {"card": card, "frames_profiled": args.profiled,
           "keyframes_in_window": system.shared.n_kf - n_kf_before,
           "wall_ms_per_frame_untraced_median": wall_ms,
           "wall_ms_per_frame_traced": traced_wall_ms}
    out.update(chip_smoke.summarize(prof, args.profiled, wall_ms, "frame"))
    print(json.dumps(out))
    if args.trace:
        prof.export_chrome_trace(args.trace)

    # second window: one local bundle adjustment (what a keyframe adds once
    # the map has three), on the map as it stands; its result is dropped
    state, center = system.shared.state, system.tracker.ref_kf
    ba_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps.local_ba_step(state, center, cfg)
        torch.cuda.synchronize()
        ba_ms.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        steps.local_ba_step(state, center, cfg)
        torch.cuda.synchronize()
    out = {"card": card, "window": "one local_ba_step (5 + 10 LM iterations)",
           "keyframes_in_map": int(state.kf_valid.sum()),
           "wall_ms_untraced_median": statistics.median(ba_ms)}
    out.update(chip_smoke.summarize(prof, 1, out["wall_ms_untraced_median"],
                                    "call"))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
