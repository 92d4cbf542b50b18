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

import chip_smoke  # noqa: E402  (configuration and camera of the smoke run)
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
    out.update(summarize(prof, args.profiled, wall_ms, "frame"))
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
    out.update(summarize(prof, 1, out["wall_ms_untraced_median"], "call"))
    print(json.dumps(out))


# device time summed by kernel family (first match by name): the port's
# three kernels, the compaction of K2's point list, and the matrix products
# of the local BA's assembly
KERNEL_GROUPS = {
    "pose_opt (K1)": ("pose_opt_kernel",),
    "ba_prep (K2)": ("ba_prep_kernel",),
    "ba_prep compaction": ("ba_prep_compact",),
    "pcg (K3)": ("pcg_",),
    "matrix products": ("gemm", "xmma", "splitKreduce"),
}


def summarize(prof, n: int, wall_ms: float, per: str) -> dict:
    """Device busy time, idle share against the untraced wall time, kernel
    count and the largest kernels and host operators of a traced window that
    held `n` units (frames or calls)."""
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "device_time_total", None) or \
            getattr(e, "cuda_time_total", 0.0)

    kernels = [e for e in events if dev_us(e) > 0 and
               getattr(e, "device_type", None) is not None and
               "cuda" in str(e.device_type).lower()]
    if not kernels:   # older profiler builds: fall back to self device time
        kernels = [e for e in events
                   if getattr(e, "self_device_time_total", 0) > 0]

    def self_us(e):
        return getattr(e, "self_device_time_total", 0) or dev_us(e)

    busy_ms = sum(self_us(e) for e in kernels) / 1e3 / n
    groups = {name: 0.0 for name in KERNEL_GROUPS}
    launches = {name: 0 for name in KERNEL_GROUPS}
    for e in kernels:
        for name, marks in KERNEL_GROUPS.items():
            if any(m in e.key for m in marks):
                groups[name] += self_us(e) / 1e3 / n
                launches[name] += e.count
                break
    top_k = sorted(kernels, key=lambda e: -self_us(e))[:12]
    top_cpu = sorted(events, key=lambda e: -e.self_cpu_time_total)[:10]
    return {
        f"device_busy_ms_per_{per}": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        f"kernels_per_{per}": sum(e.count for e in kernels) / n,
        f"kernel_groups_ms_per_{per}": groups,
        f"kernel_group_launches_per_{per}": {
            k: v / n for k, v in launches.items()},
        f"top_kernels_ms_per_{per}": {
            e.key[:60]: self_us(e) / 1e3 / n for e in top_k},
        f"top_host_ops_ms_per_{per}": {
            e.key[:60]: e.self_cpu_time_total / 1e3 / n for e in top_cpu},
    }


if __name__ == "__main__":
    main()
