#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``multiagent_orb_slam2_tpu_torch/csrc``,
holds each kernel against its plain PyTorch version on the card, then drives
the port's main path (``System.track_stereo`` on a rendered stereo corridor)
at the full KITTI-shaped width: 1241x376 stereo, 2000 ORB features over 8
levels, 64 keyframes, 32768 map points, 2048 feature slots. It fails (exit
code other than 0) when there is no CUDA device, when a kernel does not
build, launch or agree, when the main path never launched a kernel, or when
the trajectory is wrong. Needs no network and no other process.

Output, in order: the card's name and power limit, build seconds, one
``kernels:`` line with the comparison at every shape, the main path's
numbers, one JSON object ``{"kernels": [...]}``, the card line again, and as
the last line ``{"ok": true, "device": {...}}``.
"""
import json
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

from multiagent_orb_slam2_tpu_torch.config import (Capacities, OrbConfig,
                                                   OptimizerConfig, Sensor,
                                                   SlamConfig, TrackingConfig)
from multiagent_orb_slam2_tpu_torch.geometry.camera import Intrinsics
from multiagent_orb_slam2_tpu_torch.io import synthetic
from multiagent_orb_slam2_tpu_torch.ops import frame as frame_mod
from multiagent_orb_slam2_tpu_torch.optim import pose_opt
from multiagent_orb_slam2_tpu_torch.runtime import system as system_mod
from multiagent_orb_slam2_tpu_torch.runtime.tracker import _np_inverse
from multiagent_orb_slam2_tpu_torch.utils import cuda_build, torch_ops

N_FRAMES = 30
CAM = Intrinsics(fx=718.9, fy=718.9, cx=620.5, cy=188.0, bf=386.1,
                 width=1241, height=376)
CFG = SlamConfig(
    camera=CAM, sensor=Sensor.STEREO,
    orb=OrbConfig(n_features=2000),
    tracking=TrackingConfig(max_frames_between_kf=10, th_depth=35.0),
    caps=Capacities(max_keyframes=64, max_points=32768, max_features=2048,
                    local_points=8192))

# published peaks of one H100 SXM (dense, 700 W): HBM bytes/s, float32 FLOP/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of fn() on the card, from CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(statistics.median(times))


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------

def pose_problem(B: int, N: int, seed: int):
    """Seeded batch of pose problems on the card: 10 % gross outliers, mixed
    stereo / mono, 10 % of the slots masked out, information by level."""
    rng = np.random.default_rng(seed)
    pw = np.stack([rng.uniform(-10, 10, (B, N)), rng.uniform(-3, 3, (B, N)),
                   rng.uniform(4, 40, (B, N))], -1)
    w = rng.normal(size=(B, 3)) * 0.05
    q = np.concatenate([np.ones((B, 1)), 0.5 * w], 1)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    t = rng.normal(size=(B, 3)) * 0.05
    qv = q[:, None, 1:]
    u1 = np.cross(qv, pw)
    pc = pw + 2.0 * (q[:, None, :1] * u1 + np.cross(qv, u1)) + t[:, None]
    u = CAM.fx * pc[..., 0] / pc[..., 2] + CAM.cx
    v = CAM.fy * pc[..., 1] / pc[..., 2] + CAM.cy
    obs = np.stack([u, v, u - CAM.bf / pc[..., 2]], -1) \
        + rng.normal(0, 0.5, (B, N, 3))
    n_out = N // 10
    obs[:, :n_out, :2] += rng.uniform(20, 80, (B, n_out, 2)) \
        * rng.choice([-1, 1], (B, n_out, 2))
    isig = 1.0 / 1.2 ** (2 * rng.integers(0, 8, (B, N)))
    stereo = rng.random((B, N)) < 0.8
    mask = rng.random((B, N)) < 0.9
    q0 = q + rng.normal(size=(B, 4)) * 0.01
    q0 /= np.linalg.norm(q0, axis=1, keepdims=True)
    t0 = t + rng.normal(size=(B, 3)) * 0.05

    def dev(a, dtype=torch.float32):
        return torch.tensor(a, dtype=dtype, device="cuda")

    return dev(q0), dev(t0), pose_opt.PoseObs(
        dev(pw), dev(obs), dev(isig), dev(stereo, torch.bool),
        dev(mask, torch.bool))


def pose_opt_bound_ms(B: int, N: int, cfg: OptimizerConfig):
    """Least time the card could take: bytes moved once over the memory rate
    against float32 operations over the peak rate. The schedule is fixed
    (no early exit), so the counts follow from the shapes."""
    bytes_moved = B * (N * (12 + 12 + 4 + 1 + 1) + 32) + B * (32 + N)
    resid, cost, relabel, normal_eq = 52, 6, 2, 217
    passes = cfg.pose_opt_rounds * cfg.pose_opt_iters
    flop_per_obs = (passes * (resid + cost + normal_eq)
                    + passes * (resid + cost)
                    + cfg.pose_opt_rounds * (resid + relabel))
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = B * N * flop_per_obs / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_pose_kernel():
    cfg = OptimizerConfig()
    rows = []
    for B, N in ((1, 2048), (4, 2048), (1, 512)):
        q0, t0, obs = pose_problem(B, N, seed=1000 * B + N)
        k = pose_opt.pose_optimize(q0, t0, obs, CAM, cfg)
        torch.cuda.synchronize()
        p = pose_opt._pose_optimize_plain(q0, t0, obs, CAM, cfg)
        torch.cuda.synchronize()
        err = max(float((k[0] - p[0]).abs().max()),
                  float((k[1] - p[1]).abs().max()))
        inl_eq = float((k[2] == p[2]).float().mean())
        finite = all(bool(torch.isfinite(a).all()) for a in k[:2])
        if not (finite and err <= 1e-5 and inl_eq >= 0.99
                and int((k[3] - p[3]).abs().max()) <= 2):
            raise SystemExit(
                f"pose_opt kernel disagrees with its plain version at B={B} "
                f"N={N}: max |dq|,|dt| = {err:.3e} (tolerance 1e-5), inlier "
                f"masks equal on {inl_eq:.4f} (need 0.99)")
        again = pose_opt.pose_optimize(q0, t0, obs, CAM, cfg)
        if not all(torch.equal(a, b) for a, b in zip(k, again)):
            raise SystemExit("pose_opt kernel is not deterministic")
        kernel_ms = cuda_ms(
            lambda: pose_opt.pose_optimize(q0, t0, obs, CAM, cfg), 20)
        plain_ms = cuda_ms(
            lambda: pose_opt._pose_optimize_plain(q0, t0, obs, CAM, cfg), 5)
        bound_ms, bound_by = pose_opt_bound_ms(B, N, cfg)
        rows.append({"name": "pose_opt", "B": B, "N": N,
                     "replaces": "optim/pose_opt_pallas.py::_pose_kernel",
                     "max_err": err, "inlier_agreement": inl_eq,
                     "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "launches": pose_opt.pose_optimize.launches})
    print("kernels: " + json.dumps(rows))

    # the kernel's serial skeleton: dependent block-wide reductions (+ solve)
    lib = pose_opt.load_kernel()
    out = torch.empty(1, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    n = 4000

    def chain(count, with_solve):
        if lib.pose_opt_reduce_chain(out.data_ptr(), count, with_solve,
                                     stream) != 0:
            raise SystemExit("reduce-chain probe failed to launch")

    probe = {}
    for with_solve in (0, 1):
        base = cuda_ms(lambda: chain(0, with_solve), 10)
        full = cuda_ms(lambda: chain(n, with_solve), 10)
        probe["reduce+solve_us" if with_solve else "reduce_us"] = \
            (full - base) / n * 1e3
    passes = cfg.pose_opt_rounds * cfg.pose_opt_iters
    probe["serial_floor_ms"] = passes * (probe["reduce+solve_us"]
                                         + probe["reduce_us"]) * 1e-3
    print("pose_opt serial chain: " + json.dumps(probe))
    return rows[0], probe


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------

def drive_main_path():
    scene = synthetic.BoxScene(seed=0, z_far=60.0)
    q_gt, t_gt = synthetic.corridor_trajectory(N_FRAMES, step=0.25)
    t0 = time.perf_counter()
    frames = [scene.render_stereo(CAM, q_gt[i], t_gt[i])[:2]
              for i in range(N_FRAMES)]
    print(f"rendered {N_FRAMES} stereo frames {CAM.width}x{CAM.height} on the "
          f"host in {time.perf_counter() - t0:.1f} s")

    system = system_mod.System(CFG, None, enable_loop_closing=False)
    tracker = system.tracker
    phase_ms = {"extract": [], "keyframe": []}

    def timed(fn, key):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            phase_ms[key][-1] += (time.perf_counter() - t) * 1e3
            return out
        return wrapper

    real_extract = frame_mod.extract_frame
    frame_mod.extract_frame = timed(real_extract, "extract")
    tracker._create_keyframe = timed(tracker._create_keyframe, "keyframe")

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    # every count to zero just before the main path
    pose_opt.pose_optimize.launches = 0
    torch_ops.reset_host_fetch_count()
    frame_ms, fetches, syncs, sync_sites = [], [], [], []
    torch.cuda.set_sync_debug_mode("warn")
    try:
        for i, (left, right) in enumerate(frames):
            phase_ms["extract"].append(0.0)
            phase_ms["keyframe"].append(0.0)
            before = torch_ops.host_fetch_count()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                t = time.perf_counter()
                system.track_stereo(left, right, frame_id=i)
                torch.cuda.synchronize()
                frame_ms.append((time.perf_counter() - t) * 1e3)
            fetches.append(torch_ops.host_fetch_count() - before)
            sites = [f"{w.filename.rsplit('/', 1)[-1]}:{w.lineno}"
                     for w in caught if "synchroniz" in str(w.message)]
            syncs.append(len(sites))
            sync_sites.append(sites)
    finally:
        torch.cuda.set_sync_debug_mode("default")
        frame_mod.extract_frame = real_extract
    launches = pose_opt.pose_optimize.launches
    system.shutdown()

    # what came out
    traj = tracker.trajectory
    lost = [r.frame_id for r in traj[1:] if r.lost]
    est = np.stack([_np_inverse(r.q.astype(np.float64),
                                r.t.astype(np.float64))[1] for r in traj])
    ate = float(np.sqrt(np.mean(np.sum((est - t_gt) ** 2, axis=-1))))
    shared = system.shared
    off_card = [k for k, v in shared.state._asdict().items() if not v.is_cuda]
    finite = bool(np.isfinite(est).all()) and all(
        bool(torch.isfinite(v).all()) for v in
        (shared.state.kf_q, shared.state.kf_t, shared.state.mp_pos))
    is_kf = [ms_ > 0.0 for ms_ in phase_ms["keyframe"]]
    plain = [i for i in range(1, N_FRAMES) if not is_kf[i]]
    track_ms = [frame_ms[i] - phase_ms["extract"][i] - phase_ms["keyframe"][i]
                for i in range(N_FRAMES)]
    report = {
        "frames": N_FRAMES, "lost": lost, "n_kf": shared.n_kf,
        "n_mp": shared.n_mp, "ate_m": ate,
        "pose_opt_launches": launches,
        "frame_ms_median": statistics.median(frame_ms[1:]),
        "frame_ms_median_no_keyframe": statistics.median(
            frame_ms[i] for i in plain),
        "extract_ms_median": statistics.median(phase_ms["extract"][1:]),
        "track_ms_median": statistics.median(track_ms[1:]),
        "keyframe_ms_median": statistics.median(
            [m for m in phase_ms["keyframe"] if m > 0.0] or [0.0]),
        "keyframes_spawned": int(sum(is_kf)),
        "host_fetches_per_frame_median": statistics.median(fetches[1:]),
        "host_fetches_per_frame_max": max(fetches[1:]),
        "device_syncs_per_frame_median_no_keyframe": statistics.median(
            syncs[i] for i in plain),
        "device_syncs_per_frame_max": max(syncs[1:]),
        "max_memory_allocated_mb": torch.cuda.max_memory_allocated() / 2 ** 20,
    }
    print("main path: " + json.dumps(report))
    # where the card made the host wait, on the last frame without a keyframe
    # and on the last frame with one
    for label, idx in (("tracked frame", plain[-1]),
                       ("keyframe frame", max(i for i in range(N_FRAMES)
                                              if is_kf[i]))):
        counts = {}
        for site in sync_sites[idx]:
            counts[site] = counts.get(site, 0) + 1
        print(f"sync sites, {label} {idx}: " + json.dumps(counts))
    problems = []
    if lost:
        problems.append(f"frames lost after the first: {lost}")
    if shared.n_kf < 3:
        problems.append(f"only {shared.n_kf} keyframes")
    if not finite or not ate < 0.15:
        problems.append(f"ATE {ate:.4f} m against ground truth (need < 0.15)")
    if launches < 2 * (N_FRAMES - 1):
        problems.append(f"pose_opt kernel launched {launches} times on the "
                        f"main path (need >= {2 * (N_FRAMES - 1)})")
    if off_card:
        problems.append(f"MapState tensors not on the card: {off_card}")
    if problems:
        raise SystemExit("main path failed: " + "; ".join(problems))
    return launches, report


def main():
    # 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device: "
                         "torch.cuda.is_available() is False")
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.get_float32_matmul_precision() != "highest":
        raise SystemExit("float32 matmuls must stay in full precision")
    card = card_line()
    print(card)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    pose_opt.load_kernel()
    print(f"built {sorted(cuda_build.build_seconds)} in "
          f"{time.perf_counter() - t0:.1f} s (nvcc seconds: "
          f"{json.dumps(cuda_build.build_seconds)})")
    for name, log in cuda_build.build_logs.items():
        used = [ln.strip() for ln in log.splitlines() if "Used" in ln]
        print(f"ptxas {name}: " + " | ".join(used))

    # 3. kernels against their plain versions
    k1, probe = check_pose_kernel()

    # 4. main path
    launches, report = drive_main_path()

    # 5. the record
    kernels = [{
        "name": "pose_opt", "route": "cuda",
        "source": "multiagent_orb_slam2_tpu_torch/csrc/pose_opt.cu",
        "replaces": "multiagent_orb_slam2_tpu/optim/pose_opt_pallas.py:117",
        "launches": launches, "max_abs_err": k1["max_err"],
        "ms": k1["kernel_ms"], "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
        "library_ms": None,
        "serial_floor_ms": probe["serial_floor_ms"],
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
