#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``multiagent_orb_slam2_tpu_torch/csrc``
(pose optimizer, Schur preparation, PCG), holds each kernel against its plain
PyTorch version on the card, then drives the port's main paths through
``System.track_stereo`` on a rendered stereo corridor at the full
KITTI-shaped width (1241x376 stereo, 2000 ORB features over 8 levels, 64
keyframes, 32768 map points, 2048 feature slots, 24 observations per point):
60 frames with local bundle adjustment and keyframe culling and no
vocabulary, then the first 30 frames with local bundle adjustment switched
off. Then loop closing: ``System(CFG, vocab)`` with the committed vocabulary
over 100 frames of the same corridor (keyframe database, loop detection,
local and global BA, as a user builds the System); a loop detected and
corrected with global BA on a drifted 110-keyframe ring at (K, P, M) =
(128, 32768, 24); global BA at the benchmark's size (256, 65536, 8). Then
trial 0 of the accuracy protocol: the 660-frame loop corridor of
``analysis/make_synth_seq`` (seed 0, 512x288, rendered once by a pool of
processes); its first 120 frames through the single-agent driver
``drivers/run_single`` at the default capacities (512 keyframes, 65536
points, 24 observations a point), evaluated by ``analysis/genstats``; on
the map it leaves, a kidnap (two black frames, then relocalization at an
earlier pose) and a checkpoint round trip. Then the whole corridor split
between two agents under the multi-agent server
(``drivers/generic_split_seq -n 2``): the maps fuse where agent 1's last
stretch revisits agent 0's start; each agent's trajectory is evaluated and
the fused map checkpointed. The Schur preparation (K2) and PCG (K3) are
held against their plain versions on both global BAs' own problems, on the
corridor's last local BA and on the first post-fusion global BA. It fails
(exit code other than 0) when there is no CUDA device, when a kernel does
not build, launch or agree, when a path never launched its kernels, or
when a trajectory, the keyframe database, a loop correction, a
relocalization, a fusion or a checkpoint is wrong. Needs no network; the
processes it starts to render the corridor end with it.

Output, in order: the card's name and power limit, build seconds and ptxas
lines, one line per kernel with the comparison at every shape, each path's
numbers, the ring's and the benchmark-size global BA's numbers with their
K2 / K3 checks, the corridor's (``corridor:``), the kidnap's and the
checkpoint's lines and the K2 / K3 checks on the corridor's local BA, the
split phase's (``split:``, ``split checkpoint:``) and the K2 / K3 checks on
the post-fusion global BA (``fusion GBA``), one JSON object
``{"kernels": [...]}``, the card line again, and as the last line
``{"ok": true, "device": {...}}``.

Times: ``ms`` / ``kernel_ms`` of every kernel is the kernel alone (raw
launches queued back to back between two CUDA events; for the Schur
preparation, whose launches take less time on the card than on the host,
replayed from a CUDA graph, its host-queued reading beside it as
``*_stream``); ``wrapper_ms`` is one call of the Python wrapper between two
events, which also counts the host's time between the wrapper's own
operations. ``ms_v1`` and ``wrapper_ms_v1``
are the same two readings of the kernel's first design (pose optimizer,
Schur preparation) or of the grid path (PCG at D = 48 and 384), taken in
turns with the present one in this process on this card. After the BA path
the Schur preparation is timed again, alone, on the workspaces that path's
local bundle adjustments built (``ba_prep, real maps``).
"""
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from multiagent_orb_slam2_tpu_torch.config import (Capacities, LoopConfig,
                                                   OrbConfig, OptimizerConfig,
                                                   Sensor, SlamConfig,
                                                   TrackingConfig)
from multiagent_orb_slam2_tpu_torch import convert
from multiagent_orb_slam2_tpu_torch.analysis import genstats, make_synth_seq
from multiagent_orb_slam2_tpu_torch.drivers import (generic_split_seq,
                                                    run_single)
from multiagent_orb_slam2_tpu_torch.geometry import se3
from multiagent_orb_slam2_tpu_torch.geometry.camera import Intrinsics
from multiagent_orb_slam2_tpu_torch.io import ba_problem, datasets, synthetic
from multiagent_orb_slam2_tpu_torch.mapstate import checkpoint as ckpt_mod
from multiagent_orb_slam2_tpu_torch.ops import frame as frame_mod
from multiagent_orb_slam2_tpu_torch.optim import ba as ba_mod
from multiagent_orb_slam2_tpu_torch.optim import ba_kernels, ba_prep, pcg
from multiagent_orb_slam2_tpu_torch.optim import pose_opt
from multiagent_orb_slam2_tpu_torch.runtime import loop_closing as lc_mod
from multiagent_orb_slam2_tpu_torch.runtime import reloc as reloc_mod
from multiagent_orb_slam2_tpu_torch.runtime import steps as steps_mod
from multiagent_orb_slam2_tpu_torch.runtime import system as system_mod
from multiagent_orb_slam2_tpu_torch.runtime import tracker as tracker_mod
from multiagent_orb_slam2_tpu_torch.runtime.tracker import (TrackerState,
                                                            _np_inverse)
from multiagent_orb_slam2_tpu_torch.server import server as server_mod
from multiagent_orb_slam2_tpu_torch.utils import cuda_build, torch_ops
from multiagent_orb_slam2_tpu_torch.vocab import bow as bow_mod

# the drifted ring the loop-closing phase closes (numpy + the port only)
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "tests"))
import torch_loop_cases  # noqa: E402

N_FRAMES_BA = 60       # the path with local bundle adjustment
N_FRAMES_NO_BA = 30    # the earlier path, on the first frames of the same run
N_FRAMES_LOOP = 100    # the loop path: more than refractory_kfs keyframes
# the ring of the loop-closing phase, as tests/test_loop_closing.py's front
# door test has it: 110 keyframes, the last 5 revisiting the first places
RING_KF, RING_REV, RING_DRIFT = 110, 5, 0.01
# trial 0 of the accuracy protocol (analysis/collect_synthetic.py): the
# 660-frame loop corridor of make_synth_seq, seed 0, at the default
# capacities; the JAX package's single-agent ATE there
# (analysis/stats_synthetic.txt, trial0) and the gate PERF.md sets for it
CORRIDOR_FRAMES, CORRIDOR_SEED = 660, 0
JAX_ATE_TRIAL0_M = 0.057
# the single-agent phase tracks the corridor's first 120 frames (more than
# 30 local BAs, the kidnap's pose among them), so that the script, the split
# phase included, stays inside its time on a slow host; the whole 660-frame
# single run stays recorded by analysis/collect_synthetic
CORRIDOR_SINGLE_FRAMES = 120
# the 2-agent split of the same corridor (generic_split_seq -n 2): the JAX
# package's agent0 / agent1 ATE on trial 0 (analysis/stats_synthetic.txt)
JAX_SPLIT_ATE_TRIAL0_M = (0.025, 0.020)
CORRIDOR_ATE_GATE_M = 0.15
CORRIDOR_EXPORTED_GATE = 0.9
KIDNAP_FRAME = 40      # the kidnapped camera reappears at this frame's pose
# g2o's global BA time on KITTI 00 (BASELINE.md, split-sequence table): the
# reference's, taken on a CPU; an outside yardstick, no gate
G2O_GBA_MS_KITTI00 = 1426.5
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


def device_ms(run, batch: int = 20, reps: int = 7) -> float:
    """Median milliseconds of one launch when `batch` launches of run() are
    queued back to back between two CUDA events: the kernel's own time on the
    card. cuda_ms of a wrapper call also counts the host's time between the
    wrapper's own operations, which on a slow host exceeds the kernel's."""
    return cuda_ms(lambda: [run() for _ in range(batch)], reps) / batch


def graph_ms(run, batch: int = 20, reps: int = 7) -> float:
    """Median milliseconds of one launch when `batch` launches of run() are
    captured in a CUDA graph and replayed between two CUDA events: the
    kernel's own time without the host's gaps between launches. A launch
    from Python costs tens of microseconds of host time, more than a kernel
    of a few microseconds takes, so device_ms of such a kernel reads the
    host."""
    run()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(batch):
            run()
    return cuda_ms(graph.replay, reps) / batch


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


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------

def pose_problem(B: int, N: int, seed: int, valid: float = 0.9):
    """Seeded batch of pose problems on the card: 10 % gross outliers, mixed
    stereo / mono, a share `valid` of the slots unmasked (at random places),
    information by level."""
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
    mask = rng.random((B, N)) < valid
    q0 = q + rng.normal(size=(B, 4)) * 0.01
    q0 /= np.linalg.norm(q0, axis=1, keepdims=True)
    t0 = t + rng.normal(size=(B, 3)) * 0.05

    def dev(a, dtype=torch.float32):
        return torch.tensor(a, dtype=dtype, device="cuda")

    return dev(q0), dev(t0), pose_opt.PoseObs(
        dev(pw), dev(obs), dev(isig), dev(stereo, torch.bool),
        dev(mask, torch.bool))


def pose_opt_bound(n_valid: int, B: int, N: int, cfg: OptimizerConfig):
    """Least time the card could take when n_valid of the B * N slots are
    unmasked: bytes moved once over the memory rate (every slot's inputs are
    read, the mask says which count) against the float32 operations of the
    valid observations over the peak rate. The schedule is fixed (no early
    exit). Counted is what the function needs, not what the plain version
    spends: the residual, cost and normal equations once at the starting pose
    of each round and once at each iteration's candidate (an accepted
    candidate's sums are the next iteration's), and a relabelling from those
    residuals at each round's start and at the end."""
    bytes_moved = B * (N * (12 + 12 + 4 + 1 + 1) + 32) + B * (32 + N)
    resid, cost, relabel, normal_eq = 52, 6, 2, 217
    passes = cfg.pose_opt_rounds * (cfg.pose_opt_iters + 1)
    flop_per_obs = (passes * (resid + cost + normal_eq)
                    + (cfg.pose_opt_rounds + 1) * relabel)
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = n_valid * flop_per_obs / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def pose_optimize_v1(q0, t0, obs, cam, cfg):
    """The first design of the pose kernel (csrc/pose_opt.cu, symbol
    pose_opt_launch_v1), for timing beside the present one."""
    return pose_opt._pose_optimize_cuda(
        q0, t0, obs, cam, cfg, launch=pose_opt.load_kernel().pose_opt_launch_v1)


def check_pose_kernel():
    """K1 against its plain version (1e-5 in q and t, inlier labels equal on
    99 %, counts within 2) at the shapes the paths give it (N = 2048 on the
    KITTI-shaped paths, 1024 on the loop corridor's, in tracking and in
    relocalization) and in three mask regimes at N = 2048: 90 % of the
    slots valid, 20 % (the path's regime), all; two launches bit-identical; the first design timed beside it
    (kernel_ms / ms_v1: the kernels alone; wrapper_ms / wrapper_ms_v1: one
    call of the Python wrapper, as earlier records timed it). With no valid
    observation it returns the initial pose and 0
    inliers, as the plain version does."""
    cfg = OptimizerConfig()
    rows = []
    for B, N, valid in ((1, 2048, 0.9), (4, 2048, 0.9), (1, 512, 0.9),
                        (1, 2048, 0.2), (1, 2048, 1.0), (1, 1024, 0.4)):
        q0, t0, obs = pose_problem(B, N, seed=1000 * B + N, valid=valid)
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
                f"N={N} valid={valid}: max |dq|,|dt| = {err:.3e} (tolerance "
                f"1e-5), inlier masks equal on {inl_eq:.4f} (need 0.99)")
        again = pose_opt.pose_optimize(q0, t0, obs, CAM, cfg)
        if not all(torch.equal(a, b) for a, b in zip(k, again)):
            raise SystemExit("pose_opt kernel is not deterministic")
        v1 = pose_optimize_v1(q0, t0, obs, CAM, cfg)
        err_v1 = max(float((v1[0] - p[0]).abs().max()),
                     float((v1[1] - p[1]).abs().max()))
        # old, new, new, old in turns on the same inputs: the kernels alone
        # (raw launches back to back) and one wrapper call between two events
        run_new = pose_opt._bind_launch(q0, t0, obs, CAM, cfg)[0]
        run_v1 = pose_opt._bind_launch(
            q0, t0, obs, CAM, cfg,
            launch=pose_opt.load_kernel().pose_opt_launch_v1)[0]
        d_v1 = [device_ms(run_v1)]
        d_new = [device_ms(run_new), device_ms(run_new)]
        d_v1.append(device_ms(run_v1))
        w_v1 = cuda_ms(lambda: pose_optimize_v1(q0, t0, obs, CAM, cfg), 20)
        w_new = cuda_ms(
            lambda: pose_opt.pose_optimize(q0, t0, obs, CAM, cfg), 20)
        plain_ms = cuda_ms(
            lambda: pose_opt._pose_optimize_plain(q0, t0, obs, CAM, cfg), 5)
        n_valid = int(obs.mask.sum())
        bound_ms, bound_by = pose_opt_bound(n_valid, B, N, cfg)
        rows.append({"name": "pose_opt", "B": B, "N": N,
                     "valid_share": valid, "n_valid": n_valid,
                     "replaces": "optim/pose_opt_pallas.py::_pose_kernel",
                     "max_err": err, "inlier_agreement": inl_eq,
                     "kernel_ms": min(d_new), "ms_v1": min(d_v1),
                     "wrapper_ms": w_new, "wrapper_ms_v1": w_v1,
                     "max_err_v1": err_v1, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "launches": pose_opt.pose_optimize.launches})
    print("kernels: " + json.dumps(rows))

    # no valid observation: the initial pose comes back, with 0 inliers
    q0, t0, obs = pose_problem(2, 2048, seed=5)
    obs = obs._replace(mask=torch.zeros_like(obs.mask))
    k = pose_opt.pose_optimize(q0, t0, obs, CAM, cfg)
    p = pose_opt._pose_optimize_plain(q0, t0, obs, CAM, cfg)
    if not (torch.equal(k[0], q0) and torch.equal(k[1], t0)
            and torch.equal(p[0], q0) and torch.equal(p[1], t0)
            and not bool(k[2].any()) and int(k[3].sum()) == 0
            and int(p[3].sum()) == 0):
        raise SystemExit("pose_opt kernel with no valid observation did not "
                         "return the initial pose and 0 inliers")
    print("pose_opt, no valid observation: initial pose and 0 inliers, as "
          "the plain version")

    # the kernel's serial skeleton: one dependent reduction per pass, each
    # followed by the 6x6 solve and the pose update, on the kernel's own
    # threads and blocks; rounds * (iters + 1) passes
    lib = pose_opt.load_kernel()
    out = torch.empty(1, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    threads, cluster = lib.pose_opt_threads(), lib.pose_opt_cluster()
    n = 4000

    def chain(count, with_solve):
        if lib.pose_opt_reduce_chain(out.data_ptr(), count, with_solve,
                                     threads, cluster, stream) != 0:
            raise SystemExit("reduce-chain probe failed to launch")

    probe = {"threads": threads, "blocks_per_pose": cluster}
    for with_solve in (0, 1):
        base = cuda_ms(lambda: chain(0, with_solve), 10)
        full = cuda_ms(lambda: chain(n, with_solve), 10)
        probe["reduce+solve_us" if with_solve else "reduce_us"] = \
            (full - base) / n * 1e3
    passes = cfg.pose_opt_rounds * (cfg.pose_opt_iters + 1)
    probe["passes"] = passes
    probe["serial_floor_ms"] = passes * probe["reduce+solve_us"] * 1e-3
    print("pose_opt serial chain: " + json.dumps(probe))
    return rows[0], probe


# ---------------------------------------------------------------------------
# K2 (Schur preparation) and K3 (PCG) against their plain versions
# ---------------------------------------------------------------------------

D2M, D2S = 5.991, 7.815
# float32 operations per active slot, as counted for the first design of
# csrc/ba_prep.cu and kept so that bounds stay comparable: the slot
# evaluation (rotate, project, chi2, Huber, Jacobian rows, rotation matrix:
# 95) twice; Jp (45), Hpp (36) and bp (18); Jp again (45), Jc (27), Wb (108),
# Y and Ybp (126), Ht (126) and bt (42). The present design evaluates a slot
# once (140 fewer); the bytes bound either way
PREP_FLOP_PER_ACTIVE_SLOT = (2 * 95 + 45 + 36 + 18
                             + 45 + 27 + 108 + 126 + 126 + 42)


def scale_err(got, want):
    """max |got - want| over the largest magnitude of `want`."""
    return float((got - want).abs().max()
                 / want.abs().max().clamp_min(1e-30))


def ba_case(K, P, M, share, seed, mono_mix=False):
    """A seeded BA problem on the card with its solve constants."""
    fields, cam = ba_problem.build_problem(K, P, M, seed=seed,
                                           active_share=share)
    if mono_mix:
        rng = np.random.default_rng(seed + 1)
        fields["obs_stereo"] = rng.random((P, M)) < 0.6
        fields["obs_inv_sigma2"] = (
            1.0 / 1.2 ** (2 * rng.integers(0, 8, (P, M)))).astype(np.float32)
        fields["pose_fixed"][:2] = True
    prob = convert.ba_problem_from_numpy(fields, "cuda")
    return prob, cam, ba_mod._prepare_solve(prob, steps_mod._ba_chunk(P))


def prep_bound_ms(ws, K, cost_only=False, listed=False):
    """Least time for one launch on this problem: every input read once
    (flags of all slots; pose index, observation and information of the
    active ones; points, poses, lambda), every output written once (active
    slots only: the others are never written; hinv6 and bp charged at all P
    points, as the first design wrote them), against the float32 operations
    of the active slots. With `listed` (a workspace whose outputs `prepare`
    zero-filled, as on the path's maps) only the listed points are charged:
    the list and its count, their flags and points, their hinv6 and bp."""
    P, M = ws.kf.shape
    n_act = int(ws.active.sum())
    n_pts = int(ws.n_points) if listed else P
    bytes_in = (n_pts * (M + 12) + n_act * (4 + 12 + 4) + K * 28 + 4
                + (4 * (n_pts + 1) if listed else 0))
    floats_out = (n_act * 2 if cost_only
                  else n_act * (18 + 18 + 33 + 2) + n_pts * 9)
    t_bytes = (bytes_in + 4 * floats_out) / HBM_BYTES_PER_S * 1e3
    t_ops = n_act * PREP_FLOP_PER_ACTIVE_SLOT / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def prep_v1(ws, q, t, pw, lam, cam, d2m, d2s, use_huber, cost_only=False):
    """Bind the first design of K2 (csrc/ba_prep.cu, symbol
    ba_prep_launch_v1: slot-major arrays, one thread per point) on the same
    problem, for timing beside the present one: its inputs transposed and
    fresh zero-filled [*, M, P] outputs. Returns (run, terms [*, M, P]);
    run() launches it on the current stream and does nothing else."""
    lib = ba_prep.load_kernel()
    P, M = ws.kf.shape
    kf, isig, flags = (a.t().contiguous() for a in (ws.kf, ws.isig, ws.flags))
    uvr = ws.uvr.permute(2, 1, 0).contiguous()
    out = [torch.zeros(s, device="cuda")
           for s in ((18, M, P), (18, M, P), (33, M, P), (6, P), (3, P),
                     (M, P), (M, P))]
    qt = torch.cat([q, t], dim=1).contiguous()
    pw = pw.contiguous()
    lam_ptr = 0 if cost_only else lam.data_ptr()

    def run():
        if lib.ba_prep_launch_v1(
                qt.data_ptr(), pw.data_ptr(), kf.data_ptr(), uvr.data_ptr(),
                isig.data_ptr(), flags.data_ptr(), 0, 0, lam_ptr,
                *[a.data_ptr() for a in out], P, M, cam.fx, cam.fy, cam.cx,
                cam.cy, cam.bf, d2m, d2s, int(use_huber), int(cost_only),
                torch.cuda.current_stream().cuda_stream) != 0:
            raise SystemExit("ba_prep first design failed to launch")

    if cost_only:
        return run, ba_prep.PrepTerms(None, None, None, None, None, *out[5:])
    return run, ba_prep.PrepTerms(*out)


def point_major(terms):
    """Slot-major terms of the first design as [*, P, M]."""
    return ba_prep.PrepTerms(*[
        a if a is None or name in ("hinv6", "bp") else a.transpose(-1, -2)
        for name, a in zip(terms._fields, terms)])


def k2_times(ws, args, reps_plain=0):
    """K2 alone, replayed from a CUDA graph (present and first design in
    turns: v1, new, new, v1), the same from launches queued by the host
    (``*_stream``, how K1 and K3 are read), the cost-only mode alone, and one
    wrapper call, on one problem."""
    run_new = ba_prep._bind_launch(ws, *args)[0]
    run_v1 = prep_v1(ws, *args)[0]
    t_v1 = [graph_ms(run_v1)]
    t_new = [graph_ms(run_new), graph_ms(run_new)]
    t_v1.append(graph_ms(run_v1))
    q, t, pw, _, cam, d2m, d2s, huber = args
    run_cost = ba_prep._bind_launch(ws, q, t, pw, None, cam, d2m, d2s, huber,
                                    cost_only=True)[0]
    out = {"kernel_ms": min(t_new), "ms_v1": min(t_v1),
           "kernel_ms_stream": device_ms(run_new),
           "ms_v1_stream": device_ms(run_v1),
           "cost_only_ms": graph_ms(run_cost),
           "wrapper_ms": cuda_ms(lambda: ba_prep.prep_terms(ws, *args), 20)}
    if reps_plain:
        out["plain_ms"] = cuda_ms(
            lambda: ba_prep._prep_terms_plain(ws, *args), reps_plain)
    return out


def check_prep_kernel():
    """K2 at the main path's shape, the benchmark's shape and a small mono +
    stereo mix: every output against the plain version (float32) within 1e-3
    of the output's scale, and no further from a float64 evaluation than
    twice the plain float32 version is; cost-only mode equals the full mode;
    two launches are bit-identical. The first design is held against the
    plain version on the same problem (hinv6 and bp at the listed points:
    it writes every point) and timed beside the present one. Returns the
    rows and, per shape, the reduced camera system of that build for the PCG
    check."""
    rows, systems = [], {}
    shapes = ((64, 32768, 24, 0.15, False), (256, 65536, 8, 1.0, False),
              (8, 1024, 8, 0.8, True), (512, 32768, 8, 1.0, False))
    for K, P, M, share, mono_mix in shapes:
        prob, cam, sc = ba_case(K, P, M, share, seed=K + M, mono_mix=mono_mix)
        lam = torch.full((1,), 1e-4, device="cuda")
        args = (prob.q, prob.t, prob.pw, lam, cam, D2M, D2S, True)
        k = ba_prep.prep_terms(sc.ws, *args)
        torch.cuda.synchronize()
        kept = ba_prep.PrepTerms(*[a.clone() for a in k])
        p32 = ba_prep._prep_terms_plain(sc.ws, *args)
        ws64 = sc.ws._replace(uvr=sc.ws.uvr.double(), isig=sc.ws.isig.double(),
                              active=sc.ws.active.double())
        p64 = ba_prep._prep_terms_plain(
            ws64, prob.q.double(), prob.t.double(), prob.pw.double(),
            lam.double(), cam, D2M, D2S, True)
        errs = {n: scale_err(a, b) for n, a, b in zip(kept._fields, kept, p32)}
        k64 = {n: scale_err(a.double(), b)
               for n, a, b in zip(kept._fields, kept, p64)}
        f64 = {n: scale_err(a.double(), b)
               for n, a, b in zip(kept._fields, p32, p64)}
        worst = max(errs.values())
        finite = all(bool(torch.isfinite(a).all()) for a in kept)
        far = [n for n in errs if k64[n] > 2.0 * f64[n] + 1e-6]
        if not finite or worst > 1e-3 or far:
            raise SystemExit(
                f"ba_prep kernel disagrees with its plain version at K={K} "
                f"P={P} M={M}: errors over scale {errs} (tolerance 1e-3); "
                f"against float64 {k64}, plain float32 against float64 {f64}, "
                f"further than twice that: {far}")
        kc = ba_prep.prep_terms(sc.ws, prob.q, prob.t, prob.pw, None, cam,
                                D2M, D2S, True, cost_only=True)
        if not (torch.equal(kc.cost, kept.cost)
                and torch.equal(kc.chi2, kept.chi2)):
            raise SystemExit("ba_prep cost-only mode differs from full mode")
        again = ba_prep.prep_terms(sc.ws, *args)
        if not all(torch.equal(a, b) for a, b in zip(again, kept)):
            raise SystemExit("ba_prep kernel is not deterministic")
        has = sc.ws.active > 0
        pts, n_pts = ba_prep.compact_points(has)
        pts_plain, n_plain = ba_prep._compact_points_plain(has.any(dim=1))
        if not (torch.equal(pts, pts_plain) and torch.equal(n_pts, n_plain)):
            raise SystemExit(f"ba_prep compaction kernel disagrees with its "
                             f"plain version at K={K} P={P} M={M}")
        run_v1, v1 = prep_v1(sc.ws, *args)
        run_v1()
        listed = sc.ws.active.amax(dim=1) > 0
        err_v1 = max(
            scale_err(a[:, listed], b[:, listed]) if n in ("hinv6", "bp")
            else scale_err(a, b)
            for n, a, b in zip(kept._fields, point_major(v1), p32))
        times = k2_times(sc.ws, args, reps_plain=3)
        bound_ms, bound_by = prep_bound_ms(sc.ws, K)
        rows.append({"name": "ba_prep", "K": K, "P": P, "M": M,
                     "active_share": float(sc.ws.active.mean()),
                     "listed_points": int(sc.ws.n_points),
                     "max_err_over_scale": worst, "errors": errs,
                     "max_err_vs_float64": max(k64.values()),
                     "plain_err_vs_float64": max(f64.values()),
                     "max_err_v1": err_v1, **times,
                     "cost_only_bound_ms": prep_bound_ms(sc.ws, K, True)[0],
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "compaction_ms": graph_ms(
                         lambda: ba_prep.compact_points(has)),
                     "grid_blocks": ba_prep.load_kernel()
                     .ba_prep_grid_blocks()})
        # the reduced camera system of this build, for K3
        systems[6 * K], rows[-1]["assembly_ms"] = reduced_system(kept, sc, lam)
        del prob, sc, kept, p32, p64, ws64, k, kc, again, v1, run_v1
        torch.cuda.empty_cache()
    print("ba_prep: " + json.dumps(rows))
    return rows, systems


def reduced_system(terms, sc, lam):
    """((S [D, D], rhs [D], Dinv [K, 6, 6]), assembly ms) of one LM build
    from K2's terms, as optim/ba._build_and_solve_fast forms them."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    S_blocks, dsum = ba_mod._assemble(terms, sc)
    torch.cuda.synchronize()
    assembly_ms = (time.perf_counter() - t0) * 1e3
    K = S_blocks.shape[0]
    Hcc = dsum[:21].t()[:, sc.triu]
    S = ba_mod._reduced_system(S_blocks, Hcc, lam, sc.free, sc.idx)
    rhs = torch.where(sc.free[:, None], dsum[21:27].t() - dsum[27:33].t(),
                      torch.zeros_like(dsum[21:27].t())).reshape(-1)
    eye6 = torch.eye(6, device="cuda")
    return (S.permute(0, 2, 1, 3).reshape(6 * K, 6 * K).contiguous(), rhs,
            torch.linalg.inv_ex(S[sc.idx, sc.idx] + 1e-8 * eye6).inverse), \
        assembly_ms


def pcg_bound_ms(D, n_iters, warm):
    """Every input read once from device memory (S, rhs, the 6x6 blocks, the
    warm start) and x written once, over the memory rate, against the 2 D^2
    operations of each product with S (one per iteration, one more for a warm
    start) over the float32 peak. Reading S again in every iteration is a
    design's choice (from shared memory on the cluster path, from L2 on the
    grid path), not something the function needs."""
    products = n_iters + (1 if warm else 0)
    floats = D * D + D + 6 * D + (D if warm else 0) + D
    t_bytes = 4 * floats / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * products * D * D / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def spd_system(D, seed):
    """A seeded dense, well-conditioned SPD system on the card with strong
    6x6 diagonal blocks: (S, rhs, Dinv, a warm start)."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(D, D))
    S = A @ A.T / D + np.diag(rng.uniform(1.0, 50.0, D))
    rhs = rng.normal(size=D)
    blocks = np.stack([S[i:i + 6, i:i + 6] for i in range(0, D, 6)])

    def dev(a):
        return torch.tensor(a, dtype=torch.float32, device="cuda")
    return dev(S), dev(rhs), dev(np.linalg.inv(blocks)), \
        dev(0.7 * np.linalg.solve(S, rhs))


def check_pcg_cluster_sizes():
    """The cluster path's other branches, which no path of this script
    reaches: D = 654 (D not a multiple of 4: scalar load of S, scalar sends;
    8 blocks) and D = 924 (the 16-block cluster, a size the launch must ask
    leave for). On seeded well-conditioned systems that 32 iterations solve,
    warm and cold: within 1e-4 of x's scale of the plain version, two
    launches bit-identical."""
    lib = pcg.load_kernel()
    rows = []
    for D, blocks in ((654, 8), (924, 16)):
        if lib.pcg_cluster_blocks(D) != blocks:
            raise SystemExit(f"pcg: D={D} got {lib.pcg_cluster_blocks(D)} "
                             f"blocks, expected a cluster of {blocks}")
        S, rhs, Dinv, x0 = spd_system(D, seed=D)
        row = {"name": "pcg", "D": D, "path": "cluster", "blocks": blocks}
        for key, warm in (("err_cold", None), ("err_warm", x0)):
            k = pcg.pcg_solve(S, rhs, Dinv, 32, warm)
            torch.cuda.synchronize()
            p = ba_kernels.pcg_solve(S, rhs, Dinv, 32, warm)
            row[key] = scale_err(k, p)
            if not (bool(torch.isfinite(k).all()) and row[key] <= 1e-4):
                raise SystemExit("pcg cluster path disagrees with the plain "
                                 "version: " + json.dumps(row))
            if not torch.equal(k, pcg.pcg_solve(S, rhs, Dinv, 32, warm)):
                raise SystemExit(f"pcg is not deterministic at D={D}")
        row["kernel_ms"] = device_ms(pcg._bind_launch(S, rhs, Dinv, 32, x0)[0])
        row["ms_v1"] = device_ms(pcg._bind_launch(
            S, rhs, Dinv, 32, x0, launch=lib.pcg_launch_grid)[0])
        rows.append(row)
    print("pcg, other cluster sizes: " + json.dumps(rows))


def check_pcg_kernel(systems):
    """K3 against ba_kernels.pcg_solve on reduced camera systems taken from
    real builds, D = 48, 384, 1536 and 3072, with and without a warm start.
    After 2 iterations the two agree within 1e-4 of x's scale (the same
    arithmetic in another summation order; r - alpha A p cancels, which
    amplifies the last bit of alpha). After 32 iterations they are two
    inexact solves of an ill-conditioned system, and CG's iterates differ
    most along the directions S hardly sees, so they are held together in
    the norm CG minimises: the energy norm of the kernel's error against a
    float64 solve is no worse than 1.1 x the plain version's, the two
    differ by at most 0.25 of that error (plus 1e-5) in the same norm, and
    the kernel's true residual is no worse than 1.1 x the plain version's.
    Two launches are bit-identical. D <= 924 goes through the cluster path
    (S resident in shared memory: 48 and 384 here, 768 on the loop-closing
    phase's global BA), larger D through the grid path (1536 and 3072 here,
    1536 on the global BA at the benchmark's size); each row says which
    (`path`), and on the cluster path the grid path is timed beside it on the
    same system (`ms_v1`)."""
    lib = pcg.load_kernel()
    rows = []

    def solve_grid(*args):
        return pcg._pcg_solve_cuda(*args, launch=lib.pcg_launch_grid)

    for D in sorted(systems):
        S, rhs, Dinv = systems[D]
        S64 = S.double()
        exact = torch.linalg.solve(S64, rhs.double())
        norm = float(torch.sqrt(exact @ (S64 @ exact)))

        def energy(d):
            d = d.double()
            return float(torch.sqrt((d @ (S64 @ d)).clamp_min(0.0))) / norm

        def res(x):
            return float((S @ x - rhs).norm() / rhs.norm())

        for warm in (None, 0.5 * exact.float()):
            k2 = pcg.pcg_solve(S, rhs, Dinv, 2, warm)
            p2 = ba_kernels.pcg_solve(S, rhs, Dinv, 2, warm)
            xk = pcg.pcg_solve(S, rhs, Dinv, 32, warm)
            torch.cuda.synchronize()
            xp = ba_kernels.pcg_solve(S, rhs, Dinv, 32, warm)
            err2, err = scale_err(k2, p2), scale_err(xk, xp)
            res_k, res_p = res(xk), res(xp)
            en_k, en_p = energy(xk - exact), energy(xp - exact)
            en_diff = energy(xk - xp)
            again = pcg.pcg_solve(S, rhs, Dinv, 32, warm)
            row = {"name": "pcg", "D": D, "warm_start": warm is not None,
                   "err_2_iters": err2, "err_32_iters": err,
                   "energy_err_kernel": en_k, "energy_err_plain": en_p,
                   "energy_diff": en_diff,
                   "residual_kernel": res_k, "residual_plain": res_p}
            if not (bool(torch.isfinite(xk).all()) and err2 <= 1e-4
                    and en_k <= 1.1 * en_p + 1e-6
                    and en_diff <= 0.25 * en_p + 1e-5
                    and res_k <= 1.1 * res_p + 1e-7):
                raise SystemExit("pcg kernel disagrees with its plain "
                                 "version: " + json.dumps(row))
            if not torch.equal(xk, again):
                raise SystemExit("pcg kernel is not deterministic")
            path = "cluster" if lib.pcg_cluster_blocks(D) > 0 else "grid"
            if path != ("cluster" if D <= 924 else "grid"):
                raise SystemExit(f"pcg took the {path} path at D={D}")
            row["path"] = path
            ms_v1 = wrapper_ms_v1 = None
            run_new = pcg._bind_launch(S, rhs, Dinv, 32, warm)[0]
            if path == "cluster":
                # the grid path on the same system: correct by the same
                # measure, and timed in turns with the cluster path
                xg = solve_grid(S, rhs, Dinv, 32, warm)
                row["energy_diff_grid_path"] = energy(xg - xp)
                if not energy(xg - exact) <= 1.1 * en_p + 1e-6:
                    raise SystemExit("pcg grid path disagrees at D=%d" % D)
                run_grid = pcg._bind_launch(S, rhs, Dinv, 32, warm,
                                            launch=lib.pcg_launch_grid)[0]
                t_grid = [device_ms(run_grid)]
            t_new = [device_ms(run_new), device_ms(run_new)]
            if path == "cluster":
                t_grid.append(device_ms(run_grid))
                ms_v1 = min(t_grid)
                wrapper_ms_v1 = cuda_ms(
                    lambda: solve_grid(S, rhs, Dinv, 32, warm), 20)
                # the load of S and the set-up alone: no iteration
                row["load_only_ms"] = device_ms(
                    pcg._bind_launch(S, rhs, Dinv, 0, warm)[0])
            wrapper_ms = cuda_ms(
                lambda: pcg.pcg_solve(S, rhs, Dinv, 32, warm), 20)
            plain_ms = cuda_ms(
                lambda: ba_kernels.pcg_solve(S, rhs, Dinv, 32, warm), 5)
            bound_ms, bound_by = pcg_bound_ms(D, 32, warm is not None)
            row.update({"kernel_ms": min(t_new), "ms_v1": ms_v1,
                        "wrapper_ms": wrapper_ms,
                        "wrapper_ms_v1": wrapper_ms_v1,
                        "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "blocks": (lib.pcg_cluster_blocks(D)
                                   or lib.pcg_grid_blocks(D))})
            rows.append(row)
        # the exact solve a later change will weigh K3 against (another
        # function than 32 inexact CG steps, so not a library time of K3)
        rows[-1]["cholesky_solve_ms"] = cuda_ms(
            lambda: torch.cholesky_solve(rhs[:, None],
                                         torch.linalg.cholesky_ex(S).L), 5)
        # the serial skeleton of the path this D takes: two barriers (the
        # cluster's or the grid's) and two reductions an iteration
        scratch = torch.empty(lib.pcg_scratch_floats(D), device="cuda")
        out = torch.empty(1, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream

        def chain(count):
            if lib.pcg_barrier_chain(scratch.data_ptr(), out.data_ptr(), D,
                                     count, stream) != 0:
                raise SystemExit("pcg barrier-chain probe failed to launch")

        n = 2000
        per_iter_us = (cuda_ms(lambda: chain(n), 5)
                       - cuda_ms(lambda: chain(0), 5)) / n * 1e3
        rows[-1]["barrier_pair_us"] = per_iter_us
        rows[-1]["serial_floor_ms"] = 33 * per_iter_us * 1e-3
    print("pcg: " + json.dumps(rows))
    return rows


def check_solver_determinism():
    """Two runs of ba_solve_fast on the card are bit-identical."""
    for K, P, M, share in ((8, 1024, 8, 0.8), (64, 32768, 24, 0.15)):
        prob, cam, _ = ba_case(K, P, M, share, seed=3, mono_mix=K == 8)
        a = ba_mod.ba_solve_fast(prob, cam, n_iters=5,
                                 chunk=steps_mod._ba_chunk(P))
        b = ba_mod.ba_solve_fast(prob, cam, n_iters=5,
                                 chunk=steps_mod._ba_chunk(P))
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise SystemExit(f"ba_solve_fast is not deterministic at K={K}")
        if not bool(torch.isfinite(a.cost)):
            raise SystemExit(f"ba_solve_fast cost is not finite at K={K}")
        ms = cuda_ms(lambda: ba_mod.ba_solve_fast(
            prob, cam, n_iters=10, chunk=steps_mod._ba_chunk(P)), 3)
        print(f"ba_solve_fast K={K} P={P} M={M}: two runs bit-identical, "
              f"10 LM iterations in {ms:.2f} ms")


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------

def render_corridor(n_frames):
    """The KITTI-shaped corridor's first n_frames stereo pairs (float32),
    rendered by a pool of processes, and their true positions."""
    q_gt, t_gt = synthetic.corridor_trajectory(n_frames, step=0.25)
    workers = len(os.sched_getaffinity(0))
    t0 = time.perf_counter()
    frames = list(make_synth_seq.render_stereo_frames(
        0, CAM, q_gt, t_gt, z_far=60.0, workers=workers))
    print(f"rendered {n_frames} stereo frames {CAM.width}x{CAM.height} on the "
          f"host in {time.perf_counter() - t0:.1f} s with {workers} processes")
    return frames, t_gt


def reset_counts():
    """Every count to zero, just before a path is driven."""
    pose_opt.pose_optimize.launches = 0
    ba_prep.prep_terms.launches = 0
    ba_prep.compact_points.launches = 0
    pcg.pcg_solve.launches = 0
    torch_ops.reset_host_fetch_count()


def drive_path(frames, t_gt, local_ba: bool, vocab=None):
    """Drive System.track_stereo over `frames`; returns (launch counts,
    report, the BA solves' inputs). Without a vocabulary the System has no
    keyframe database and no loop closing; with local_ba it runs local
    bundle adjustment on every keyframe once the map has three, without, its
    tracker's run_local_ba is switched off. With a vocabulary (the loop
    path) the System is built as a user builds it, System(CFG, vocab): local
    BA, every keyframe registered in the keyframe database and queried for
    loops, a verified loop corrected and followed by global BA."""
    n_frames = len(frames)
    label = ("loop path" if vocab is not None
             else "BA path" if local_ba else "no-BA path")
    if vocab is not None:
        system = system_mod.System(CFG, vocab)
    else:
        system = system_mod.System(CFG, None, enable_loop_closing=False)
    tracker = system.tracker
    if not local_ba:
        tracker.run_local_ba = False
    phase_ms = {"extract": [], "keyframe": [], "local_ba": [], "kfdb": []}
    loop = {"queries": [], "consistent": 0, "sim3_attempts": 0, "loops": []}

    def timed(fn, key):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            phase_ms[key][-1] += (time.perf_counter() - t) * 1e3
            return out
        return wrapper

    # valid observations of every K1 launch: the masks are only kept here
    # (no operation is queued inside the timed frames); they are summed and
    # fetched once after the path
    masks = []
    real_pose_cuda = pose_opt._pose_optimize_cuda

    def counting_pose_cuda(q0, t0, obs, *a, **kw):
        masks.append(obs.mask)
        return real_pose_cuda(q0, t0, obs, *a, **kw)

    # the inputs of every BA solve (K2's workspace without its output
    # buffers, and the starting poses and points), only kept here; K2 is
    # timed alone on them after the path. The path's peak memory leaves them
    # out: the allocator's peak is read and reset where a solve starts and
    # where it ends (host calls, nothing queued), and each span's peak is
    # taken less the inputs kept from the solves that had ended before it
    solves = []
    mem = {"peak": 0, "kept": 0}
    real_prepare_solve = ba_mod._prepare_solve
    real_solve = ba_mod.ba_solve_fast

    def span_peak():
        mem["peak"] = max(mem["peak"],
                          torch.cuda.max_memory_allocated() - mem["kept"])
        torch.cuda.reset_peak_memory_stats()

    def keeping_prepare_solve(prob, chunk):
        span_peak()
        sc = real_prepare_solve(prob, chunk)
        solves.append((sc.ws._replace(buffers=None), prob.q, prob.t, prob.pw))
        return sc

    def solve_then_keep(*a, **kw):
        out = real_solve(*a, **kw)
        span_peak()
        ws, *rest = solves[-1]
        mem["kept"] += sum(x.numel() * x.element_size()
                           for x in (*ws[:-1], *rest))
        return out

    # the loop path's keyframe database and loop closer: the database
    # insert + query timed and its outputs kept (candidate masks, word ids,
    # fetched after the path), consistent candidates, Sim3 attempts and
    # accepted loops counted
    real_query = lc_mod._detect_loop_query
    if vocab is not None:
        closer = system.loop_closer
        real_detect = closer._detect
        real_sim3 = closer.compute_sim3
        real_correct = closer.correct_loop

        def query(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = real_query(*a, **kw)
            torch.cuda.synchronize()
            phase_ms["kfdb"][-1] += (time.perf_counter() - t) * 1e3
            loop["queries"].append((out[1], out[2], out[3]))
            return out

        def detect(*a, **kw):
            out = real_detect(*a, **kw)
            loop["consistent"] += len(out)
            return out

        def sim3(*a, **kw):
            loop["sim3_attempts"] += 1
            return real_sim3(*a, **kw)

        def correct(shared, match, **kw):
            out = real_correct(shared, match, **kw)
            est = np.stack([_np_inverse(q.astype(np.float64),
                                        t.astype(np.float64))[1]
                            for _, _, q, t in tracker.export_poses()])
            n = len(est)
            loop["loops"].append({
                "frame": tracker.frame_id, "kf_query": match.kf_query,
                "kf_match": match.kf_match, "n_matches": match.n_matches,
                "ate_m_after": float(np.sqrt(np.mean(np.sum(
                    (est - t_gt[:n]) ** 2, axis=-1))))})
            return out

        lc_mod._detect_loop_query = query
        closer._detect, closer.compute_sim3 = detect, sim3
        closer.correct_loop = correct

    real_extract = frame_mod.extract_frame
    real_local_ba = steps_mod.local_ba_step
    pose_opt._pose_optimize_cuda = counting_pose_cuda
    ba_mod._prepare_solve = keeping_prepare_solve
    ba_mod.ba_solve_fast = solve_then_keep
    frame_mod.extract_frame = timed(real_extract, "extract")
    steps_mod.local_ba_step = timed(real_local_ba, "local_ba")
    tracker._create_keyframe = timed(tracker._create_keyframe, "keyframe")

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_counts()
    frame_ms, fetches, syncs, sync_sites = [], [], [], []
    torch.cuda.set_sync_debug_mode("warn")
    try:
        for i, (left, right) in enumerate(frames):
            for key in phase_ms:
                phase_ms[key].append(0.0)
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
        steps_mod.local_ba_step = real_local_ba
        pose_opt._pose_optimize_cuda = real_pose_cuda
        ba_mod._prepare_solve = real_prepare_solve
        ba_mod.ba_solve_fast = real_solve
        lc_mod._detect_loop_query = real_query
    span_peak()
    launches = {"pose_opt": pose_opt.pose_optimize.launches,
                "ba_prep": ba_prep.prep_terms.launches,
                "ba_prep_compact": ba_prep.compact_points.launches,
                "pcg": pcg.pcg_solve.launches}
    system.shutdown()
    n_valid = torch.cat([m.reshape(-1, m.shape[-1]).sum(dim=-1)
                         for m in masks]).cpu().numpy()
    print(f"{label}: valid observations per pose_opt launch: mean "
          f"{n_valid.mean():.1f}, max {int(n_valid.max())}, min "
          f"{int(n_valid.min())} of {CFG.caps.max_features} slots "
          f"({len(n_valid)} launches)")

    # what came out
    traj = tracker.trajectory
    lost = [r.frame_id for r in traj[1:] if r.lost]
    est = np.stack([_np_inverse(r.q.astype(np.float64),
                                r.t.astype(np.float64))[1] for r in traj])

    def ate(n):
        return float(np.sqrt(np.mean(np.sum((est[:n] - t_gt[:n]) ** 2,
                                            axis=-1))))

    shared = system.shared
    off_card = [k for k, v in shared.state._asdict().items() if not v.is_cuda]
    finite = bool(np.isfinite(est).all()) and all(
        bool(torch.isfinite(v).all()) for v in
        (shared.state.kf_q, shared.state.kf_t, shared.state.mp_pos))
    is_kf = [m > 0.0 for m in phase_ms["keyframe"]]
    is_ba = [m > 0.0 for m in phase_ms["local_ba"]]
    n_ba = int(sum(is_ba))
    plain = [i for i in range(1, n_frames) if not is_kf[i]]
    track_ms = [frame_ms[i] - phase_ms["extract"][i] - phase_ms["keyframe"][i]
                for i in range(n_frames)]

    def median(values):
        values = list(values)
        return statistics.median(values) if values else None

    report = {
        "frames": n_frames, "lost": lost, "n_kf": shared.n_kf,
        "n_mp": shared.n_mp, "ate_m": ate(n_frames),
        "ate_m_first_30_frames": ate(min(30, n_frames)),
        "launches": launches, "local_bas": n_ba,
        "keyframes_spawned": int(sum(is_kf)),
        "keyframes_culled": (shared.n_created
                             - int(shared.state.kf_valid.sum())),
        "frame_ms_median": median(frame_ms[1:]),
        "frame_ms_median_no_keyframe": median(frame_ms[i] for i in plain),
        "extract_ms_median": median(phase_ms["extract"][1:]),
        "track_ms_median": median(track_ms[1:]),
        "keyframe_ms_median": median(
            m for m, ba in zip(phase_ms["keyframe"], is_ba)
            if m > 0.0 and ba == local_ba),
        "local_ba_ms_median": median(m for m in phase_ms["local_ba"] if m > 0),
        "host_fetches_per_frame_median": median(fetches[1:]),
        "host_fetches_per_keyframe_frame_median": median(
            fetches[i] for i in range(1, n_frames) if is_kf[i]),
        "device_syncs_per_frame_median_no_keyframe": median(
            syncs[i] for i in plain),
        "device_syncs_per_keyframe_frame_median": median(
            syncs[i] for i in range(1, n_frames) if is_kf[i]),
        "device_syncs_per_frame_max": max(syncs[1:]),
        "max_memory_allocated_mb": mem["peak"] / 2 ** 20,
        "kept_solve_inputs_mb": mem["kept"] / 2 ** 20,
        "pose_opt_valid_obs_mean": float(n_valid.mean()),
        "pose_opt_valid_obs_max": int(n_valid.max()),
    }
    print(f"{label}: " + json.dumps(report))
    print(f"{label}: ms per tracked frame (median, no keyframe) "
          f"{report['frame_ms_median_no_keyframe']:.2f}")
    print(f"{label}: ms per keyframe (median) "
          f"{report['keyframe_ms_median']:.2f}")
    if local_ba:
        print(f"{label}: ms per local BA (median of {n_ba}) "
              f"{report['local_ba_ms_median']:.2f}")
        print(f"{label}: keyframes culled {report['keyframes_culled']}")
    print(f"{label}: per keyframe frame, device syncs "
          f"{report['device_syncs_per_keyframe_frame_median']} and counted "
          f"host fetches {report['host_fetches_per_keyframe_frame_median']} "
          "(medians)")
    print(f"{label}: peak device memory "
          f"{report['max_memory_allocated_mb']:.1f} MB")
    # where the card made the host wait, on the last frame without a keyframe
    # and on the last frame with one
    for what, idx in (("tracked frame", plain[-1]),
                      ("keyframe frame", max(i for i in range(n_frames)
                                             if is_kf[i]))):
        counts = {}
        for site in sync_sites[idx]:
            counts[site] = counts.get(site, 0) + 1
        print(f"{label} sync sites, {what} {idx}: " + json.dumps(counts))
    problems = []
    if lost:
        problems.append(f"frames lost after the first: {lost}")
    if shared.n_kf < 3:
        problems.append(f"only {shared.n_kf} keyframes")
    if not finite or not report["ate_m"] < 0.15:
        problems.append(f"ATE {report['ate_m']:.4f} m against ground truth "
                        "(need < 0.15)")
    if launches["pose_opt"] < 2 * (n_frames - 1):
        problems.append(f"pose_opt kernel launched {launches['pose_opt']} "
                        f"times (need >= {2 * (n_frames - 1)})")
    if local_ba:
        if n_ba < 5:
            problems.append(f"only {n_ba} local bundle adjustments ran")
        if launches["ba_prep"] < 19 * n_ba:
            problems.append(f"ba_prep kernel launched {launches['ba_prep']} "
                            f"times in {n_ba} local BAs (need >= 19 each)")
        if launches["pcg"] < 15 * n_ba:
            problems.append(f"pcg kernel launched {launches['pcg']} times in "
                            f"{n_ba} local BAs (need >= 15 each)")
        if launches["ba_prep_compact"] < 2 * n_ba:
            problems.append(f"ba_prep compaction kernel launched "
                            f"{launches['ba_prep_compact']} times in {n_ba} "
                            "local BAs (need >= 2 each: one per solve)")
    elif launches["ba_prep"] or launches["pcg"] or n_ba \
            or launches["ba_prep_compact"]:
        problems.append("local bundle adjustment ran although switched off")
    if off_card:
        problems.append(f"MapState tensors not on the card: {off_card}")
    n_gba = len(loop["loops"])
    if local_ba and len(solves) != 2 * n_ba + n_gba:
        problems.append(f"{len(solves)} BA solves in {n_ba} local BAs and "
                        f"{n_gba} global BAs (need 2 and 1)")
    if vocab is not None:
        problems += loop_report(label, system, loop, phase_ms, fetches,
                                syncs, is_kf, report)
    if problems:
        raise SystemExit(f"{label} failed: " + "; ".join(problems))
    return launches, report, solves


def loop_report(label, system, loop, phase_ms, fetches, syncs, is_kf,
                report):
    """The loop path's own numbers, printed, and its gate: the keyframe
    database holds every live keyframe and no culled one, and every keyframe
    created was registered and queried. Returns the problems found. The
    candidate masks and word ids kept during the path are read here, after
    it; the words that the database's 1024-word cap drops are counted here,
    not in the package."""
    shared, closer = system.shared, system.loop_closer
    n_q = len(loop["queries"])
    M = closer.db.words.shape[1]
    cands, dropped = [], []
    for cand, words, valid in loop["queries"]:
        cands.append(int(cand.sum()))
        n_unique = torch.unique(words[valid & (words >= 0)]).numel()
        dropped.append(max(0, n_unique - M))
    n = shared.n_kf
    active = closer.db.active[:n].cpu().numpy()
    valid = shared.state.kf_valid[:n].cpu().numpy()
    live = sorted(shared.uid_slot.values())
    kfdb_ms = [m for m in phase_ms["kfdb"] if m > 0]
    out = {
        "keyframes_created": shared.n_created, "keyframes_live": len(live),
        "kfdb_queries": n_q,
        "kfdb_register_query_ms_median": statistics.median(kfdb_ms),
        "kfdb_register_query_ms_max": max(kfdb_ms),
        "candidates_per_keyframe_mean": float(np.mean(cands)),
        "candidates_per_keyframe_max": max(cands),
        "consistent_candidates_per_keyframe":
            loop["consistent"] / max(n_q, 1),
        "sim3_attempts_per_keyframe": loop["sim3_attempts"] / max(n_q, 1),
        "sim3_attempts": loop["sim3_attempts"],
        "loops_accepted": loop["loops"],
        "host_fetches_per_keyframe_frame_median":
            report["host_fetches_per_keyframe_frame_median"],
        "device_syncs_per_keyframe_frame_median":
            report["device_syncs_per_keyframe_frame_median"],
        "words_dropped_by_cap_per_keyframe_mean": float(np.mean(dropped)),
        "words_dropped_by_cap_per_keyframe_max": max(dropped),
        "kfdb_words_per_keyframe_cap": M}
    print(f"{label}, keyframe database and loop closing: " + json.dumps(out))
    print(f"{label}: ms per keyframe for KFDB registration and query "
          f"(median) {out['kfdb_register_query_ms_median']:.2f}; per keyframe "
          f"{out['candidates_per_keyframe_mean']:.2f} candidates, "
          f"{out['consistent_candidates_per_keyframe']:.2f} consistent, "
          f"{out['sim3_attempts_per_keyframe']:.2f} Sim3 attempts; "
          f"{len(loop['loops'])} loops accepted")
    problems = []
    if not (np.array_equal(active, valid)
            and list(np.nonzero(active)[0]) == live):
        problems.append(f"keyframe database rows {np.nonzero(active)[0]} "
                        f"are not the live keyframes {live}")
    if n_q != shared.n_created:
        problems.append(f"{n_q} database queries for {shared.n_created} "
                        "keyframes")
    return problems


def keyframe_centres(state):
    """Camera centres of every keyframe slot, on the host."""
    return se3.inverse(state.kf_q, state.kf_t)[1].cpu().numpy()


def drive_ring(vocab):
    """Loop correction with global BA at full width: the drifted ring of
    tests/torch_loop_cases.py (110 keyframes, the last 5 revisiting the first
    places, drift 0.01), its capacities CFG's except 128 keyframes, so global
    BA runs at (K, P, M) = (128, 32768, 24) and K3 at D = 768; as many points
    per cluster as 32768 slots hold with the revisit duplicates; the
    committed vocabulary. Driven through LoopCloser.process_keyframe and
    correct_loop(run_gba=True). Gates, as the JAX package's front-door test
    has them: a loop detected (not injected) with query >= 105 and match
    <= 8, the corrected query keyframe within 0.02 m, the tail keyframe's
    error down by 25 %, the mean error down. Returns (report, the global
    BA's problem, launches in global BA)."""
    caps = Capacities(max_keyframes=128, max_points=CFG.caps.max_points,
                      max_features=CFG.caps.max_features,
                      local_points=CFG.caps.local_points)
    cfg = torch_loop_cases.CFG.replace(caps=caps, loop=LoopConfig())
    n_pts = max(n for n in range(1, caps.max_points)
                if torch_loop_cases.ring_points(RING_KF, RING_REV, n)
                <= caps.max_points)
    t0 = time.perf_counter()
    shared, (_, ts_gt) = torch_loop_cases.build_drifted_ring(
        n_kf=RING_KF, n_rev=RING_REV, n_pts_per=n_pts, drift=RING_DRIFT,
        cfg=cfg, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ts_gt = np.stack(ts_gt)
    closer = lc_mod.LoopCloser(cfg, vocab)

    def errs():
        return np.linalg.norm(keyframe_centres(shared.state)[:RING_KF]
                              - ts_gt, axis=1)

    before = errs()
    ms = {k: [] for k in ("detect", "compute_sim3", "correct_and_fuse",
                          "essential_graph", "gba")}
    gba = {"launches": None, "prob": None}
    patched, last_call = [], {}

    def timed(owner, name, key):
        real = getattr(owner, name)

        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = real(*a, **kw)
            torch.cuda.synchronize()
            ms[key].append((time.perf_counter() - t) * 1e3)
            last_call[name] = (real, a, kw)
            return out
        patched.append((owner, name, real))
        setattr(owner, name, wrapper)

    def warm_ms(name):
        """The last call of `name` again, once its kernels and torch.func's
        transforms are warm (its first call in a process pays for both)."""
        real, a, kw = last_call[name]
        torch.cuda.synchronize()
        t = time.perf_counter()
        real(*a, **kw)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    def in_gba(st, cfg_, n_iters=None):
        before_l = (ba_prep.prep_terms.launches, pcg.pcg_solve.launches,
                    ba_prep.compact_points.launches)
        real_solve = ba_mod.ba_solve_fast

        def keep(prob, *a, **kw):
            gba["prob"] = prob
            return real_solve(prob, *a, **kw)
        ba_mod.ba_solve_fast = keep
        try:
            out = real_gba(st, cfg_, n_iters)
        finally:
            ba_mod.ba_solve_fast = real_solve
        gba["launches"] = {
            "ba_prep": ba_prep.prep_terms.launches - before_l[0],
            "pcg": pcg.pcg_solve.launches - before_l[1],
            "ba_prep_compact":
                ba_prep.compact_points.launches - before_l[2]}
        return out

    real_gba = lc_mod.global_bundle_adjustment
    patched.append((lc_mod, "global_bundle_adjustment", real_gba))
    timed(lc_mod, "_detect_loop_query", "detect")
    timed(closer, "compute_sim3", "compute_sim3")
    for owner, name in ((lc_mod, "correct_neighborhood"),
                        (lc_mod.mapping, "fuse_into_neighborhood"),
                        (lc_mod.mapping, "rebuild_observations"),
                        (lc_mod.steps, "recompute_covisibility")):
        timed(owner, name, "correct_and_fuse")
    for owner, name in ((lc_mod, "build_essential_edges"),
                        (lc_mod.pg, "optimize_pose_graph"),
                        (lc_mod, "apply_pose_graph_result")):
        timed(owner, name, "essential_graph")
    lc_mod.global_bundle_adjustment = in_gba
    timed(lc_mod, "global_bundle_adjustment", "gba")

    matches = []
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    try:
        for k in range(RING_KF):
            m = closer.process_keyframe(shared, k)
            if m is not None:
                matches.append(m)
                closer.correct_loop(shared, m, run_gba=True)
        torch.cuda.synchronize()
    finally:
        for owner, name, real in reversed(patched):
            setattr(owner, name, real)
    wall_s = time.perf_counter() - t0
    launches = {"pose_opt": pose_opt.pose_optimize.launches,
                "ba_prep": ba_prep.prep_terms.launches,
                "ba_prep_compact": ba_prep.compact_points.launches,
                "pcg": pcg.pcg_solve.launches}
    after = errs()
    # warm repeats of the host-bound stages, on the map as it now stands
    # (their results are dropped)
    warm = {f"{name}_warm_ms": warm_ms(name) for name in
            ("compute_sim3", "optimize_pose_graph") if name in last_call}
    report = {
        "keyframes": RING_KF, "revisit_keyframes": RING_REV,
        "points_per_cluster": n_pts, "point_slots_used": shared.n_mp,
        "point_slots": caps.max_points, "build_s": build_s, "wall_s": wall_s,
        "loops": [{"kf_query": m.kf_query, "kf_match": m.kf_match,
                   "n_matches": m.n_matches, "s": m.s} for m in matches],
        "err_query_m": float(after[matches[0].kf_query]) if matches
        else None,
        "err_tail_m_before": float(before[-1]),
        "err_tail_m_after": float(after[-1]),
        "err_mean_m_before": float(before.mean()),
        "err_mean_m_after": float(after.mean()),
        "detect_ms_per_keyframe_median": statistics.median(ms["detect"]),
        "detect_ms_total": sum(ms["detect"]),
        "compute_sim3_ms": ms["compute_sim3"],
        "correct_and_fuse_ms": sum(ms["correct_and_fuse"]),
        "essential_graph_ms": sum(ms["essential_graph"]),
        "gba_ms": ms["gba"], **warm, "launches": launches,
        "gba_launches": gba["launches"],
        "host_fetches": torch_ops.host_fetch_count(),
        "max_memory_allocated_mb": torch.cuda.max_memory_allocated() / 2**20}
    print("ring: " + json.dumps(report))
    problems = []
    if not matches:
        problems.append("no loop detected through process_keyframe")
    else:
        m = matches[0]
        if m.kf_query < RING_KF - RING_REV or m.kf_match > 8:
            problems.append(f"loop {m.kf_query} -> {m.kf_match} (need query "
                            f">= {RING_KF - RING_REV}, match <= 8)")
        if not report["err_query_m"] < 0.02:
            problems.append("corrected query keyframe "
                            f"{report['err_query_m']:.4f} m off "
                            "(need < 0.02)")
    if not after[-1] < 0.75 * before[-1]:
        problems.append(f"tail error {after[-1]:.4f} m against "
                        f"{before[-1]:.4f} before (need 25 % less)")
    if not after.mean() < before.mean():
        problems.append(f"mean error {after.mean():.4f} m against "
                        f"{before.mean():.4f} before")
    gl = gba["launches"]
    if gl is None or gl["ba_prep"] < 10 or gl["pcg"] < 10:
        problems.append(f"global BA launched K2 / K3 {gl} (need >= 10 each)")
    if problems:
        raise SystemExit("ring failed: " + "; ".join(problems))
    return report, gba["prob"], gl


def check_gba_kernels(label, prob, cam, chunk):
    """K2 and K3 on a global BA's own problem at its first LM build: K2
    against its plain version (1e-3 of each output's scale, two launches
    bit-identical), timed alone beside its first design, with its bound on
    this workspace; K3 on that build's reduced camera system through
    check_pcg_kernel (energy norm, bit-identical, the path D selects); and
    two whole solves of the problem (10 LM iterations) bit-identical.
    Returns (K2 row, K3 row with a warm start)."""
    K = prob.q.shape[0]
    P, M = prob.obs_kf.shape
    a, b = (ba_mod.ba_solve_fast(prob, cam, n_iters=10, chunk=chunk)
            for _ in range(2))
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise SystemExit(f"{label}: two solves are not bit-identical")
    print(f"{label}: two solves of 10 LM iterations bit-identical, cost "
          f"{float(a.cost):.6g}")
    del a, b
    sc = ba_mod._prepare_solve(prob, chunk)
    lam = torch.full((1,), 1e-4, device="cuda")
    args = (prob.q, prob.t, prob.pw, lam, cam, D2M, D2S, True)
    k = ba_prep.prep_terms(sc.ws, *args)
    torch.cuda.synchronize()
    kept = ba_prep.PrepTerms(*[a.clone() for a in k])
    p32 = ba_prep._prep_terms_plain(sc.ws, *args)
    errs = {n: scale_err(a, b) for n, a, b in zip(kept._fields, kept, p32)}
    worst = max(errs.values())
    finite = all(bool(torch.isfinite(a).all()) for a in kept)
    again = ba_prep.prep_terms(sc.ws, *args)
    same = all(torch.equal(a, b) for a, b in zip(again, kept))
    if not finite or worst > 1e-3 or not same:
        raise SystemExit(f"ba_prep kernel on {label} (K={K} P={P} M={M}): "
                         f"errors over scale {errs} (tolerance 1e-3), "
                         f"bit-identical launches: {same}")
    times = k2_times(sc.ws, args, reps_plain=3)
    bound_ms, bound_by = prep_bound_ms(sc.ws, K, listed=True)
    row = {"name": "ba_prep", "on": label, "K": K, "P": P, "M": M,
           "listed_points": int(sc.ws.n_points),
           "active_slots": int(sc.ws.active.sum()),
           "max_err_over_scale": worst, **times,
           "bound_ms": bound_ms, "bound_by": bound_by}
    system, row["assembly_ms"] = reduced_system(kept, sc, lam)
    print(f"{label}, ba_prep: " + json.dumps(row))
    del sc, kept, p32, k, again
    torch.cuda.empty_cache()
    print(f"{label}, pcg on its reduced camera system:")
    k3 = check_pcg_kernel({6 * K: system})
    return row, next(r for r in k3 if r["warm_start"])


def bench_gba():
    """Global BA at the benchmark's size (bench.py's GBA: build_problem(),
    K = 256, P = 65536, M = 8; 10 LM iterations, chunk 8192): a finite cost,
    ms per solve (CUDA events, median of 3), and one traced solve's device
    busy / idle split by kernel family.
    g2o's time for the reference's global BA on KITTI 00 (a CPU) stands
    beside it, no gate. Returns (report, problem, camera, launches)."""
    fields, cam = ba_problem.build_problem()
    prob = convert.ba_problem_from_numpy(fields, "cuda")

    def solve():
        return ba_mod.ba_solve_fast(prob, cam, n_iters=10, chunk=8192)

    solve()
    torch.cuda.synchronize()
    reset_counts()
    a = solve()
    torch.cuda.synchronize()
    launches = {"ba_prep": ba_prep.prep_terms.launches,
                "ba_prep_compact": ba_prep.compact_points.launches,
                "pcg": pcg.pcg_solve.launches}
    if not bool(torch.isfinite(a.cost)):
        raise SystemExit("bench GBA: cost not finite")
    wall = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solve()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    ms = cuda_ms(solve, 3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        solve()
        torch.cuda.synchronize()
    report = {"K": prob.q.shape[0], "P": prob.obs_kf.shape[0],
              "M": prob.obs_kf.shape[1], "n_iters": 10, "chunk": 8192,
              "ms_per_solve": ms, "wall_ms_median": statistics.median(wall),
              "cost": float(a.cost), "launches": launches,
              "g2o_gba_ms_kitti00_cpu": G2O_GBA_MS_KITTI00}
    report.update(summarize(prof, 1, report["wall_ms_median"], "solve"))
    print("bench GBA: " + json.dumps(report))
    print(f"bench GBA: {ms:.2f} ms per solve (10 LM iterations), device "
          f"busy {report['device_busy_ms_per_solve']:.2f} ms; the reference's "
          f"g2o global BA on KITTI 00 took {G2O_GBA_MS_KITTI00} ms on a CPU "
          "(BASELINE.md), a yardstick, no gate")
    return report, prob, cam, launches


def prep_real_maps(solves, n_iters=(5, 10)):
    """K2 on the workspaces the BA path's local bundle adjustments built (two
    solves each: 5 LM iterations with the Huber kernel, then 10 without; a
    solve launches K2 once per iteration and twice in cost-only mode): per
    solve the listed points and active slots, K2 alone in full mode (present
    and first design in turns) and in cost-only mode, and prep_bound_ms on
    that workspace, charging the listed points only (the others were
    zero-filled once per solve). Fresh output buffers; the map is not
    touched."""
    lam = torch.full((1,), 1e-4, device="cuda")
    rows = []
    for j, (ws, q, t, pw) in enumerate(solves):
        P, M = ws.kf.shape
        ws = ws._replace(buffers=tuple(
            torch.zeros(shape, device="cuda")
            for shape in ((18, P, M), (18, P, M), (33, P, M), (6, P), (3, P),
                          (P, M), (P, M))))
        args = (q, t, pw, lam, CAM, D2M, D2S, j % 2 == 0)
        times = k2_times(ws, args)
        bound_ms, bound_by = prep_bound_ms(ws, q.shape[0], listed=True)
        builds = n_iters[j % 2]
        rows.append({
            "local_ba": j // 2, "solve": j % 2,
            "listed_points": int(ws.n_points), "P": P, "M": M,
            "active_slots": int(ws.active.sum()),
            "ms": times["kernel_ms"], "ms_v1": times["ms_v1"],
            "ms_stream": times["kernel_ms_stream"],
            "ms_v1_stream": times["ms_v1_stream"],
            "cost_only_ms": times["cost_only_ms"],
            "wrapper_ms": times["wrapper_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "cost_only_bound_ms": prep_bound_ms(ws, q.shape[0], True,
                                                listed=True)[0],
            "k2_ms_in_solve": builds * times["kernel_ms"]
            + 2 * times["cost_only_ms"],
            "k2_ms_in_solve_v1": builds * times["ms_v1"]
            + 2 * times["cost_only_ms"]})
        del ws, args
    print("ba_prep, real maps: " + json.dumps(rows))
    per_ba = {}
    for r in rows:
        acc = per_ba.setdefault(r["local_ba"], [0.0, 0.0])
        acc[0] += r["k2_ms_in_solve"]
        acc[1] += r["k2_ms_in_solve_v1"]
    summary = {
        "solves": len(rows),
        "listed_points_median": statistics.median(
            r["listed_points"] for r in rows),
        "active_slots_median": statistics.median(
            r["active_slots"] for r in rows),
        "ms_median": statistics.median(r["ms"] for r in rows),
        "ms_v1_median": statistics.median(r["ms_v1"] for r in rows),
        "ms_stream_median": statistics.median(r["ms_stream"] for r in rows),
        "bound_ms_median": statistics.median(r["bound_ms"] for r in rows),
        "bound_share_median": statistics.median(
            r["bound_ms"] / r["ms"] for r in rows),
        "k2_ms_per_local_ba_median": statistics.median(
            v[0] for v in per_ba.values()),
        "k2_ms_per_local_ba_v1_median": statistics.median(
            v[1] for v in per_ba.values())}
    print("ba_prep, real maps, medians: " + json.dumps(summary))
    return summary


# ---------------------------------------------------------------------------
# the 660-frame loop corridor through the single-agent driver
# ---------------------------------------------------------------------------

def _sync_warnings(caught):
    return sum("synchroniz" in str(w.message) for w in caught)


class Patches:
    """Wrappers set on module or class attributes for one driven run and
    taken off again (restore) whatever the run did."""

    def __init__(self):
        self.real = []

    def __call__(self, owner, name, make):
        real = getattr(owner, name)
        self.real.append((owner, name, real))
        setattr(owner, name, make(real))

    def restore(self):
        for owner, name, real in reversed(self.real):
            setattr(owner, name, real)
        self.real.clear()


def timed(ms, key, cur=None, flag=None):
    """A wrapper maker for Patches: each call is timed between two
    synchronizes into ms[key], and cur[flag] is set first."""
    def make(real):
        def wrapper(*a, **kw):
            if flag:
                cur[flag] = True
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = real(*a, **kw)
            torch.cuda.synchronize()
            ms[key].append((time.perf_counter() - t) * 1e3)
            return out
        return wrapper
    return make


def render_corridor_sequence(work):
    """Trial 0 of the accuracy protocol's sequence: make_synth_seq seed 0,
    660 frames, rendered once by a pool of processes for the single-agent
    and the split phases. Returns (directory, seconds, processes)."""
    seq_dir = os.path.join(work, "seq0")
    workers = len(os.sched_getaffinity(0))
    t0 = time.perf_counter()
    make_synth_seq.main(["-o", seq_dir, "--seed", str(CORRIDOR_SEED),
                         "--frames", str(CORRIDOR_FRAMES),
                         "--workers", str(workers)])
    render_s = time.perf_counter() - t0
    print(f"corridor: rendered {CORRIDOR_FRAMES} stereo frames 512x288 on "
          f"the host in {render_s:.1f} s with {workers} processes")
    return seq_dir, render_s, workers


def drive_corridor(seq_dir, work, render_s, workers):
    """The single-agent driver run_single on the corridor's first
    CORRIDOR_SINGLE_FRAMES frames, on
    the card with the committed vocabulary and the settings' default
    capacities (512 keyframes, 65536 points, 24 observations, 1024 feature
    slots, 8192 local points), then genstats. Every frame is timed
    (synchronize at its end) and its host waits counted
    (set_sync_debug_mode), and so are each keyframe, local BA, global BA
    and relocalization. Gate (PERF.md): ATE mean < CORRIDOR_ATE_GATE_M and
    at least CORRIDOR_EXPORTED_GATE of the frames exported; the path
    launched K1 twice a tracked frame and K2 / K3 19 / 15 times a local BA.
    Returns (System, report, launches, the first solve of the last local
    BA)."""
    out_dir = os.path.join(work, "out0")

    frames, cur = [], {"caught": [], "kf": False, "reloc": False,
                       "lba_first": False}
    ms = {k: [] for k in ("keyframe", "local_ba", "gba", "reloc")}
    reloc_rows, gba_launches, kept = [], [], {}
    loops = {"detected": 0, "sim3_attempts": 0}
    patch = Patches()

    def track_stereo(real):
        def wrapper(self, left, right, frame_id=None):
            cur["kf"] = cur["reloc"] = False
            before = torch_ops.host_fetch_count()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                cur["caught"] = caught
                t = time.perf_counter()
                out = real(self, left, right, frame_id)
                torch.cuda.synchronize()
                frame_ms = (time.perf_counter() - t) * 1e3
            frames.append({"ms": frame_ms, "syncs": _sync_warnings(caught),
                           "fetches": torch_ops.host_fetch_count() - before,
                           "kf": cur["kf"], "reloc": cur["reloc"],
                           "ok": self.tracker.state == TrackerState.OK})
            return out
        return wrapper

    def local_ba(real):
        inner = timed(ms, "local_ba")(real)

        def wrapper(*a, **kw):
            cur["lba_first"] = True
            return inner(*a, **kw)
        return wrapper

    def solve(real):
        def wrapper(prob, *a, **kw):
            if cur["lba_first"]:
                kept["lba_prob"] = prob
                cur["lba_first"] = False
            return real(prob, *a, **kw)
        return wrapper

    def gba(real):
        inner = timed(ms, "gba")(real)

        def wrapper(*a, **kw):
            l0 = (ba_prep.prep_terms.launches, pcg.pcg_solve.launches)
            out = inner(*a, **kw)
            gba_launches.append({
                "ba_prep": ba_prep.prep_terms.launches - l0[0],
                "pcg": pcg.pcg_solve.launches - l0[1]})
            return out
        return wrapper

    def relocalize(real):
        def wrapper(*a, **kw):
            cur["reloc"] = True
            k1, s0 = pose_opt.pose_optimize.launches, len(cur["caught"])
            f0 = torch_ops.host_fetch_count()
            torch.cuda.synchronize()
            t = time.perf_counter()
            ok = real(*a, **kw)
            torch.cuda.synchronize()
            ms["reloc"].append((time.perf_counter() - t) * 1e3)
            reloc_rows.append({
                "ok": bool(ok), "k1": pose_opt.pose_optimize.launches - k1,
                "syncs": _sync_warnings(cur["caught"][s0:]),
                "fetches": torch_ops.host_fetch_count() - f0})
            return ok
        return wrapper

    def process_keyframe(real):
        def wrapper(*a, **kw):
            m = real(*a, **kw)
            loops["detected"] += m is not None
            return m
        return wrapper

    def compute_sim3(real):
        def wrapper(*a, **kw):
            loops["sim3_attempts"] += 1
            return real(*a, **kw)
        return wrapper

    patch(system_mod.System, "track_stereo", track_stereo)
    patch(tracker_mod.Tracker, "_create_keyframe",
          timed(ms, "keyframe", cur, "kf"))
    patch(steps_mod, "local_ba_step", local_ba)
    patch(ba_mod, "ba_solve_fast", solve)
    patch(lc_mod, "global_bundle_adjustment", gba)
    patch(reloc_mod, "relocalize", relocalize)
    patch(lc_mod.LoopCloser, "process_keyframe", process_keyframe)
    patch(lc_mod.LoopCloser, "compute_sim3", compute_sim3)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        system, summary = run_single.run(
            ["-t", "stereo_synth", "-d", seq_dir,
             "-s", os.path.join(seq_dir, "settings.json"), "-o", out_dir,
             "--max-frames", str(CORRIDOR_SINGLE_FRAMES), "--device", "cuda"])
    finally:
        torch.cuda.set_sync_debug_mode("default")
        patch.restore()
    run_s = time.perf_counter() - t0
    launches = {"pose_opt": pose_opt.pose_optimize.launches,
                "ba_prep": ba_prep.prep_terms.launches,
                "ba_prep_compact": ba_prep.compact_points.launches,
                "pcg": pcg.pcg_solve.launches}
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    ev = genstats.evaluate(os.path.join(seq_dir, "gt_tum.txt"),
                           os.path.join(out_dir, "CameraTrajectory.txt"))

    def median(values):
        values = list(values)
        return statistics.median(values) if values else None

    tracked = [f for f in frames[1:] if f["ok"] and not f["kf"]
               and not f["reloc"]]
    kf_frames = [f for f in frames[1:] if f["kf"]]
    n_lba = len(ms["local_ba"])
    cfg = system.cfg
    report = {
        "frames": CORRIDOR_SINGLE_FRAMES, "render_s": render_s,
        "render_processes": workers, "run_s": run_s,
        "caps": dataclasses.asdict(cfg.caps),
        "ate_mean_m": ev["ate"] if ev else None,
        "ate_rmse_m": ev["ate_rmse"] if ev else None,
        "jax_ate_mean_m": JAX_ATE_TRIAL0_M,
        "rpe_t_m_per_frame": ev["rpe_t"] if ev else None,
        "rpe_t_m_per_m": ev["rpe_t_per_m"] if ev else None,
        "rpe_r_deg": ev["rpe_r"] if ev else None,
        "scale": ev["scale"] if ev else None,
        "frames_exported": ev["n"] if ev else 0,
        "frames_lost": summary["lost"],
        "relocalizations": summary["relocalizations"],
        "relocalization_attempts": len(reloc_rows),
        "loops_detected": loops["detected"],
        "loops_corrected": summary["loops_corrected"],
        "sim3_attempts": loops["sim3_attempts"],
        "keyframes_created": summary["keyframes_created"],
        "keyframes_live": summary["keyframes_live"],
        "slot_recycling":
            summary["keyframes_created"] > cfg.caps.max_keyframes,
        "keyframe_slots_high_water": system.shared.n_kf,
        "point_compactions": system.shared.n_compactions,
        "point_stalls": system.shared.n_point_stalls,
        "tracked_frame_ms_median": median(f["ms"] for f in tracked),
        "keyframe_frame_ms_median": median(f["ms"] for f in kf_frames),
        "keyframe_ms_median": median(ms["keyframe"]),
        "local_ba_ms_median": median(ms["local_ba"]),
        "local_ba_ms_max": max(ms["local_ba"], default=None),
        "local_bas": n_lba,
        "gba_ms": ms["gba"], "gba_launches": gba_launches,
        "reloc_ms": ms["reloc"],
        "syncs_per_tracked_frame_median": median(f["syncs"] for f in tracked),
        "syncs_per_keyframe_frame_median": median(f["syncs"]
                                                  for f in kf_frames),
        "syncs_per_relocalization_median": median(r["syncs"]
                                                  for r in reloc_rows),
        "fetches_per_tracked_frame_median": median(f["fetches"]
                                                   for f in tracked),
        "fetches_per_relocalization_median": median(r["fetches"]
                                                    for r in reloc_rows),
        "max_memory_allocated_mb": peak_mb,
        "launches": launches,
        "pose_opt_launches_in_relocalization": sum(r["k1"]
                                                   for r in reloc_rows),
    }
    print("corridor: " + json.dumps(report))
    if ev:
        print(f"corridor: ATE mean {ev['ate']:.4f} m, RMSE "
              f"{ev['ate_rmse']:.4f} m (the JAX package's trial 0, all "
              f"{CORRIDOR_FRAMES} frames: {JAX_ATE_TRIAL0_M} m); RPE-t "
              f"{ev['rpe_t']:.4f} m a frame, {ev['rpe_t_per_m']:.4f} m a "
              f"metre; {ev['n']} of {CORRIDOR_SINGLE_FRAMES} frames "
              f"exported, {summary['lost']} lost, "
              f"{summary['relocalizations']} relocalizations, "
              f"{loops['detected']} loops detected, "
              f"{summary['loops_corrected']} corrected; keyframes "
              f"{summary['keyframes_created']} created, "
              f"{summary['keyframes_live']} live")
    print(f"corridor: medians, ms: tracked frame "
          f"{report['tracked_frame_ms_median']}, keyframe "
          f"{report['keyframe_ms_median']}, local BA "
          f"{report['local_ba_ms_median']} ({n_lba}), global BA "
          f"{ms['gba']}; waits: tracked frame "
          f"{report['syncs_per_tracked_frame_median']}, keyframe frame "
          f"{report['syncs_per_keyframe_frame_median']}, relocalization "
          f"{report['syncs_per_relocalization_median']}; peak device memory "
          f"{peak_mb:.1f} MB; launches K1 / K2 / K3 {launches['pose_opt']} / "
          f"{launches['ba_prep']} / {launches['pcg']} (K1 in "
          f"relocalization: {report['pose_opt_launches_in_relocalization']})")
    problems = []
    if ev is None or not np.isfinite(ev["ate"]) \
            or not ev["ate"] < CORRIDOR_ATE_GATE_M:
        problems.append(f"ATE {ev and ev['ate']} m (need < "
                        f"{CORRIDOR_ATE_GATE_M})")
    if report["frames_exported"] < \
            CORRIDOR_EXPORTED_GATE * CORRIDOR_SINGLE_FRAMES:
        problems.append(f"{report['frames_exported']} frames exported (need "
                        f">= {CORRIDOR_EXPORTED_GATE:.0%} of "
                        f"{CORRIDOR_SINGLE_FRAMES})")
    if launches["pose_opt"] < 2 * len(tracked):
        problems.append(f"pose_opt launched {launches['pose_opt']} times for "
                        f"{len(tracked)} tracked frames (need 2 each)")
    if n_lba < 5 or launches["ba_prep"] < 19 * n_lba \
            or launches["pcg"] < 15 * n_lba:
        problems.append(f"K2 / K3 launched {launches['ba_prep']} / "
                        f"{launches['pcg']} times in {n_lba} local BAs (need "
                        "19 / 15 each, and 5 local BAs)")
    if any(g["ba_prep"] < 10 or g["pcg"] < 10 for g in gba_launches):
        problems.append(f"a global BA launched K2 / K3 {gba_launches}")
    if problems:
        raise SystemExit("corridor failed: " + "; ".join(problems))
    return system, report, launches, kept["lba_prob"]


def kidnap(system):
    """The map trial 0 left: two black frames (the tracker gets LOST), then
    a frame rendered at the corridor's pose KIDNAP_FRAME. The tracker must be
    OK again, n_relocalizations up by one, and the camera centre within
    0.1 m of the true one (in the map's frame, which is the first camera's).
    The frame that relocalizes is timed, its waits and K1 launches counted.
    Returns (report, K1 launches in the relocalization)."""
    q_wc, t_wc = make_synth_seq.loop_trajectory(CORRIDOR_FRAMES, 1.0, 24.0,
                                                seed=CORRIDOR_SEED)
    cam = make_synth_seq.camera()
    left, right, _ = synthetic.BoxScene(seed=CORRIDOR_SEED,
                                        z_far=30.0).render_stereo(
        cam, q_wc[KIDNAP_FRAME], t_wc[KIDNAP_FRAME])
    black = np.zeros((cam.height, cam.width), np.float32)
    tracker = system.tracker
    n0 = system.n_relocalizations
    states = []
    for j in range(2):
        system.track_stereo(black, black, frame_id=CORRIDOR_FRAMES + j)
        states.append(tracker.state)
    k1 = pose_opt.pose_optimize.launches
    fetches = torch_ops.host_fetch_count()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t = time.perf_counter()
            system.track_stereo(left, right, frame_id=CORRIDOR_FRAMES + 2)
            torch.cuda.synchronize()
            frame_ms = (time.perf_counter() - t) * 1e3
    finally:
        torch.cuda.set_sync_debug_mode("default")
    k1 = pose_opt.pose_optimize.launches - k1
    # the true centre in the map's frame (the first camera's)
    R0 = synthetic._quat_to_matrix(q_wc[0]).astype(np.float64)
    want = R0.T @ (t_wc[KIDNAP_FRAME] - t_wc[0])
    got = _np_inverse(tracker.last_q.cpu().numpy().astype(np.float64),
                      tracker.last_t.cpu().numpy().astype(np.float64))[1]
    err = float(np.linalg.norm(got - want))
    report = {"frame": KIDNAP_FRAME, "states_after_black": states,
              "state": tracker.state,
              "relocalizations": system.n_relocalizations - n0,
              "ref_kf": tracker.ref_kf, "centre_err_m": err,
              "frame_ms": frame_ms, "pose_opt_launches": k1,
              "frame_syncs": _sync_warnings(caught),
              "frame_host_fetches": torch_ops.host_fetch_count() - fetches,
              "inliers": int((tracker.last_frame_mp >= 0).sum())}
    print("kidnap: " + json.dumps(report))
    if states != [TrackerState.LOST] * 2 or tracker.state != TrackerState.OK \
            or report["relocalizations"] != 1 or not err < 0.1:
        raise SystemExit(f"kidnap failed: {report} (need LOST, LOST, then "
                         "OK by one relocalization within 0.1 m)")
    return report, k1


def checkpoint(system, work):
    """save_map of the map, load_map into a fresh System: every MapState
    field bit-equal, and n_kf, n_mp and n_created equal."""
    path = os.path.join(work, "map.npz")
    t = time.perf_counter()
    system.save_map(path)
    save_s = time.perf_counter() - t
    fresh = system_mod.System(system.cfg, system.vocab, device=system.device)
    t = time.perf_counter()
    fresh.load_map(path)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t
    a, b = system.shared, fresh.shared
    differ = [k for k, v in a.state._asdict().items()
              if not torch.equal(getattr(b.state, k), v)]
    report = {"fields": len(a.state), "fields_differ": differ,
              "n_kf": [a.n_kf, b.n_kf], "n_mp": [a.n_mp, b.n_mp],
              "n_created": [a.n_created, b.n_created],
              "file_mb": os.path.getsize(path) / 2 ** 20,
              "save_s": save_s, "load_s": load_s,
              "database_rows": int(fresh.loop_closer.db.active.sum())}
    print("checkpoint: " + json.dumps(report))
    if differ or (a.n_kf, a.n_mp, a.n_created) != (b.n_kf, b.n_mp,
                                                   b.n_created) \
            or report["database_rows"] != len(a.uid_slot):
        raise SystemExit(f"checkpoint failed: {report}")
    return report


# ---------------------------------------------------------------------------
# the same corridor split between two agents under the multi-agent server
# ---------------------------------------------------------------------------

def drive_split(seq_dir, work):
    """The corridor split in two halves through generic_split_seq -n 2 as a
    user runs it (default capacities, the committed vocabulary, loop closing
    and global BA on): agent 0 tracks frames 0-329, agent 1 frames 330-659,
    whose last stretch revisits agent 0's start, where the maps fuse. Every
    frame is timed (synchronize at its end), each keyframe, local BA, global
    BA, Sim3 attempt and fusion too; host waits are counted per tracked
    frame, per keyframe frame and per fusion (set_sync_debug_mode). Gate
    (PERF.md): one final map, at least one fusion, each agent's ATE mean <
    CORRIDOR_ATE_GATE_M and at least CORRIDOR_EXPORTED_GATE of its frames
    exported. Returns (server, report, launches, the problem of the first
    post-fusion global BA)."""
    out_dir = os.path.join(work, "split0")
    frames, fusions, sim3, ms = [], [], [], {"keyframe": [], "local_ba": [],
                                             "gba": []}
    cur = {"kf": False, "reloc": False, "fusing": False, "detecting": False}
    kept, gba_launches, loops = {}, [], {"detected": 0}
    patch = Patches()

    def track_stereo(real):
        def wrapper(self, left, right, frame_id=None):
            cur["kf"] = False
            s0 = len(caught)
            t = time.perf_counter()
            out = real(self, left, right, frame_id)
            torch.cuda.synchronize()
            frames.append({"agent": self.agent,
                           "ms": (time.perf_counter() - t) * 1e3,
                           "syncs": _sync_warnings(caught[s0:]),
                           "kf": cur["kf"],
                           "ok": self.state == TrackerState.OK})
            return out
        return wrapper

    def fuse(real):
        def wrapper(self, agent, match, sim3_ms):
            s0, f0 = len(caught), torch_ops.host_fetch_count()
            l0 = (ba_prep.prep_terms.launches, pcg.pcg_solve.launches)
            cur["fusing"] = True
            t = time.perf_counter()
            try:
                real(self, agent, match, sim3_ms)
            finally:
                cur["fusing"] = False
            fusions.append({
                "agent": agent, "kf_query": match.kf_query,
                "kf_match": match.kf_match, "n_matches": match.n_matches,
                "ms": (time.perf_counter() - t) * 1e3,
                "syncs": _sync_warnings(caught[s0:]),
                "fetches": torch_ops.host_fetch_count() - f0,
                "gba_ba_prep": ba_prep.prep_terms.launches - l0[0],
                "gba_pcg": pcg.pcg_solve.launches - l0[1]})
        return wrapper

    def fusion_query(real):
        def wrapper(*a, **kw):
            cur["detecting"] = True
            try:
                return real(*a, **kw)
            finally:
                cur["detecting"] = False
        return wrapper

    def compute_sim3(real):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            m = real(*a, **kw)
            torch.cuda.synchronize()
            sim3.append({"fusion": cur["detecting"],
                         "ms": (time.perf_counter() - t) * 1e3,
                         "ok": m is not None})
            return m
        return wrapper

    def solve(real):
        def wrapper(prob, *a, **kw):
            if cur["fusing"] and "fusion_prob" not in kept:
                kept["fusion_prob"] = prob
            return real(prob, *a, **kw)
        return wrapper

    def gba(real):
        inner = timed(ms, "gba")(real)

        def wrapper(*a, **kw):
            l0 = (ba_prep.prep_terms.launches, pcg.pcg_solve.launches)
            out = inner(*a, **kw)
            gba_launches.append({
                "fusion": cur["fusing"],
                "ba_prep": ba_prep.prep_terms.launches - l0[0],
                "pcg": pcg.pcg_solve.launches - l0[1]})
            return out
        return wrapper

    def process_keyframe(real):
        def wrapper(*a, **kw):
            m = real(*a, **kw)
            loops["detected"] += m is not None
            return m
        return wrapper

    Server = server_mod.MultiAgentServer
    patch(tracker_mod.Tracker, "track_stereo", track_stereo)
    patch(tracker_mod.Tracker, "_create_keyframe",
          timed(ms, "keyframe", cur, "kf"))
    patch(steps_mod, "local_ba_step", timed(ms, "local_ba"))
    patch(ba_mod, "ba_solve_fast", solve)
    patch(lc_mod, "global_bundle_adjustment", gba)
    patch(lc_mod.LoopCloser, "process_keyframe", process_keyframe)
    patch(lc_mod.LoopCloser, "compute_sim3", compute_sim3)
    patch(Server, "_fuse", fuse)
    patch(Server, "_insert_keyframe_fusion", fusion_query)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            server, summary = generic_split_seq.run(
                ["-t", "stereo_synth", "-n", "2", "-d", seq_dir,
                 "-s", os.path.join(seq_dir, "settings.json"),
                 "-o", out_dir, "--device", "cuda"])
    finally:
        torch.cuda.set_sync_debug_mode("default")
        patch.restore()
    run_s = time.perf_counter() - t0
    launches = {"pose_opt": pose_opt.pose_optimize.launches,
                "ba_prep": ba_prep.prep_terms.launches,
                "ba_prep_compact": ba_prep.compact_points.launches,
                "pcg": pcg.pcg_solve.launches}
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    gt = os.path.join(seq_dir, "gt_tum.txt")
    evs = [genstats.evaluate(gt, os.path.join(out_dir, f"SLAM{a}.txt"))
           for a in range(2)]
    n_agent = [len(s) for s in datasets.load_synth_stereo(seq_dir).split(2)]

    def median(values):
        values = list(values)
        return statistics.median(values) if values else None

    tracked = [f for f in frames if f["ok"] and not f["kf"]]
    kf_frames = [f for f in frames if f["kf"]]
    fusion_sim3 = [x for x in sim3 if x["fusion"]]
    st = server.shared.state
    valid = st.kf_valid.cpu().numpy()
    report = {
        "frames": CORRIDOR_FRAMES, "frames_per_agent": n_agent,
        "run_s": run_s, "caps": dataclasses.asdict(server.cfg.caps),
        "final_maps": summary["final_maps"], "fusions": summary["fusions"],
        "relocalizations": summary["relocalizations"],
        "ate_mean_m": [e["ate"] if e else None for e in evs],
        "ate_rmse_m": [e["ate_rmse"] if e else None for e in evs],
        "rpe_t_m_per_frame": [e["rpe_t"] if e else None for e in evs],
        "frames_exported": [e["n"] if e else 0 for e in evs],
        "frames_lost": [sum(r.lost for r in t.trajectory)
                        for t in server.trackers.values()],
        "jax_ate_mean_m": JAX_SPLIT_ATE_TRIAL0_M,
        "stats": server.stats, "fusion_events": fusions,
        "fusion_sim3_attempts": len(fusion_sim3),
        "fusion_sim3_ms": [x["ms"] for x in fusion_sim3],
        "loop_sim3_attempts": len(sim3) - len(fusion_sim3),
        "loop_sim3_ms_median": median(x["ms"] for x in sim3
                                      if not x["fusion"]),
        "loops_detected": loops["detected"],
        "keyframes_created": server.shared.n_created,
        "keyframes_live": int(valid.sum()),
        "keyframe_agents": sorted(set(
            st.kf_agent.cpu().numpy()[valid].tolist())),
        "keyframe_maps": sorted(set(st.kf_map.cpu().numpy()[valid].tolist())),
        "tracked_frame_ms_median": median(f["ms"] for f in tracked),
        "keyframe_frame_ms_median": median(f["ms"] for f in kf_frames),
        "keyframe_ms_median": median(ms["keyframe"]),
        "local_ba_ms_median": median(ms["local_ba"]),
        "local_bas": len(ms["local_ba"]),
        "gba_ms": ms["gba"], "gba_launches": gba_launches,
        "syncs_per_tracked_frame_median": median(f["syncs"] for f in tracked),
        "syncs_per_keyframe_frame_median": median(f["syncs"]
                                                  for f in kf_frames),
        "syncs_per_fusion": [f["syncs"] for f in fusions],
        "max_memory_allocated_mb": peak_mb,
        "launches": launches,
    }
    print("split: " + json.dumps(report))
    for row in server.stats:
        print("split: stats.csv row: " + ", ".join(
            f"{k} {row[k]:.2f}" if isinstance(row[k], float)
            else f"{k} {row[k]}" for k in (
                "sim3_ms", "mf_ms", "ckf", "cmp", "mkf", "mmp", "cd_ms",
                "n_cd", "gba_ms")))
    print(f"split: ATE mean agent0 / agent1 {report['ate_mean_m']} m (the "
          f"JAX package's trial 0: {JAX_SPLIT_ATE_TRIAL0_M[0]} / "
          f"{JAX_SPLIT_ATE_TRIAL0_M[1]} m); exported "
          f"{report['frames_exported']} of {n_agent}; final maps "
          f"{summary['final_maps']}, fusions {summary['fusions']}, "
          f"relocalizations {summary['relocalizations']}; run {run_s:.1f} s")
    print(f"split: medians, ms: tracked frame "
          f"{report['tracked_frame_ms_median']}, keyframe "
          f"{report['keyframe_ms_median']}, local BA "
          f"{report['local_ba_ms_median']} ({len(ms['local_ba'])}); waits: "
          f"tracked frame {report['syncs_per_tracked_frame_median']}, "
          f"keyframe frame {report['syncs_per_keyframe_frame_median']}, "
          f"fusion {report['syncs_per_fusion']}; fusion Sim3 attempts "
          f"{len(fusion_sim3)}; peak device memory {peak_mb:.1f} MB; "
          f"launches K1 / K2 / K3 {launches['pose_opt']} / "
          f"{launches['ba_prep']} / {launches['pcg']}")
    problems = []
    if summary["final_maps"] != 1 or summary["fusions"] < 1:
        problems.append(f"{summary['final_maps']} final maps, "
                        f"{summary['fusions']} fusions (need 1 and >= 1)")
    for a, (e, n) in enumerate(zip(evs, n_agent)):
        if e is None or not np.isfinite(e["ate"]) \
                or not e["ate"] < CORRIDOR_ATE_GATE_M:
            problems.append(f"agent {a}: ATE {e and e['ate']} m (need < "
                            f"{CORRIDOR_ATE_GATE_M})")
        if (e["n"] if e else 0) < CORRIDOR_EXPORTED_GATE * n:
            problems.append(f"agent {a}: {e and e['n']} of {n} frames "
                            f"exported (need >= "
                            f"{CORRIDOR_EXPORTED_GATE:.0%})")
    if report["keyframe_agents"] != [0, 1] or \
            len(report["keyframe_maps"]) != 1:
        problems.append(f"live keyframes of agents "
                        f"{report['keyframe_agents']} on maps "
                        f"{report['keyframe_maps']} (need both on one)")
    if launches["pose_opt"] < 2 * len(tracked) or \
            launches["ba_prep"] < 19 * len(ms["local_ba"]) or \
            launches["pcg"] < 15 * len(ms["local_ba"]):
        problems.append(f"launches {launches} for {len(tracked)} tracked "
                        f"frames and {len(ms['local_ba'])} local BAs")
    if "fusion_prob" not in kept or any(
            g["ba_prep"] < 10 or g["pcg"] < 10 for g in gba_launches):
        problems.append(f"global BAs launched K2 / K3 {gba_launches}")
    if problems:
        raise SystemExit("split failed: " + "; ".join(problems))
    return server, report, launches, kept["fusion_prob"]


def checkpoint_fused(server, work):
    """save_map / load_map of the fused map (both agents' keyframes under
    one map id): every MapState field bit-equal after the round trip."""
    sh = server.shared
    path = os.path.join(work, "fused.npz")
    t = time.perf_counter()
    ckpt_mod.save_map(path, sh.state, sh.n_kf, sh.n_mp,
                      extra={"n_created": sh.n_created})
    save_s = time.perf_counter() - t
    t = time.perf_counter()
    state, meta = ckpt_mod.load_map(path, sh.device)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t
    differ = [k for k, v in sh.state._asdict().items()
              if not torch.equal(getattr(state, k), v)]
    report = {"fields": len(state), "fields_differ": differ,
              "n_kf": [sh.n_kf, meta["n_kf"]], "n_mp": [sh.n_mp, meta["n_mp"]],
              "n_created": [sh.n_created, meta["n_created"]],
              "file_mb": os.path.getsize(path) / 2 ** 20,
              "save_s": save_s, "load_s": load_s}
    print("split checkpoint: " + json.dumps(report))
    if differ or (sh.n_kf, sh.n_mp, sh.n_created) != \
            (meta["n_kf"], meta["n_mp"], meta["n_created"]):
        raise SystemExit(f"fused map checkpoint failed: {report}")
    return report


def gba_keys(row, suffix):
    """A K2 or K3 row measured on a global BA's problem, as keys of the
    kernel's entry in the {"kernels": ...} line."""
    keys = {"K": "K", "D": "D", "path": "path",
            "max_err_over_scale": "max_err", "err_32_iters": "max_err",
            "energy_diff": "energy_norm_diff", "kernel_ms": "ms",
            "ms_v1": "ms_v1", "plain_ms": "plain_ms", "bound_ms": "bound_ms",
            "bound_by": "bound_by", "wrapper_ms": "wrapper_ms",
            "assembly_ms": "assembly_ms"}
    return {f"{new}_{suffix}": row[old] for old, new in keys.items()
            if old in row}


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

    # 2. build: one nvcc process per source, all started together
    t0 = time.perf_counter()
    cuda_build.load_libraries(["pose_opt", "ba_prep", "pcg"])
    for mod in (pose_opt, ba_prep, pcg):
        mod.load_kernel()
    print(f"built {sorted(cuda_build.build_seconds)} in "
          f"{time.perf_counter() - t0:.1f} s (nvcc seconds: "
          f"{json.dumps(cuda_build.build_seconds)})")
    for name, log in cuda_build.build_logs.items():
        used = [ln.strip() for ln in log.splitlines()
                if "Used" in ln or "spill" in ln]
        print(f"ptxas {name}: " + " | ".join(used))

    # 3. kernels against their plain versions
    k1, probe = check_pose_kernel()
    k2_rows, systems = check_prep_kernel()
    k3_rows = check_pcg_kernel(systems)
    check_pcg_cluster_sizes()
    del systems
    torch.cuda.empty_cache()
    check_solver_determinism()

    # 4. the paths without a vocabulary: with local bundle adjustment, then
    # without it on the first frames of the same corridor
    frames, t_gt = render_corridor(N_FRAMES_LOOP)
    ba_launches, ba_report, solves = drive_path(
        frames[:N_FRAMES_BA], t_gt[:N_FRAMES_BA], local_ba=True)
    k2_real = prep_real_maps(solves)
    del solves
    torch.cuda.empty_cache()
    no_ba_launches, no_ba_report, _ = drive_path(
        frames[:N_FRAMES_NO_BA], t_gt[:N_FRAMES_NO_BA], local_ba=False)
    print("ATE on the first 30 frames: "
          f"{ba_report['ate_m_first_30_frames']:.5f} m with local BA, "
          f"{no_ba_report['ate_m_first_30_frames']:.5f} m without")

    # 5. loop closing: the System as a user builds it (the committed
    # vocabulary; keyframe database, loop closing and global BA on) over the
    # whole corridor; then a loop corrected with global BA on the drifted
    # ring; then global BA at the benchmark's size. K2 and K3 are held
    # against their plain versions on both global BAs' own problems
    vocab = bow_mod.load_vocabulary()
    loop_launches, loop_report_, solves = drive_path(frames, t_gt,
                                                     local_ba=True,
                                                     vocab=vocab)
    del solves, frames
    torch.cuda.empty_cache()
    ring_report, ring_prob, ring_launches = drive_ring(vocab)
    ring_k2, ring_k3 = check_gba_kernels(
        "ring GBA", ring_prob, torch_loop_cases.CAM,
        steps_mod._ba_chunk(ring_prob.pw.shape[0]))
    del ring_prob
    torch.cuda.empty_cache()
    bench_report, bench_prob, bench_cam, bench_launches = bench_gba()
    bench_k2, bench_k3 = check_gba_kernels("bench GBA", bench_prob,
                                           bench_cam, 8192)
    del bench_prob
    torch.cuda.empty_cache()

    # 6. the 660-frame loop corridor (trial 0), rendered once: its first
    # half through the single-agent driver at the default capacities, with
    # the kidnap and the checkpoint on the map it left, and K2 and K3
    # against their plain versions on the first build of its last local BA,
    # at (512, 65536, 24) and D = 3072; then the whole corridor split
    # between two agents under the multi-agent server, the checkpoint of the
    # fused map, and K2 and K3 on the first post-fusion global BA's problem
    with tempfile.TemporaryDirectory() as work:
        seq_dir, render_s, workers = render_corridor_sequence(work)
        system, corridor, corridor_launches, lba_prob = drive_corridor(
            seq_dir, work, render_s, workers)
        kidnap_report, kidnap_k1 = kidnap(system)
        checkpoint(system, work)
        cam = system.cfg.camera
        del system
        torch.cuda.empty_cache()
        lba_k2, lba_k3 = check_gba_kernels(
            "corridor local BA", lba_prob, cam,
            steps_mod._ba_chunk(lba_prob.pw.shape[0]))
        del lba_prob
        torch.cuda.empty_cache()
        server, split, split_launches, fusion_prob = drive_split(seq_dir,
                                                                 work)
        checkpoint_fused(server, work)
    del server
    torch.cuda.empty_cache()
    fusion_k2, fusion_k3 = check_gba_kernels(
        "fusion GBA", fusion_prob, cam,
        steps_mod._ba_chunk(fusion_prob.pw.shape[0]))
    del fusion_prob

    # 7. the record: each kernel at the shape its main path gives it, its
    # launches read right after each path; K2 and K3 also at the two global
    # BAs' shapes and the corridor's local BA
    k2 = k2_rows[0]                                   # K=64 P=32768 M=24
    k3 = next(r for r in k3_rows if r["D"] == 384 and r["warm_start"])
    kernels = [{
        "name": "pose_opt", "route": "cuda",
        "source": "multiagent_orb_slam2_tpu_torch/csrc/pose_opt.cu",
        "replaces": "multiagent_orb_slam2_tpu/optim/pose_opt_pallas.py:117",
        "launches": ba_launches["pose_opt"],
        "launches_no_ba_path": no_ba_launches["pose_opt"],
        "launches_loop_path": loop_launches["pose_opt"],
        "launches_corridor": corridor_launches["pose_opt"],
        "launches_reloc": corridor["pose_opt_launches_in_relocalization"],
        "launches_kidnap_reloc": kidnap_k1,
        "launches_split": split_launches["pose_opt"],
        "max_abs_err": k1["max_err"],
        "ms": k1["kernel_ms"], "ms_v1": k1["ms_v1"],
        "wrapper_ms": k1["wrapper_ms"], "wrapper_ms_v1": k1["wrapper_ms_v1"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
        "library_ms": None,
        "serial_floor_ms": probe["serial_floor_ms"],
        "threads": probe["threads"],
        "blocks_per_pose": probe["blocks_per_pose"],
    }, {
        "name": "ba_prep", "route": "cuda",
        "source": "multiagent_orb_slam2_tpu_torch/csrc/ba_prep.cu",
        "replaces": "multiagent_orb_slam2_tpu/optim/ba_pallas.py:33",
        "launches": ba_launches["ba_prep"],
        "max_abs_err": k2["max_err_over_scale"],
        "ms": k2["kernel_ms"], "ms_v1": k2["ms_v1"],
        "wrapper_ms": k2["wrapper_ms"], "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
        "library_ms": None,
        "ms_stream_launches": k2["kernel_ms_stream"],
        "cost_only_ms": k2["cost_only_ms"],
        "compaction_ms": k2["compaction_ms"],
        "compaction_launches": ba_launches["ba_prep_compact"],
        "ms_real_maps": k2_real["ms_median"],
        "ms_v1_real_maps": k2_real["ms_v1_median"],
        "bound_ms_real_maps": k2_real["bound_ms_median"],
        "listed_points_real_maps": k2_real["listed_points_median"],
        "active_slots_real_maps": k2_real["active_slots_median"],
        "launches_loop_path": loop_launches["ba_prep"],
        "launches_ring_gba": ring_launches["ba_prep"],
        "launches_bench_gba": bench_launches["ba_prep"],
        "launches_corridor": corridor_launches["ba_prep"],
        "launches_split": split_launches["ba_prep"],
        **gba_keys(ring_k2, "ring_gba"), **gba_keys(bench_k2, "bench_gba"),
        **gba_keys(lba_k2, "corridor_lba"),
        **gba_keys(fusion_k2, "fusion_gba"),
    }, {
        "name": "pcg", "route": "cuda",
        "source": "multiagent_orb_slam2_tpu_torch/csrc/pcg.cu",
        "replaces": "multiagent_orb_slam2_tpu/optim/ba_kernels.py:298",
        "launches": ba_launches["pcg"],
        "max_abs_err": k3["err_32_iters"],
        "err_2_iters": k3["err_2_iters"],
        "energy_norm_diff": k3["energy_diff"],
        "energy_norm_err_plain": k3["energy_err_plain"],
        "ms": k3["kernel_ms"], "ms_v1": k3["ms_v1"], "path": k3["path"],
        "wrapper_ms": k3["wrapper_ms"], "wrapper_ms_v1": k3["wrapper_ms_v1"],
        "plain_ms": k3["plain_ms"],
        "bound_ms": k3["bound_ms"], "bound_by": k3["bound_by"],
        "library_ms": None,
        "cholesky_solve_ms": k3["cholesky_solve_ms"],
        "serial_floor_ms": k3["serial_floor_ms"],
        "launches_loop_path": loop_launches["pcg"],
        "launches_ring_gba": ring_launches["pcg"],
        "launches_bench_gba": bench_launches["pcg"],
        "launches_corridor": corridor_launches["pcg"],
        "launches_split": split_launches["pcg"],
        **gba_keys(ring_k3, "ring_gba"), **gba_keys(bench_k3, "bench_gba"),
        **gba_keys(lba_k3, "corridor_lba"),
        **gba_keys(fusion_k3, "fusion_gba"),
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
