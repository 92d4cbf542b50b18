"""Agents' stereo streams through the port's multi-agent server.

The served path: ``server.MultiAgentServer`` with one tracker an agent,
local BA, culling, each agent's loop closing and the server's fusion
detection on. Round robin, one frame of each agent in turn, then
``process_new_keyframes``, as ``drivers/generic_split_seq.run_server``
drives it. Closed loop: a camera hands its next frame once the pose of the
last is on the host.

Frames: the configuration's corridor (``render.CardScene``, textures drawn
from the seed) along ``render.loop_trajectory``, cut into one contiguous
stretch an agent, rendered on the card in set-up and handed to the port as
host uint8 arrays, as a camera delivers them. Set-up runs through every
agent's initialisation and first local BA; running out of frames in the
window is a failure, never a short window.

Traffic parameters (``traffic/<name>.json``): ``agents``,
``frames_per_agent``, and which local BAs and pose optimizations (K1) of
the window are replayed by the plain references (``checked_local_bas`` of
the first ``sample_from_first``, ``checked_k1`` of the first
``k1_sample_from_first``, drawn from the seed).

The control (``slambench.control``) puts the plain pose optimization with
TF32 operands in K1's place for the whole run, and solves the checked local
BAs with the TF32 reference besides.
"""
from __future__ import annotations

import gc
import random
import sys
import time

import numpy as np
import torch

from .. import gbamap, render, roofline, stats, trace
from ..reference import ate as ref_ate
from ..reference import ba as ref_ba
from ..reference import pose as ref_pose
from . import gba_replay

RENDER_BATCH = 8           # frames rendered in one call on the card


def slam_config(cfg: dict):
    """The port's SlamConfig of a configuration file."""
    from multiagent_orb_slam2_tpu_torch import config as pc
    from multiagent_orb_slam2_tpu_torch.geometry.camera import Intrinsics
    c, o = cfg["camera"], cfg["orb"]
    fps = float(c["fps"])
    return pc.SlamConfig(
        camera=Intrinsics(fx=c["fx"], fy=c["fy"], cx=c["cx"], cy=c["cy"],
                          bf=c["bf"], width=c["width"], height=c["height"]),
        sensor=pc.Sensor.STEREO, fps=fps,
        orb=pc.OrbConfig(n_features=o["n_features"],
                         scale_factor=o["scale_factor"],
                         n_levels=o["n_levels"], ini_th_fast=o["ini_th_fast"],
                         min_th_fast=o["min_th_fast"]),
        tracking=pc.TrackingConfig(max_frames_between_kf=int(fps),
                                   th_depth=cfg["th_depth"]),
        caps=pc.Capacities(**cfg["capacities"]))


def make_frames(cfg: dict, traffic: dict, seed: int, device):
    """(frames [agents][i] = (left, right) host uint8, gt [agents] camera
    centres [n, 3]): the loop path cut into one stretch an agent."""
    st = cfg["stream"]
    n_ag, n = traffic["agents"], traffic["frames_per_agent"]
    q_wc, t_wc = render.loop_trajectory(n_ag * n, st["z_lo"], st["z_hi"],
                                        seed=gbamap.sub_seed(seed, 100))
    scene = render.CardScene.from_seed(gbamap.sub_seed(seed, 101), device,
                                       **st["scene"])
    cam = cfg["camera"]
    H, W = cam["height"], cam["width"]
    R = torch.tensor(np.stack([render.quat_to_rot_np(q) for q in q_wc]),
                     dtype=torch.float64, device=device)
    t = torch.tensor(t_wc, dtype=torch.float64, device=device)
    host = np.empty((n_ag * n, 2, H, W), np.uint8)
    for i in range(0, n_ag * n, RENDER_BATCH):
        j = i + RENDER_BATCH
        left, right = scene.render_stereo_u8(cam, R[i:j], t[i:j])
        host[i:j] = torch.stack([left, right], 1).cpu().numpy()
    del scene
    frames = [[(host[a * n + i, 0], host[a * n + i, 1]) for i in range(n)]
              for a in range(n_ag)]
    gt = [t_wc[a * n:(a + 1) * n] for a in range(n_ag)]
    return frames, gt


def rot_to_quat(R):
    """(w, x, y, z) of a rotation matrix [3, 3], w >= 0."""
    m = R.double()
    tr = float(torch.trace(m))
    d = [float(m[i, i]) for i in range(3)]
    if tr > 0:
        s = 2 * np.sqrt(tr + 1)
        q = [s / 4, (m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s,
             (m[1, 0] - m[0, 1]) / s]
    else:
        i = int(np.argmax(d))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = 2 * np.sqrt(1 + d[i] - d[j] - d[k])
        q = [0.0] * 4
        q[0] = (m[k, j] - m[j, k]) / s
        q[1 + i] = s / 4
        q[1 + j] = (m[j, i] + m[i, j]) / s
        q[1 + k] = (m[k, i] + m[i, k]) / s
    q = torch.stack([torch.as_tensor(x, dtype=torch.float64,
                                     device=R.device) for x in q])
    return q if q[0] >= 0 else -q


def _poses(q0, t0, obs, q, t):
    """[(q0, t0, obs fields, q, t)] of one pose optimization's call, one
    entry a pose (the call takes one pose or a batch)."""
    one = (lambda x: x[None]) if q0.dim() == 1 else (lambda x: x)
    q0, t0, q, t = (one(x) for x in (q0, t0, q, t))
    fields = [one(x) for x in obs]
    return [(q0[i].clone(), t0[i].clone(), [x[i].clone() for x in fields],
             q[i].clone(), t[i].clone()) for i in range(q0.shape[0])]


class GcPauses:
    """Python's garbage collections while it is in ``gc.callbacks``: how
    many, and the seconds they held the host."""

    def __init__(self):
        self.n, self.s, self._t = 0, 0.0, None

    def __call__(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.n += 1
            self.s += time.perf_counter() - self._t
            self._t = None


class K1Control:
    """The plain pose optimization with TF32 operands, in the program's
    place: the same arguments and returns as the port's
    ``pose_optimize``."""

    def __init__(self, cfg: dict):
        self.cam = cfg["camera"]
        self.args = (cfg["pose_opt"]["rounds"], cfg["pose_opt"]["iterations"],
                     cfg["gba"]["chi2_mono"], cfg["gba"]["chi2_stereo"])

    def __call__(self, q0, t0, obs):
        qs, ts, inl = [], [], []
        for a, b, f, _, _ in _poses(q0, t0, obs, q0, t0):
            R, t, keep = ref_pose.solve(a, b, *f, self.cam, *self.args,
                                        precision="tf32")
            qs.append(rot_to_quat(R).to(q0.dtype))
            ts.append(t.to(t0.dtype))
            inl.append(keep)
        q, t, keep = torch.stack(qs), torch.stack(ts), torch.stack(inl)
        n = keep.sum(-1).to(torch.int32)
        if q0.dim() == 1:
            return q[0], t[0], keep[0], n[0]
        return q, t, keep, n


class Probe:
    """The harness's spans and counters around calls into the port's
    layers, installed on the port's modules for one run and removed after:
    local BA (timed with the card synchronised at both ends), the BA
    solves it makes (captured for the check when asked), every BA solve's
    and pose optimization's work by their inputs' masks (on the card, read
    after the stretch), and the front end."""

    def __init__(self, device):
        from multiagent_orb_slam2_tpu_torch.ops import frame as frame_mod
        from multiagent_orb_slam2_tpu_torch.optim import ba as ba_mod
        from multiagent_orb_slam2_tpu_torch.optim import pose_opt
        from multiagent_orb_slam2_tpu_torch.runtime import steps
        self.mods = dict(steps=steps, ba=ba_mod, pose_opt=pose_opt,
                         frame=frame_mod)
        self.orig = dict(lba=steps.local_ba_step, solve=ba_mod.ba_solve_fast,
                         pose=pose_opt.pose_optimize,
                         extract=frame_mod.extract_frame)
        self.device = device
        self.agent = 0
        self.lba_per_agent = {}
        self.lba_s = []            # durations of the window's local BAs
        self.recording = False     # inside the window
        self.checked = set()       # the window's local BAs to capture
        self.captured = []         # [(fields, n_iters, use_huber, answer)]
        self.capturing = False
        self.in_lba = False
        self.work = False          # count solves' and K1's work (traced)
        # [slots, points, live poses, poses, iterations, in local BA, P]
        self.ba_counts = []
        self.k1_valid = []
        self.k1_calls = 0          # the window's pose optimizations so far
        self.k1_checked = set()    # ... to capture
        self.k1_captured = []      # [(q0, t0, obs, q, t)], one pose each
        self.k1_control = None     # the control in K1's place
        self.wrappers = {}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def install(self):
        m, o = self.mods, self.orig

        def local_ba(*a, **k):
            self.capturing = self.recording and len(self.lba_s) in self.checked
            self._sync()
            t0 = time.perf_counter()
            self.in_lba = True
            with trace.span("local_ba"):
                out = o["lba"](*a, **k)
            self._sync()
            dt = time.perf_counter() - t0
            self.capturing = self.in_lba = False
            self.lba_per_agent[self.agent] = \
                self.lba_per_agent.get(self.agent, 0) + 1
            if self.recording:
                self.lba_s.append(dt)
            return out

        def solve(prob, cam, n_iters=10, use_huber=True, *a, **k):
            res = o["solve"](prob, cam, n_iters, use_huber, *a, **k)
            if self.capturing:
                f = {n: getattr(prob, n).clone() for n in gbamap.FIELDS}
                self.captured.append((f, n_iters, use_huber,
                                      (res.q.clone(), res.t.clone(),
                                       res.pw.clone(), res.cost.clone())))
            if self.work:
                act = prob.obs_mask & (prob.obs_kf >= 0) \
                    & prob.point_valid[:, None]
                seen = torch.zeros(prob.pose_valid.shape[0],
                                   dtype=torch.int32, device=act.device)
                seen.scatter_add_(0, prob.obs_kf.long().clamp(min=0)
                                  .reshape(-1), act.reshape(-1).int())
                live = (seen > 0) & prob.pose_valid & ~prob.pose_fixed
                self.ba_counts.append(torch.stack([
                    act.sum(), act.any(1).sum(), live.sum(),
                    prob.pose_valid.sum(),
                    torch.full((), n_iters, device=act.device),
                    torch.full((), int(self.in_lba), device=act.device),
                    torch.full((), act.shape[0], device=act.device)]))
            return res

        def pose(q0, t0, obs, *a, **k):
            if self.work:
                self.k1_valid.append(obs.mask.sum())
            if self.k1_control is not None:
                out = self.k1_control(q0, t0, obs)
            else:
                out = o["pose"](q0, t0, obs, *a, **k)
            if self.recording:
                if self.k1_calls in self.k1_checked:
                    for one in _poses(q0, t0, obs, out[0], out[1]):
                        self.k1_captured.append(one)
                self.k1_calls += 1
            return out

        def extract(*a, **k):
            with trace.span("front_end"):
                return o["extract"](*a, **k)

        self.wrappers = dict(lba=local_ba, solve=solve, pose=pose,
                             extract=extract)
        for key, w in self.wrappers.items():
            # the port counts launches on its functions' attributes
            # (``pose_optimize.launches``): the wrapper carries them
            w.__dict__.update(o[key].__dict__)
            setattr(*self._slot(key), w)

    def _slot(self, key):
        mod, name = {"lba": ("steps", "local_ba_step"),
                     "solve": ("ba", "ba_solve_fast"),
                     "pose": ("pose_opt", "pose_optimize"),
                     "extract": ("frame", "extract_frame")}[key]
        return self.mods[mod], name

    def remove(self):
        for key, w in self.wrappers.items():
            orig = self.orig[key]
            orig.__dict__.update({k: w.__dict__[k] for k in orig.__dict__})
            setattr(*self._slot(key), orig)


def run(ctx) -> dict:
    from multiagent_orb_slam2_tpu_torch.server import MultiAgentServer
    from multiagent_orb_slam2_tpu_torch.utils import torch_ops
    from multiagent_orb_slam2_tpu_torch.vocab import bow

    cfg, tr, seconds = ctx.cell.config, ctx.cell.traffic, ctx.seconds
    dev = ctx.device
    scfg = slam_config(cfg)
    t0 = time.perf_counter()
    vocab = bow.load_vocabulary(device=dev)
    t1 = time.perf_counter()
    frames, gt = make_frames(cfg, tr, ctx.seed, dev)
    print(f"set-up: start {t0 - ctx.t0:.2f} s, vocabulary {t1 - t0:.2f} s, "
          f"frames {time.perf_counter() - t1:.2f} s", file=sys.stderr)
    n_ag, n_fr = tr["agents"], tr["frames_per_agent"]
    server = MultiAgentServer(scfg, vocab, device=dev)
    trackers = [server.register_client(a) for a in range(n_ag)]
    probe = Probe(dev)
    if ctx.control:
        probe.k1_control = K1Control(cfg)
    probe.install()
    try:
        return _drive(ctx, cfg, tr, seconds, frames, gt, server, trackers,
                      probe, torch_ops, n_ag, n_fr)
    finally:
        probe.remove()


def _drive(ctx, cfg, tr, seconds, frames, gt, server, trackers, probe,
           torch_ops, n_ag, n_fr):
    state = {"i": 0, "frames": 0, "lost": 0, "frame_s": [], "kf_s": 0.0,
             "kf_n": 0}

    def one_round(timed: bool):
        i = state["i"]
        if i >= n_fr:
            raise RuntimeError("the stream ran out of frames")
        for a in range(n_ag):
            probe.agent = a
            left, right = frames[a][i]
            t0 = time.perf_counter()
            pose = trackers[a].track_stereo(left, right, frame_id=i)
            if pose is not None:
                [x.cpu() for x in pose]            # the pose on the host
            dt = time.perf_counter() - t0
            if timed:
                state["frames"] += 1
                state["frame_s"].append(dt)
                state["lost"] += pose is None
        n_new = sum(len(t.new_kf_slots) for t in trackers)
        t0 = time.perf_counter()
        with trace.span("server"):
            server.process_new_keyframes()
        if timed and n_new:
            state["kf_s"] += time.perf_counter() - t0
            state["kf_n"] += n_new
        state["i"] = i + 1

    # set-up: every agent initialised and through its first local BA
    while not all(probe.lba_per_agent.get(a, 0) >= 1 for a in range(n_ag)):
        one_round(False)
    ctx.sync()
    gc.collect()
    gc.freeze()            # later collections leave the set-up's objects out
    setup_s = time.perf_counter() - ctx.t0
    print(f"set-up: {setup_s:.2f} s, {state['i']} rounds to every agent's "
          "first local BA", file=sys.stderr)
    pauses = GcPauses()
    gc.callbacks.append(pauses)

    rng = random.Random(ctx.seed)
    probe.checked = set(rng.sample(range(tr["sample_from_first"]),
                                   tr["checked_local_bas"]))
    probe.k1_checked = set(rng.sample(range(tr["k1_sample_from_first"]),
                                      tr["checked_k1"]))
    fus0, rel0 = len(server.stats), server.n_relocalizations

    def stretch(until: float):
        probe.recording = True
        t0 = time.perf_counter()
        waits0 = torch_ops.host_fetch_count()
        n0 = state["frames"]
        while time.perf_counter() - t0 < until:
            one_round(True)
        probe.recording = False
        return (time.perf_counter() - t0, state["frames"] - n0,
                torch_ops.host_fetch_count() - waits0)

    out = {"setup_s": setup_s}
    lay = ctx.layer_ctx
    if not ctx.trace:
        window, n, waits = stretch(seconds)
        if not probe.lba_s:
            raise RuntimeError("no local BA in the window")
        out["e2e"] = {"local_ba_ms": 1e3 * stats.mean(probe.lba_s),
                      "setup_s": setup_s}
    else:
        window, n, waits = stretch(seconds / 2)
        fs = state["frame_s"]
        lay.update(frames_per_s=stats.rate(n, window),
                   frame_ms=[1e3 * x for x in fs],
                   host_waits_per_frame=waits / n,
                   keyframe_ms=(1e3 * state["kf_s"] / state["kf_n"]
                                if state["kf_n"] else None))
        probe.work = True
        with trace.profiled() as prof:
            window2, n2, _ = stretch(min(seconds / 2, trace.PROFILED_S))
            ctx.sync()
        probe.work = False
        summ = trace.summarize(prof, window2)
        ba_c = (torch.stack(probe.ba_counts).cpu().tolist()
                if probe.ba_counts else [])
        k2 = [0.0, 0.0]
        k3 = [0.0, 0.0]
        for slots, points, live, poses, iters, _, _ in ba_c:
            c = dict(slots=slots, points=points, live_poses=live,
                     poses=poses)
            for acc, w in ((k2, roofline.k2_work(c, int(iters), 1)),
                           (k3, roofline.k3_work(c, int(iters)))):
                acc[0] += w[0]
                acc[1] += w[1]
        k1_valid = (float(torch.stack(probe.k1_valid).sum())
                    if probe.k1_valid else 0.0)
        lba = [c for c in ba_c if c[5]]
        lay.update(summary=summ, frames=n2, units=n2,
                   untraced_s_per_unit=window / n, work={"k2": k2, "k3": k3},
                   k1_work=roofline.k1_work(k1_valid),
                   lba_listed_pct=(100.0 * sum(c[1] for c in lba)
                                   / sum(c[6] for c in lba) if lba else None))
    out["memory_peak_bytes"] = ctx.memory_peak()
    gc.callbacks.remove(pauses)
    out["attempted"] = state["frames"]
    out["failed"] = state["lost"]
    print("window's local BAs (ms): "
          + " ".join(f"{1e3 * x:.1f}" for x in probe.lba_s), file=sys.stderr)
    print(f"window: {state['frames']} frames, {len(probe.lba_s)} local BAs "
          f"timed, {len(server.stats) - fus0} fusions, "
          f"{server.n_relocalizations - rel0} relocalizations, "
          f"{state['lost']} frames lost, {pauses.n} garbage collections "
          f"({pauses.s:.3f} s)", file=sys.stderr)

    # the check, once the window has closed
    ates = []
    for a in range(n_ag):
        rows = trackers[a].trajectory_tum()
        ids = np.array([int(r[0]) for r in rows])
        est = np.array([r[1:4] for r in rows])
        ates.append(ref_ate.ate_mean(est, gt[a][ids]) if len(ids) >= 3
                    else float("inf"))
    del server, trackers
    readings, control = [], []
    for f, n_iters, use_huber, ans in probe.captured:
        args = (f, cfg["camera"], n_iters, cfg["gba"]["chi2_mono"],
                cfg["gba"]["chi2_stereo"])
        r = ref_ba.solve(*args, use_huber=use_huber)
        q, t, pw, c = ans
        judge = (cfg["camera"], cfg["gba"]["chi2_mono"],
                 cfg["gba"]["chi2_stereo"], use_huber)
        readings.append(gba_replay.compare(f, (q, t, pw, float(c)), r,
                                           *judge))
        if ctx.control:
            control.append(gba_replay.compare(
                f, ref_ba.solve(*args, precision="tf32",
                                use_huber=use_huber), r, *judge))
    if control:
        out["control"] = {"program": readings, "control": control}
    k1 = [compare_pose(one, cfg) for one in probe.k1_captured]
    limits = ctx.cell.params["limits"]
    out["ate_m"] = max(ates)
    got = {"ate_m": max(ates), "frames_lost": state["lost"]}
    missing = []
    if len(readings) == 2 * tr["checked_local_bas"]:
        got.update({"lba_" + k: v
                    for k, v in gba_replay.worst(readings).items()})
    else:
        missing.append("lba_answers_missing")
    if k1 and probe.k1_calls > max(probe.k1_checked):
        got.update({k: max(r[k] for r in k1) for k in k1[0]})
    else:
        missing.append("k1_answers_missing")
    for k, v in got.items():
        if k not in limits:
            print(f"not compared {k}: {v!r}", file=sys.stderr)
    out["checks"] = {k: {"value": got.get(k, float("inf")),
                         "limit": limits[k]} for k in limits}
    for k in missing:
        out["checks"][k] = {"value": 1, "limit": 0}
    out["correct"] = all(v["value"] <= v["limit"]
                         for v in out["checks"].values())
    return out


def compare_pose(captured, cfg: dict) -> dict:
    """One pose optimization of the window against the plain reference in
    float64 from the same start and observations: the gap of the camera
    centres (m) and the angle between the rotations (rad)."""
    q0, t0, fields, q, t = captured
    po = cfg["pose_opt"]
    R_ref, t_ref, _ = ref_pose.solve(
        q0, t0, *fields, cfg["camera"], po["rounds"], po["iterations"],
        cfg["gba"]["chi2_mono"], cfg["gba"]["chi2_stereo"])
    q = q.double()
    R = ref_ba.quat_to_rot(q / q.norm())
    gap = ref_pose.centre(R, t.double()) - ref_pose.centre(R_ref, t_ref)
    return {"k1_centre_gap_m": float(gap.norm()),
            "k1_rotation_gap_rad": ref_pose.rotation_gap(R, R_ref)}
