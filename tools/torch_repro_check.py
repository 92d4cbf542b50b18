#!/usr/bin/env python3
"""Is the port's loop-corridor run reproducible, and where does it first
diverge if not?

    python3 tools/torch_repro_check.py [--frames 660] [--workers 8]
        [--out repro_check.json] [--device cuda]

Renders the first --frames frames of the 660-frame loop corridor
(analysis/make_synth_seq, seed 0), builds two Systems as the single-agent
driver run_single builds them (the sequence's settings, the committed
vocabulary, loop closing on) and tracks the frames with both in lockstep,
one frame each in turn, in one process. After each frame the two runs'
poses and everything carried to the next frame (the map, the tracker's
state, the keyframe database, the loop closer's groups, the slot tables)
are compared, tensors by an exact integer hash of their bits computed on
the device. At the first frame that differs, the frame is
tracked again from copies of both systems as they were before it, with
every module-level function of the modules on the path wrapped: a call
records its name and the fingerprints of its tensor inputs and outputs.
The first call to return whose inputs were equal in both runs and whose
outputs were not is the innermost operation that diverged; the tool
reports it, the fields of its output that differ and the calls that
returned before it, then stops. Prints one JSON object, with every frame's
pose in both runs, and writes it to --out.
"""
import argparse
import copy
import functools
import inspect
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from multiagent_orb_slam2_tpu_torch.analysis import make_synth_seq  # noqa: E402
from multiagent_orb_slam2_tpu_torch.drivers import common  # noqa: E402
from multiagent_orb_slam2_tpu_torch.geometry import epnp, horn  # noqa: E402
from multiagent_orb_slam2_tpu_torch.io import datasets  # noqa: E402
from multiagent_orb_slam2_tpu_torch.mapstate import state as ms  # noqa: E402
from multiagent_orb_slam2_tpu_torch.ops import (frame, hamming,  # noqa: E402
                                                matchers, orb)
from multiagent_orb_slam2_tpu_torch.optim import (ba, ba_prep,  # noqa: E402
                                                  pcg, pose_graph, pose_opt,
                                                  sim3_opt)
from multiagent_orb_slam2_tpu_torch.runtime import (loop_closing,  # noqa: E402
                                                    mapping, reloc, steps)
from multiagent_orb_slam2_tpu_torch.runtime.system import System  # noqa: E402
from multiagent_orb_slam2_tpu_torch.vocab import bow, kfdb  # noqa: E402

MODULES = (frame, orb, hamming, matchers, steps, mapping, ms, ba, ba_prep,
           pcg, pose_opt, pose_graph, sim3_opt, loop_closing, reloc, epnp,
           horn, bow, kfdb)
LOG = {"run": None, "calls": {0: [], 1: []}}
_WEIGHTS = {}


def _weights(n, device):
    key = (n, str(device))
    if key not in _WEIGHTS:
        _WEIGHTS[key] = torch.arange(n, device=device) % 1000003 + 1
    return _WEIGHTS[key]


def _tensors(obj, prefix=""):
    """(path, tensor) of every tensor in nested tuples / lists / dicts /
    NamedTuples."""
    if torch.is_tensor(obj):
        yield prefix, obj
    elif isinstance(obj, tuple) and hasattr(obj, "_fields"):
        for k, v in zip(obj._fields, obj):
            yield from _tensors(v, f"{prefix}.{k}")
    elif isinstance(obj, (tuple, list)):
        for i, v in enumerate(obj):
            yield from _tensors(v, f"{prefix}[{i}]")
    elif isinstance(obj, dict):
        for k, v in obj.items():
            yield from _tensors(v, f"{prefix}[{k}]")


def _scalars(obj):
    """Python scalars among the arguments, for the input fingerprint."""
    if isinstance(obj, (bool, int, float, str)) or obj is None:
        return [repr(obj)]
    if isinstance(obj, (tuple, list)) and not hasattr(obj, "_fields"):
        return [x for v in obj for x in _scalars(v)]
    return []


def fingerprint(obj):
    """{path: exact hash of the tensor's bits} (one device read)."""
    paths, hashes = [], []
    for path, t in _tensors(obj):
        t = t.detach()
        if t.numel() == 0:
            continue
        if t.is_floating_point():
            bits = t.contiguous().view(torch.int32 if t.element_size() == 4
                                       else torch.int16 if
                                       t.element_size() == 2 else torch.int64)
        elif t.dtype == torch.bool:
            bits = t.to(torch.uint8)
        else:
            bits = t
        flat = bits.reshape(-1).to(torch.int64)
        hashes.append(torch.sum(flat * _weights(flat.numel(), flat.device)))
        paths.append(path)
    if not hashes:
        return {}
    values = torch.stack(hashes).cpu().tolist()
    return dict(zip(paths, values))


def _wrap(mod, name, fn):
    label = f"{mod.__name__.rsplit('.', 1)[-1]}.{name}"

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        run = LOG["run"]
        if run is None:
            return fn(*args, **kwargs)
        entry = {"call": label, "in": fingerprint((args, kwargs)),
                 "in_scalars": _scalars(list(args) + list(kwargs.values()))}
        out = fn(*args, **kwargs)
        entry["out"] = fingerprint(out)
        # logged when the call returns, so the first difference in the log
        # is the innermost call that diverged
        LOG["calls"][run].append(entry)
        return out
    return wrapper


def instrument():
    n = 0
    for mod in MODULES:
        for name, fn in list(vars(mod).items()):
            # a kernel binder returns output buffers its launch has not
            # written yet; the wrapper that launches is wrapped instead
            if inspect.isfunction(fn) and fn.__module__ == mod.__name__ \
                    and name != "_bind_launch":
                setattr(mod, name, _wrap(mod, name, fn))
                n += 1
    return n


def first_divergence(a, b):
    """The first call, in the order calls return, where the two logs
    differ: its index, the call, and whether its inputs were equal (then its
    outputs differ: the operation that diverged)."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x["call"] != y["call"]:
            return {"index": i, "call": [x["call"], y["call"]],
                    "kind": "different call sequence"}
        if x["in"] != y["in"] or x["in_scalars"] != y["in_scalars"]:
            return {"index": i, "call": x["call"], "kind": "inputs differ",
                    "inputs_differ": sorted(k for k in x["in"]
                                            if x["in"][k] != y["in"].get(k))}
        if x.get("out") != y.get("out"):
            ox, oy = x.get("out") or {}, y.get("out") or {}
            return {"index": i, "call": x["call"],
                    "kind": "equal inputs, different outputs",
                    "outputs_differ": sorted(k for k in ox
                                             if ox[k] != oy.get(k))}
    if len(a) != len(b):
        return {"index": min(len(a), len(b)), "kind": "different lengths"}
    return None


def _state(system):
    """Everything a system carries from one frame to the next: the map, the
    tracker's tensors and counters, the keyframe database and the loop
    closer's bookkeeping, the slot tables."""
    tr, sh, lc = system.tracker, system.shared, system.loop_closer
    tensors = {"map": sh.state, "db": lc.db,
               "tracker": [tr.last_q, tr.last_t, tr.vel_q, tr.vel_t,
                           tr.last_frame_mp, tr.last_feats]}
    host = {"tracker": [tr.state, tr.ref_kf, tr.last_kf_frame,
                        tr.has_velocity, list(tr.new_kf_slots),
                        list(tr.culled_kf_slots)],
            "slots": [sh.n_kf, sh.n_mp, sh.n_created, list(sh.free_kf),
                      sorted(sh.uid_slot.items()), sh.kf_uid.tolist(),
                      sh.n_compactions],
            "loop": [[(sorted(g), c) for g, c in lc.consistency.groups],
                     lc.last_loop_kf, list(lc.loop_edges)]}
    return fingerprint(tensors), host


def _compare(systems):
    """(same, what differs) of the two systems after a frame: the frame's
    pose record and everything _state holds."""
    recs = [s.tracker.trajectory[-1] for s in systems]
    same_pose = all(np.array_equal(getattr(recs[0], k), getattr(recs[1], k))
                    for k in ("q", "t"))
    (ta, ha), (tb, hb) = (_state(s) for s in systems)
    differ = sorted(k for k in ta if ta[k] != tb.get(k)) + sorted(
        k for k in ha if ha[k] != hb[k])
    return same_pose and not differ, {
        "poses_equal": same_pose, "state_differs": differ,
        "pose_diff_m": float(np.linalg.norm(recs[0].t - recs[1].t))}


def replay(before, left, right, i, attempts=3):
    """Track frame i again from copies of both systems as they were before
    it, this time logging every call; the first difference in the two logs
    names the operation. Up to `attempts` times, since a race need not
    repeat."""
    out = []
    for _ in range(attempts):
        systems = [copy.deepcopy(s) for s in before]
        for r, system in enumerate(systems):
            LOG["calls"][r] = []
            LOG["run"] = r
            try:
                system.track_stereo(left, right, frame_id=i)
            finally:
                LOG["run"] = None
        same, diff = _compare(systems)
        calls = first_divergence(LOG["calls"][0], LOG["calls"][1])
        k = (calls or {}).get("index", 0)
        out.append({"same": same, **diff, "first_call": calls,
                    "calls_before": [c["call"] for c in
                                     LOG["calls"][0][max(0, k - 12):k]],
                    "calls_this_frame": len(LOG["calls"][0])})
        if calls is not None:
            break
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=660)
    ap.add_argument("--workers", type=int,
                    default=len(os.sched_getaffinity(0)))
    ap.add_argument("--out", default="repro_check.json")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device (or --device cpu)")
    n_wrapped = instrument()
    result = {"device": (torch.cuda.get_device_name(0)
                         if device.type == "cuda" else "cpu"),
              "frames_asked": args.frames, "functions_wrapped": n_wrapped}
    with tempfile.TemporaryDirectory() as work:
        q, t = make_synth_seq.loop_trajectory(660, 1.0, 24.0, seed=0)
        make_synth_seq.write_sequence(work, 0, q[:args.frames],
                                      t[:args.frames],
                                      make_synth_seq.camera(),
                                      workers=args.workers)
        seq = datasets.load_synth_stereo(work)
        settings = os.path.join(work, "settings.json")
        cfg = common.load_settings(settings, common.SENSOR_OF["stereo"])
        vocab = common.get_vocabulary("", [seq], cfg, device=device)
        systems = [System(cfg, vocab, device=device) for _ in range(2)]
        t0 = time.perf_counter()
        diverged, poses = None, []
        for i in range(len(seq)):
            left, right, _ = seq.load(i)
            before = [copy.deepcopy(s) for s in systems]
            for system in systems:
                system.track_stereo(left, right, frame_id=i)
            same, diff = _compare(systems)
            recs = [s.tracker.trajectory[-1] for s in systems]
            poses.append([i] + [np.r_[r.q, r.t].tolist() for r in recs])
            if not same:
                diverged = {"frame": i, **diff,
                            "keyframes": [s.shared.n_created
                                          for s in systems],
                            "replays": replay(before, left, right, i)}
                break
            if i % 50 == 0:
                print(f"frame {i}: identical, {time.perf_counter() - t0:.0f}"
                      " s", flush=True)
        result.update({
            "frames_tracked": i + 1, "seconds": time.perf_counter() - t0,
            "reproducible": diverged is None, "divergence": diverged,
            "keyframes_created": [s.shared.n_created for s in systems],
            "poses": poses})
    text = json.dumps(result)
    print(text)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(text + "\n")


if __name__ == "__main__":
    main()
