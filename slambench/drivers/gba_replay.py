"""Global BA replayed back to back: the fusion's post-merge global BA of a
configuration's map, closed loop, one solve at a time.

Traffic parameters (``traffic/<name>.json``): ``distinct_maps`` maps are
drawn on the card from the seed and handed in turn, so that no solve starts
from another's output; ``iterations`` LM iterations a solve, as the fusion
runs it. A solve is complete when its cost is on the host, as the server
reads it before going on.

The entry is ``optim.ba.ba_solve_fast`` with the arguments that
``runtime/loop_closing.global_bundle_adjustment`` passes (Huber, the chi2
thresholds, ``runtime/steps._ba_chunk``'s chunk). The cell's check runs the
plain reference on a sample of the maps (drawn from the seed) once the
window has closed, and compares the last answer the window gave for each.
"""
from __future__ import annotations

import math
import random
import time

from .. import gbamap, roofline, trace
from ..reference import ba as ref_ba


def _camera(cfg):
    from multiagent_orb_slam2_tpu_torch.geometry.camera import Intrinsics
    c = cfg["camera"]
    return Intrinsics(fx=c["fx"], fy=c["fy"], cx=c["cx"], cy=c["cy"],
                      bf=c["bf"], width=c["width"], height=c["height"])


class Solver:
    """The system under test: one map's global BA through the port."""

    def __init__(self, cfg: dict, n_iters: int):
        from multiagent_orb_slam2_tpu_torch.optim import ba
        from multiagent_orb_slam2_tpu_torch.runtime import steps
        self.ba = ba
        self.chunk = steps._ba_chunk
        self.cam = _camera(cfg)
        self.gba = cfg["gba"]
        self.n_iters = n_iters

    def problem(self, fields: dict):
        return self.ba.BAProblem(**fields)

    def __call__(self, prob):
        """(q, t, pw, cost): the solve's answer, the cost read on the host."""
        P = prob.obs_kf.shape[0]
        res = self.ba.ba_solve_fast(
            prob, self.cam, n_iters=self.n_iters, use_huber=True,
            chi2_mono=self.gba["chi2_mono"],
            chi2_stereo=self.gba["chi2_stereo"], chunk=self.chunk(P))
        return res.q, res.t, res.pw, float(res.cost)


def centres(R, t):
    return -(R.transpose(-1, -2) @ t[..., None])[..., 0]


def compare(fields: dict, answer, reference, cam: dict, chi2_mono: float,
            chi2_stereo: float, use_huber: bool = True) -> dict:
    """The numbers compared for one map: the gap of the cost the answer
    reports over the reference's final cost; by how much the reference's
    own cost of the answer's poses and points exceeds that final cost
    (negative where the answer is the better); the widest gap of a moved
    pose's camera centre (m); the median gap of a live point (m). All
    relative gaps are shares of the reference's final cost. An answer's
    rotations are quaternions [K, 4] or matrices [K, 3, 3]."""
    rot, t, pw, cost = answer
    R_r, t_r, pw_r, cost_r = reference
    free = fields["pose_valid"] & ~fields["pose_fixed"]
    R = rot if rot.shape[-1] == 3 else ref_ba.quat_to_rot(rot)
    pose_gap = (centres(R, t) - centres(R_r, t_r))[free].norm(dim=-1)
    live = fields["point_valid"] & fields["obs_mask"].any(1)
    point_gap = (pw - pw_r)[live].norm(dim=-1)
    with ref_ba.no_tf32():
        pb = ref_ba.Problem(fields, cam, chi2_mono, chi2_stereo, use_huber)
        cost_of_answer = float(ref_ba.cost(pb, R, t, pw,
                                           ref_ba.Precision("fp32")))
    return {"cost_gap": abs(cost - cost_r) / abs(cost_r),
            "answer_cost_gap": (cost_of_answer - cost_r) / abs(cost_r),
            "pose_gap_m": float(pose_gap.max()),
            "point_gap_m": float(point_gap.median())}


def worst(readings):
    """Each number's worst reading over the maps checked."""
    return {k: max(r[k] for r in readings) for k in readings[0]}


def run(ctx) -> dict:
    cfg, traffic, seconds = ctx.cell.config, ctx.cell.traffic, ctx.seconds
    dev = ctx.device
    n_iters = traffic["iterations"]
    solver = Solver(cfg, n_iters)
    maps = [gbamap.make_map(cfg, gbamap.sub_seed(ctx.seed, i + 1), dev)
            for i in range(traffic["distinct_maps"])]
    fields = [gbamap.problem_fields(m) for m in maps]
    probs = [solver.problem(f) for f in fields]
    for p in probs:                       # warm every shape the window uses
        solver(p)
    ctx.sync()
    setup_s = time.perf_counter() - ctx.t0

    checked = random.Random(ctx.seed).sample(
        range(len(probs)), ctx.cell.params["checked_maps"])
    last = {}
    stats = {"attempted": 0, "failed": 0}

    def stretch(until: float):
        n = 0
        t0 = time.perf_counter()
        while True:
            i = stats["attempted"] % len(probs)
            with trace.span("gba_solve"):
                ans = solver(probs[i])
            stats["attempted"] += 1
            n += 1
            if not math.isfinite(ans[3]):
                stats["failed"] += 1
            if i in checked:
                last[i] = ans
            if time.perf_counter() - t0 >= until:
                return n, time.perf_counter() - t0

    out = {"setup_s": setup_s}
    if not ctx.trace:
        n, window = stretch(seconds)
        out["e2e"] = {"gba_ms": 1e3 * window / n, "setup_s": setup_s}
    else:
        n0, w0 = stretch(seconds / 2)     # untraced, then a profiled stretch
        ba_mod = solver.ba
        assemble = ba_mod._assemble

        def spanned(*a, **k):
            with trace.span("assembly"):
                return assemble(*a, **k)
        ba_mod._assemble = spanned
        try:
            with trace.profiled() as prof:
                n, window = stretch(min(seconds / 2, trace.PROFILED_S))
                ctx.sync()
        finally:
            ba_mod._assemble = assemble
        summ = trace.summarize(prof, window)
        counts = [roofline.ba_counts(f) for f in fields]
        # the maps in turn, from where the untraced stretch stopped
        start = stats["attempted"] - n
        per = [counts[(start + j) % len(counts)] for j in range(n)]
        ctx.layer_ctx.update(summary=summ, units=n,
                             untraced_s_per_unit=w0 / n0,
                             work={
                                 "k2": [sum(x) for x in zip(*(
                                     roofline.k2_work(c, n_iters, 1)
                                     for c in per))],
                                 "k3": [sum(x) for x in zip(*(
                                     roofline.k3_work(c, n_iters)
                                     for c in per))]})
    out["memory_peak_bytes"] = ctx.memory_peak()
    out["attempted"], out["failed"] = stats["attempted"], stats["failed"]

    # the check: the plain reference on the sampled maps, after the window
    del probs
    readings = []
    for i in checked:
        if i not in last:
            return dict(out, correct=False,
                        checks={"answers_missing": {"value": 1, "limit": 0}})
        g = (cfg["camera"], cfg["gba"]["chi2_mono"], cfg["gba"]["chi2_stereo"])
        r = ref_ba.solve(fields[i], g[0], n_iters, *g[1:])
        readings.append(compare(fields[i], last[i], r, *g))
    got = worst(readings)
    limits = ctx.cell.params["limits"]
    out["checks"] = {k: {"value": got[k], "limit": limits[k]} for k in limits}
    out["correct"] = (stats["failed"] == 0
                      and all(got[k] <= limits[k] for k in limits))
    return out
