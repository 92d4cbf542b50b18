"""The readings that a cell's limits are set from.

    python3 -m slambench.control --workload <cell> --seeds 1 2 3 ... [--out FILE]

For each seed of a global-BA cell: the cell's first map at its own size,
solved by the program (the timed path's entry), by the plain reference in
float32, and by the control, the reference with every matrix product's
operands rounded to TF32. For a stream cell: a run of the cell at its own
size and load for ``--seconds`` with the control in K1's place (the plain
pose optimization with TF32 operands) for the whole run, its numbers as
the run reads them, and the local BAs it checks solved by the TF32
reference besides. Prints, for the program and for the control, the
numbers the cell compares against the reference, one JSON line a seed,
and the largest program reading and the smallest control reading of each
number at the end. Benchmark runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def readings(cell, seed: int, device) -> dict:
    from . import gbamap
    from .drivers import gba_replay
    from .reference import ba as ref_ba
    cfg = cell.config
    n_iters = cell.traffic["iterations"]
    m = gbamap.make_map(cfg, gbamap.sub_seed(seed, 1), device)
    f = gbamap.problem_fields(m)
    solver = gba_replay.Solver(cfg, n_iters)
    t0 = time.perf_counter()
    prog = solver(solver.problem(f))
    t1 = time.perf_counter()
    g = (cfg["camera"], cfg["gba"]["chi2_mono"], cfg["gba"]["chi2_stereo"])
    refs = {p: ref_ba.solve(f, g[0], n_iters, *g[1:], precision=p)
            for p in ("fp32", "tf32")}
    t2 = time.perf_counter()
    return {"seed": seed,
            "program": gba_replay.compare(f, prog, refs["fp32"], *g),
            "control": gba_replay.compare(f, refs["tf32"], refs["fp32"], *g),
            "cost_reference": refs["fp32"][3], "cost_program": prog[3],
            "program_s": t1 - t0, "references_s": t2 - t1}


def stream_readings(cell, seed: int, seconds: float, device) -> list:
    """A short run of a stream cell with the control in K1's place: the
    local BAs it checks read by the program and by the TF32 reference, and
    the run's other numbers, which are the control's."""
    from .drivers import gba_replay
    from . import run
    out = run.execute(cell, seed, seconds, False, device, control=True)
    c = out.get("control", {"program": [], "control": []})
    if not c["program"]:
        return []
    lba = {"lba_" + k: v for k, v in gba_replay.worst(c["program"]).items()}
    ctl = {"lba_" + k: v for k, v in gba_replay.worst(c["control"]).items()}
    for k, v in out["checks"].items():
        if not k.startswith("lba_"):
            ctl[k] = v["value"]
    ctl.update(ate_m=out["ate_m"])
    return [{"seed": seed, "program": lba, "control": ctl}]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seconds", type=float, default=80.0,
                    help="the window of a stream cell's run, long enough "
                    "for the K1 sample under the slower control")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    from . import manifest
    cell = manifest.cell(args.workload)
    rows = []
    for s in args.seeds:
        if cell.traffic["kind"] == "stereo_stream":
            rows += stream_readings(cell, s, args.seconds, args.device)
        else:
            rows.append(readings(cell, s, args.device))
        if rows:
            print(json.dumps(rows[-1]), flush=True)
    summary = {"workload": args.workload,
               "program_max": {k: max(r["program"][k] for r in rows)
                               for k in rows[0]["program"]},
               "control_min": {k: min(r["control"][k] for r in rows)
                               for k in rows[0]["control"]}}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for r in rows + [summary]:
                f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
