"""The accuracy protocol on synthetic loop corridors.

Counterpart of the JAX package's ``analysis/collect_synthetic.py``: per
trial it generates the 660-frame loop corridor of ``make_synth_seq`` (seed =
trial), runs the port's single-agent driver ``run_single`` and the split
driver ``generic_split_seq -n N`` for each N of ``--agents`` (2 by default;
the reference's protocol runs 2 to 4) on it, and evaluates every trajectory
with ``genstats``. Each trial's rows, with the kernels' launches of each
run (K1, K2, K3; 0 on the CPU, where no kernel launches), go to
``WORK/trial<t>.json`` and the
table is rebuilt from every such file of the first ``--trials`` trials
after each trial, so a protocol can be split across several runs over one
work directory (``--only`` names the trials a run makes); a file made with
other ``--agents`` or ``--frames`` is refused. The table goes to
its own file (``analysis/stats_synthetic_torch.txt`` in this package by
default), never to the JAX package's record.

  python -m multiagent_orb_slam2_tpu_torch.analysis.collect_synthetic \
      --trials 5 --agents 2 3 4 --work WORK [--only 0 1] [--workers 8] \
      [--device cuda]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import time

import numpy as np

from ..drivers import generic_split_seq, run_single
from ..io import datasets
from ..optim import ba_prep, pcg, pose_opt
from . import genstats, make_synth_seq

DEFAULT_OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "stats_synthetic_torch.txt")


def split_runs(row: dict, n: int):
    """The part of a trial's rows that holds the n-agent split: the row
    itself for n = 2 (its "split", "agent0" and "agent1" entries, the
    table's original layout), row["n<n>"] for more agents; None where the
    trial did not run it."""
    runs = row if n == 2 else row.get(f"n{n}")
    return runs if runs is not None and "split" in runs else None


def launches() -> dict:
    """The three kernels' launch counts so far."""
    return {"pose_opt": pose_opt.pose_optimize.launches,
            "ba_prep": ba_prep.prep_terms.launches,
            "pcg": pcg.pcg_solve.launches}


def run_trial(trial: int, work: str, frames: int, vocab_path: str,
              workers: int = 1, device: str = "cuda",
              agents=(2,)) -> dict:
    """Generate (unless present), track and evaluate one trial."""
    seq_dir = os.path.join(work, f"seq{trial}")
    gt = os.path.join(seq_dir, "gt_tum.txt")
    t0 = time.perf_counter()
    if not os.path.exists(gt):
        make_synth_seq.main(["-o", seq_dir, "--seed", str(trial),
                             "--frames", str(frames),
                             "--workers", str(workers)])
    t_render = time.perf_counter() - t0
    out = os.path.join(work, f"single{trial}")
    t0, l0 = time.perf_counter(), launches()
    meta = run_single.main(["-t", "stereo_synth", "-d", seq_dir,
                            "-s", os.path.join(seq_dir, "settings.json"),
                            "-v", vocab_path, "-o", out,
                            "--device", device])
    times = {"render_s": t_render, "single_s": time.perf_counter() - t0}
    counts = {"single": {k: v - l0[k] for k, v in launches().items()}}
    row = {"trial": trial, "meta": meta, "single": genstats.evaluate(
        gt, os.path.join(out, "CameraTrajectory.txt"))}
    for n in agents:
        out = os.path.join(work, f"split{trial}" if n == 2
                           else f"split{trial}_n{n}")
        t0, l0 = time.perf_counter(), launches()
        runs = {"split": generic_split_seq.main(
            ["-t", "stereo_synth", "-n", str(n), "-d", seq_dir,
             "-s", os.path.join(seq_dir, "settings.json"), "-v", vocab_path,
             "-o", out, "--device", device])}
        times[f"split_n{n}_s"] = time.perf_counter() - t0
        counts[f"split_n{n}"] = {k: v - l0[k] for k, v in launches().items()}
        subs = datasets.load_synth_stereo(seq_dir).split(n)
        for a, sub in enumerate(subs):
            runs[f"agent{a}"] = genstats.evaluate(
                gt, os.path.join(out, f"SLAM{a}.txt"))
            runs["split"][f"frames{a}"] = len(sub)
        if n == 2:
            row.update(runs)
        else:
            row[f"n{n}"] = runs
    row["seconds"], row["launches"] = times, counts
    print(f"trial {trial}: {times}, {counts}, {meta}, " + ", ".join(
        f"{name} ATE {r['ate'] if r else None}" for name, r in
        run_rows(row)), flush=True)
    return row


def device_line(device: str) -> str:
    """The card's name and power limit as nvidia-smi gives them, or the
    CPU."""
    if not device.startswith("cuda"):
        return "cpu"
    query = ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"]
    return subprocess.run(query, capture_output=True, text=True,
                          check=True).stdout.splitlines()[0]


def run_rows(row: dict):
    """(name, genstats result or None) of every run of a trial, in the
    table's order: single, agent0 and agent1 of the 2-agent split, then
    "n<n> agent<a>" for each larger split."""
    out = [("single", row.get("single"))]
    for n in range(2, 5):
        runs = split_runs(row, n)
        if runs is None:
            continue
        prefix = "" if n == 2 else f"n{n} "
        out += [(f"{prefix}agent{a}", runs.get(f"agent{a}"))
                for a in range(n)]
    return out


def write_table(out_path, all_rows, n_trials, device="cpu"):
    """ATE mean and RMSE, RPE per frame pair and per metre, RPE rotation,
    per trial and aggregated, for the single-agent run and each agent of
    each split run; frames exported and lost, relocalizations and loops of
    the single run; final maps, fusions, relocalizations and each agent's
    resets of each split run. `device` names where the trials ran."""
    fields = ("ate", "ate_rmse", "rpe_t", "rpe_t_per_m", "rpe_r")

    def accuracy(r):
        return (" ".join(f"{k}={r[k]:.4f}" for k in fields) if r
                else "no overlap with the ground truth")

    names = []
    for t in all_rows:
        names += [name for name, _ in run_rows(t) if name not in names]
    with open(out_path, "w") as f:
        f.write("# accuracy of the PyTorch/CUDA port on the synthetic loop "
                "corridor (make_synth_seq, 660 frames a trial, seed = trial;\n"
                "# exact ground truth; ATE, RPE-t in m, RPE-t/m in m per m "
                "travelled, RPE-r in deg; single = run_single, agent0 /\n"
                "# agent1 = the two halves of generic_split_seq -n 2 under "
                "one MultiAgentServer, nN agentI = part I of\n"
                "# generic_split_seq -n N)\n"
                f"# device: {device}\n"
                f"# trials completed: {len(all_rows)}/{n_trials}\n")
        f.write(f"{'run':<10}" + "".join(f" {k:>11} {'+-':>7}"
                                         for k in fields) + "\n")
        for run in names or ["single"]:
            rows = [r for t in all_rows for name, r in run_rows(t)
                    if name == run and r is not None]
            f.write(f"{run:<10}")
            for k in fields:
                vals = [r[k] for r in rows]
                m, s = (np.mean(vals), np.std(vals)) if vals \
                    else (np.nan, 0.0)
                f.write(f" {m:>11.4f} {s:>7.4f}")
            f.write("\n")
        f.write("\n# per trial\n")
        for t in all_rows:
            r, m = t["single"], t["meta"]
            f.write(f"trial{t['trial']}: {accuracy(r)} "
                    f"exported={r['n'] if r else 0}/"
                    f"{m['frames']} lost={m['lost']} "
                    f"relocs={m['relocalizations']} "
                    f"loops={m['loops_corrected']} "
                    f"resets={m.get('resets', 0)}\n")
            for n in range(2, 5):
                runs = split_runs(t, n)
                if runs is None:
                    continue
                prefix = "" if n == 2 else f"n{n} "
                split = runs["split"]
                for a in range(n):
                    r = runs[f"agent{a}"]
                    f.write(f"trial{t['trial']} {prefix}agent{a}: "
                            f"{accuracy(r)} exported={r['n'] if r else 0}/"
                            f"{split[f'frames{a}']}\n")
                f.write(f"trial{t['trial']} {prefix}split: "
                        f"maps={split['final_maps']} "
                        f"fusions={split['fusions']} "
                        f"relocs={split['relocalizations']} resets="
                        + "/".join(str(x) for x in split.get("resets", ()))
                        + "\n")


def trial_path(work: str, trial: int) -> str:
    return os.path.join(work, f"trial{trial}.json")


def save_trial(work: str, row: dict):
    with open(trial_path(work, row["trial"]), "w") as f:
        json.dump(row, f, indent=1, default=float)


def load_trials(work: str, n_trials: int, agents: list, frames: int) -> list:
    """Every trial's rows saved under `work` for trials 0..n_trials-1, in
    trial order. Each file records the protocol it was made with (the
    split sizes and the frames a trial); a file of another protocol is
    refused, not merged."""
    rows = []
    for path in sorted(glob.glob(os.path.join(work, "trial*.json"))):
        with open(path) as f:
            row = json.load(f)
        made = (row.get("agents"), row.get("frames"))
        if made != (agents, frames):
            raise SystemExit(
                f"{path} was made with --agents {made[0]} --frames "
                f"{made[1]}, this run has --agents {agents} --frames "
                f"{frames}: remove it or give another --work")
        if 0 <= row["trial"] < n_trials:
            rows.append(row)
    return sorted(rows, key=lambda r: r["trial"])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=5)
    ap.add_argument("--only", type=int, nargs="+", default=None,
                    help="the trials this run makes (default: all)")
    ap.add_argument("--agents", type=int, nargs="+", default=[2],
                    choices=[2, 3, 4])
    ap.add_argument("--frames", type=int, default=660)
    ap.add_argument("--work", required=True)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--workers", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    os.makedirs(args.work, exist_ok=True)
    # an empty path: the drivers load the committed vocabulary asset, one
    # pre-trained vocabulary for every run as in the reference protocol
    device = device_line(args.device)
    trials = args.only if args.only is not None else range(args.trials)
    agents = sorted(set(args.agents))
    load_trials(args.work, args.trials, agents, args.frames)
    for trial in trials:
        row = run_trial(trial, args.work, args.frames, "", args.workers,
                        args.device, agents)
        save_trial(args.work, {**row, "agents": agents,
                               "frames": args.frames})
        # rebuilt after every trial, so an interrupted run still leaves a
        # complete partial table
        write_table(args.out, load_trials(args.work, args.trials, agents,
                                          args.frames), args.trials, device)
    all_rows = load_trials(args.work, args.trials, agents, args.frames)
    write_table(args.out, all_rows, args.trials, device)
    print(f"wrote {args.out}")
    with open(args.out) as f:
        print(f.read())
    return all_rows


if __name__ == "__main__":
    main()
