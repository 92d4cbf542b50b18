"""The accuracy protocol on synthetic loop corridors.

Counterpart of the JAX package's ``analysis/collect_synthetic.py``: per
trial it generates the 660-frame loop corridor of ``make_synth_seq`` (seed =
trial), runs the port's single-agent driver ``run_single`` and the 2-agent
split driver ``generic_split_seq -n 2`` on it, evaluates every trajectory
with ``genstats`` and rewrites the table after every trial. The table goes
to its own file (``analysis/stats_synthetic_torch.txt`` in this package by
default), never to the JAX package's record.

  python -m multiagent_orb_slam2_tpu_torch.analysis.collect_synthetic \\
      --trials 3 --work WORK [--workers 8] [--device cuda]
"""
from __future__ import annotations

import argparse
import os
import subprocess
import time

import numpy as np

from ..drivers import generic_split_seq, run_single
from ..io import datasets
from . import genstats, make_synth_seq

DEFAULT_OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "stats_synthetic_torch.txt")


def run_trial(trial: int, work: str, frames: int, vocab_path: str,
              workers: int = 1, device: str = "cuda") -> dict:
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
    t0 = time.perf_counter()
    meta = run_single.main(["-t", "stereo_synth", "-d", seq_dir,
                            "-s", os.path.join(seq_dir, "settings.json"),
                            "-v", vocab_path, "-o", out,
                            "--device", device])
    t_single = time.perf_counter() - t0
    row = {"trial": trial, "meta": meta, "single": genstats.evaluate(
        gt, os.path.join(out, "CameraTrajectory.txt"))}
    out = os.path.join(work, f"split{trial}")
    t0 = time.perf_counter()
    row["split"] = generic_split_seq.main(
        ["-t", "stereo_synth", "-n", "2", "-d", seq_dir,
         "-s", os.path.join(seq_dir, "settings.json"), "-v", vocab_path,
         "-o", out, "--device", device])
    t_split = time.perf_counter() - t0
    subs = datasets.load_synth_stereo(seq_dir).split(2)
    for a, sub in enumerate(subs):
        row[f"agent{a}"] = genstats.evaluate(
            gt, os.path.join(out, f"SLAM{a}.txt"))
        row["split"][f"frames{a}"] = len(sub)
    ate = [row[k]["ate"] if row[k] else None for k in RUNS]
    print(f"trial {trial}: rendering {t_render:.0f} s, single {t_single:.0f}"
          f" s, split {t_split:.0f} s, {meta}, {row['split']}, ATE single /"
          f" agent0 / agent1 {ate}", flush=True)
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


RUNS = ("single", "agent0", "agent1")


def write_table(out_path, all_rows, n_trials, device="cpu"):
    """ATE mean and RMSE, RPE per frame pair and per metre, RPE rotation,
    per trial and aggregated, for the single-agent run and each agent of the
    split run; frames exported and lost, relocalizations and loops of the
    single run; final maps, fusions and relocalizations of the split run.
    `device` names where the trials ran."""
    fields = ("ate", "ate_rmse", "rpe_t", "rpe_t_per_m", "rpe_r")

    def accuracy(r):
        return (" ".join(f"{k}={r[k]:.4f}" for k in fields) if r
                else "no overlap with the ground truth")

    with open(out_path, "w") as f:
        f.write("# accuracy of the PyTorch/CUDA port on the synthetic loop "
                "corridor (make_synth_seq, 660 frames a trial, seed = trial;\n"
                "# exact ground truth; ATE, RPE-t in m, RPE-t/m in m per m "
                "travelled, RPE-r in deg; single = run_single, agent0 /\n"
                "# agent1 = the two halves of generic_split_seq -n 2 under "
                "one MultiAgentServer)\n"
                f"# device: {device}\n"
                f"# trials completed: {len(all_rows)}/{n_trials}\n")
        f.write(f"{'run':<10}" + "".join(f" {k:>11} {'+-':>7}"
                                         for k in fields) + "\n")
        for run in RUNS:
            rows = [t[run] for t in all_rows if t.get(run) is not None]
            if run != "single" and not rows:
                continue
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
            split = t.get("split")
            if split is None:
                continue
            for a in (0, 1):
                r = t[f"agent{a}"]
                f.write(f"trial{t['trial']} agent{a}: {accuracy(r)} "
                        f"exported={r['n'] if r else 0}/"
                        f"{split[f'frames{a}']}\n")
            f.write(f"trial{t['trial']} split: maps={split['final_maps']} "
                    f"fusions={split['fusions']} "
                    f"relocs={split['relocalizations']} resets="
                    + "/".join(str(n) for n in split.get("resets", ()))
                    + "\n")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=3)
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
    all_rows = []
    for trial in range(args.trials):
        all_rows.append(run_trial(trial, args.work, args.frames, "",
                                  args.workers, args.device))
        # rewritten after every trial, so an interrupted run still leaves
        # a complete partial table
        write_table(args.out, all_rows, args.trials, device)
    print(f"wrote {args.out}")
    with open(args.out) as f:
        print(f.read())
    return all_rows


if __name__ == "__main__":
    main()
