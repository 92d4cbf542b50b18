"""Multi-agent split-sequence driver (the fork's primary experiment).

Counterpart of the JAX package's ``drivers/generic_split_seq.py``
(reference Examples/MultiAgent/generic_split_seq.cc), on the port's
``MultiAgentServer``: one dataset is split contiguously into N
sub-sequences, each fed to its own agent; the agents start on separate maps
and fuse when their maps overlap. Frame i of every agent is tracked in one
tick, round robin, then the server drains the keyframe queues. Writes the
per-agent trajectories SLAM0..SLAM{N-1}.txt and stats.csv with the fusion
timing schema. Stereo, RGB-D and monocular sub-sequences. Runs on the CUDA
device unless ``--device`` names another.

  python -m multiagent_orb_slam2_tpu_torch.drivers.generic_split_seq \\
      -t stereo_synth -n 2 -d SEQ -s SEQ/settings.json -o OUT
"""
from __future__ import annotations

import argparse
import os

import torch

from ..io import datasets
from ..io import trajectory as traj_mod
from ..server import MultiAgentServer
from ..utils import diag
from . import common


def run_server(seqs, sensor_type: str, settings: str, vocab_path: str,
               out: str, device):
    """Track one sequence per agent under one server, round robin, and write
    SLAM{a}.txt and stats.csv to `out`. Returns (server, summary)."""
    device = torch.device(device)
    sensor = common.SENSOR_OF[sensor_type.split("_")[0]]
    cfg = common.metric_depth(common.load_settings(settings, sensor))
    vocab = common.get_vocabulary(vocab_path, seqs, cfg, device=device)
    rect = common.get_rectifier(settings, device)

    server = MultiAgentServer(cfg, vocab, device=device)
    trackers = [server.register_client(a) for a in range(len(seqs))]
    timer = common.FrameTimer(device)
    for i in range(max(len(s) for s in seqs)):
        for a, sub in enumerate(seqs):
            if i >= len(sub):
                continue
            left, right, depth = sub.load(i)
            with timer:
                if right is not None:
                    if rect is not None:
                        left, right = rect(left, right)
                    trackers[a].track_stereo(left, right, frame_id=i)
                elif depth is not None:
                    trackers[a].track_rgbd(left, depth, frame_id=i)
                else:
                    trackers[a].track_mono(left, frame_id=i)
            diag.log_frame(a, i, trackers[a], server.shared)
        server.process_new_keyframes()
    server.shutdown()
    timer.report()
    if server.n_relocalizations:
        print(f"relocalizations: {server.n_relocalizations}")

    os.makedirs(out, exist_ok=True)
    for a, (tracker, sub) in enumerate(zip(trackers, seqs)):
        traj_mod.write_tum(os.path.join(out, f"SLAM{a}.txt"),
                           tracker.trajectory_tum(sub.timestamps()))
    common.write_fusion_stats(os.path.join(out, "stats.csv"), server.stats)
    summary = {"final_maps": server.multimap.n_maps,
               "fusions": len(server.stats),
               "relocalizations": server.n_relocalizations,
               "resets": [t.n_resets for t in trackers]}
    return server, summary


def run(argv=None):
    """Split, track and write the outputs; returns (server, summary)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("-t", "--type", required=True,
                    choices=sorted(datasets.LOADERS))
    ap.add_argument("-n", "--agents", type=int, default=2)
    ap.add_argument("-d", "--data", required=True)
    ap.add_argument("-s", "--settings", required=True)
    ap.add_argument("-v", "--vocab", default="")
    ap.add_argument("-o", "--out", default=".")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    seq = datasets.LOADERS[args.type](args.data)
    if args.max_frames:
        seq.items = seq.items[:args.max_frames]
    server, summary = run_server(seq.split(args.agents), args.type,
                                 args.settings, args.vocab, args.out,
                                 args.device)
    print(f"agents: {args.agents}, final maps: {summary['final_maps']}, "
          f"fusions: {summary['fusions']}")
    return server, summary


def main(argv=None) -> dict:
    return run(argv)[1]


if __name__ == "__main__":
    main()
