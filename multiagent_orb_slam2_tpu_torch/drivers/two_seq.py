"""Two-sequence multi-agent driver: one agent per dataset sequence.

Counterpart of the JAX package's ``drivers/two_seq.py`` (reference
Examples/MultiAgent/euroc_two_seq.cc, beyond EuRoC): two sequences with
real scene overlap, one agent each, one fusion server; the same loop and
outputs as ``generic_split_seq``. Runs on the CUDA device unless
``--device`` names another.

  python -m multiagent_orb_slam2_tpu_torch.drivers.two_seq \\
      -t stereo_synth -d1 SEQ1 -d2 SEQ2 -s settings.json -o OUT
"""
from __future__ import annotations

import argparse

from ..io import datasets
from .generic_split_seq import run_server


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("-t", "--type", required=True,
                    choices=sorted(datasets.LOADERS))
    ap.add_argument("-d1", "--data1", required=True)
    ap.add_argument("-d2", "--data2", required=True)
    ap.add_argument("-s", "--settings", required=True)
    ap.add_argument("-v", "--vocab", default="")
    ap.add_argument("-o", "--out", default=".")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    loader = datasets.LOADERS[args.type]
    seqs = [loader(args.data1), loader(args.data2)]
    if args.max_frames:
        for s in seqs:
            s.items = s.items[:args.max_frames]
    _, summary = run_server(seqs, args.type, args.settings, args.vocab,
                            args.out, args.device)
    print(f"final maps: {summary['final_maps']}, "
          f"fusions: {summary['fusions']}")
    return summary


if __name__ == "__main__":
    main()
