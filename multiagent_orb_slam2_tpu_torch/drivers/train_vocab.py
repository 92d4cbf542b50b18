"""Train a bag-of-binary-words vocabulary from a dataset.

Counterpart of the JAX package's ``drivers/train_vocab.py``: ORB
descriptors of about ``--frames`` evenly spaced left images of each
sequence (the port's ``extract_frame`` on ``--device``, the CUDA device
unless named otherwise), then ``vocab.bow.train_vocabulary`` (hierarchical
k-medians on the host) and ``save_vocabulary``, in the file layout both
packages read.

  python -m multiagent_orb_slam2_tpu_torch.drivers.train_vocab \\
      -t stereo_kitti -d /data/kitti/sequences/00 -s settings.yaml \\
      -o voc.npz [-k 10] [--depth 4] [--frames 100]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..io import datasets
from ..ops import frame as frame_mod
from ..vocab import bow as bow_mod
from . import common


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-t", "--type", required=True,
                    choices=sorted(datasets.LOADERS))
    ap.add_argument("-d", "--data", action="append", required=True)
    ap.add_argument("-s", "--settings", required=True)
    ap.add_argument("-o", "--out", required=True)
    ap.add_argument("-k", type=int, default=10)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    sensor = common.SENSOR_OF[args.type.split("_")[0]]
    cfg = common.load_settings(args.settings, sensor)

    descs = []
    for root in args.data:
        seq = datasets.LOADERS[args.type](root)
        step = max(len(seq) // args.frames, 1)
        for i in range(0, len(seq), step):
            left, _, _ = seq.load(i)
            f = frame_mod.extract_frame(left, cfg, device=device)
            descs.append(f.desc[f.valid].cpu().numpy().view(np.uint32))
    alld = np.concatenate(descs)
    print(f"training on {len(alld)} descriptors, k={args.k}, "
          f"depth={args.depth} -> {args.k ** args.depth} words")
    vocab = bow_mod.train_vocabulary(alld, k=args.k, depth=args.depth,
                                     device=device)
    bow_mod.save_vocabulary(vocab, args.out)
    print(f"saved {args.out}")


if __name__ == "__main__":
    main()
