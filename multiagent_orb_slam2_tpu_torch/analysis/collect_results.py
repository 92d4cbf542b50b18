"""The five-trial collection protocol.

Counterpart of the JAX package's ``analysis/collect_results.sh`` (the
reference's collect_split_seq_results.sh: run one configuration five times,
each trial's outputs under its own directory, then aggregate with
genstats): runs the port's ``generic_split_seq`` with the given driver
arguments five times, trial t writing to ``OUT/trial<t>`` (the ``-o`` the
arguments give is replaced). The driver runs on the CUDA device unless the
arguments pass ``--device``.

  python -m multiagent_orb_slam2_tpu_torch.analysis.collect_results \\
      -t stereo_synth -n 3 -d SEQ -s SEQ/settings.json -o OUT
"""
from __future__ import annotations

import os
import sys

from ..drivers import generic_split_seq

TRIALS = 5


def trial_argv(argv, out: str, trial: int):
    """The driver arguments with every `-o` / `--out` value replaced by
    out/trial<trial>."""
    args, skip = [], False
    for a in argv:
        if skip:
            skip = False
            continue
        if a in ("-o", "--out"):
            args += [a, os.path.join(out, f"trial{trial}")]
            skip = True
        elif a.startswith("--out="):
            args.append(f"--out={os.path.join(out, f'trial{trial}')}")
        else:
            args.append(a)
    return args


def output_dir(argv) -> str:
    """The last `-o` / `--out` value of the arguments; SystemExit if there
    is none."""
    out = None
    for i, a in enumerate(argv):
        if a in ("-o", "--out") and i + 1 < len(argv):
            out = argv[i + 1]
        elif a.startswith("--out="):
            out = a.split("=", 1)[1]
    if not out:
        raise SystemExit("need -o <outdir>")
    return out


def main(argv=None, trials: int = TRIALS) -> list:
    """Run the driver `trials` times; returns the drivers' summaries."""
    argv = list(sys.argv[1:] if argv is None else argv)
    out = output_dir(argv)
    summaries = []
    for trial in range(trials):
        print(f"=== trial {trial} ===", flush=True)
        summaries.append(generic_split_seq.main(trial_argv(argv, out,
                                                           trial)))
    print(f"collected {trials} trials under {out}/trial{{0..{trials - 1}}}")
    return summaries


if __name__ == "__main__":
    main()
