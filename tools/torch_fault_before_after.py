"""The paths of chip_smoke.py that faults 3 and 4 (ROADMAP.md queue 3) change,
run on one NVIDIA GPU with or without the two repairs undone in this
process, for their numbers before and after.

    python3 tools/torch_fault_before_after.py [--parent] [--phases P ...]
        [--recall-log PATH]

With --parent the port associates as it did before the repairs, and as the
JAX package does: a feature won by local-map query q >= F takes point
ids[F - 1] (every winning query past F is bounded by F - 1 before the step
reads its point), and the keyframe database keeps at most 1024 words a
keyframe (every database is made 1024 words wide). Nothing in the package
changes: both are wrappers set in this process only.

Phases (all by default), each run by chip_smoke.py's own function for it,
gates included:
localization (the KITTI-shaped 60 frames: map 0-29, mode 30-49, out of it
50-59), loop_path (System(CFG, vocab) over 100 frames), ring (the drifted
110-keyframe ring), corridor (run_single on the 660-frame corridor's first
120 frames, default capacities) and split (generic_split_seq -n 2 over the
whole corridor). Prints each phase's lines, then chip_smoke.py's
`local_map:`, `kfdb_words:` and `stereo_in_bounds:` lines of the phases
run. --recall-log writes the place-recognition recall log (SLAM_RECALL_LOG
rows: each loop query's candidates before and after the consistency
filter, each Sim3 attempt's stage) of the ring phase to PATH.
"""
import argparse
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from multiagent_orb_slam2_tpu_torch.ops import matchers  # noqa: E402
from multiagent_orb_slam2_tpu_torch.runtime import steps as steps_mod  # noqa
from multiagent_orb_slam2_tpu_torch.utils import cuda_build, diag  # noqa
from multiagent_orb_slam2_tpu_torch.vocab import bow as bow_mod  # noqa
from multiagent_orb_slam2_tpu_torch.vocab import kfdb as kfdb_mod  # noqa

PHASES = ("localization", "loop_path", "ring", "corridor", "split")
PARENT_WORDS_PER_KF = 1024


def parent_association(real):
    """track_local_map_step whose winning queries past F are bounded by
    F - 1, so that they read point ids[F - 1]."""
    def step(state, feats, q, t, frame_mp, ref_kf, cfg):
        resolve = matchers.resolve_conflicts

        def bounded(res, n_feats, *a):
            assign, res = resolve(res, n_feats, *a)
            return torch.where(assign >= n_feats,
                               torch.full_like(assign, n_feats - 1),
                               assign), res

        matchers.resolve_conflicts = bounded
        try:
            return real(state, feats, q, t, frame_mp, ref_kf, cfg)
        finally:
            matchers.resolve_conflicts = resolve
    return step


def parent_database(real):
    def empty(max_kf, vocab, max_words_per_kf):
        return real(max_kf, vocab, PARENT_WORDS_PER_KF)
    return empty


def ring_with_recall_log(vocab, path):
    os.environ["SLAM_RECALL_LOG"] = path
    diag._recall_sink = None
    try:
        return cs.drive_ring(vocab)
    finally:
        diag.recall_sink().f.close()
        diag._recall_sink = None
        del os.environ["SLAM_RECALL_LOG"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", action="store_true",
                    help="undo the repairs of faults 3 and 4 in this process")
    ap.add_argument("--phases", nargs="+", choices=PHASES, default=PHASES)
    ap.add_argument("--recall-log", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(cs.card_line())
    label = "parent" if args.parent else "port"
    print(f"association and database: {label}")
    patches = cs.Patches()
    if args.parent:
        patches(steps_mod, "track_local_map_step", parent_association)
        patches(kfdb_mod, "empty_database", parent_database)
    cs.COUNTS.install(patches)
    cuda_build.load_libraries(["pose_opt", "ba_prep", "pcg"])
    vocab = bow_mod.load_vocabulary()
    phases = [p for p in PHASES if p in args.phases]
    if {"localization", "loop_path"} & set(phases):
        frames, _, t_gt = cs.render_corridor(cs.N_FRAMES_LOOP)
        if "localization" in phases:
            with cs.counting("localization"):
                cs.drive_localization(frames[:cs.N_FRAMES_BA],
                                      t_gt[:cs.N_FRAMES_BA])
        if "loop_path" in phases:
            with cs.counting("loop_path"):
                cs.drive_path(frames, t_gt, local_ba=True, vocab=vocab)
        del frames
        torch.cuda.empty_cache()
    if "ring" in phases:
        with cs.counting("ring"):
            if args.recall_log:
                ring_with_recall_log(vocab, args.recall_log)
            else:
                cs.drive_ring(vocab)
        torch.cuda.empty_cache()
    if {"corridor", "split"} & set(phases):
        with tempfile.TemporaryDirectory() as work:
            seq_dir, render_s, workers = cs.render_corridor_sequence(work)
            if "corridor" in phases:
                with cs.counting("corridor"):
                    cs.drive_corridor(seq_dir, work, render_s, workers)
                torch.cuda.empty_cache()
            if "split" in phases:
                with cs.counting("split"):
                    cs.drive_split(seq_dir, work)
    cs.print_path_counts(phases)
    print(f"association and database: {label}, done")


if __name__ == "__main__":
    main()
