"""Trajectory-accuracy statistics (the reference's Analysis/ suite).

Counterpart of the JAX package's ``analysis/genstats.py``, on the port's
``io/trajectory`` (numpy): associate an estimated TUM trajectory with the
ground truth by timestamp, align with a similarity (Umeyama), report ATE
mean and RMSE, RPE translation per frame pair (``rpe_t``, the unit of the
JAX package's record) and per metre travelled (``rpe_t_per_m``), and RPE
rotation.

  python -m multiagent_orb_slam2_tpu_torch.analysis.genstats \\
      --gt SEQ/gt_tum.txt --est OUT/CameraTrajectory.txt
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from ..io import trajectory as T


def tum_to_mats(rows):
    """TUM rows -> (timestamps, [N, 4, 4] camera-to-world matrices)."""
    q = np.stack([rows[:, 7], rows[:, 4], rows[:, 5], rows[:, 6]], -1)
    return rows[:, 0], T.poses_to_matrices(q, rows[:, 1:4])


def evaluate(gt_path, est_path, with_scale=True, max_dt=0.02):
    gt = T.read_tum(gt_path)
    est = T.read_tum(est_path)
    ia, ib = T.associate(est[:, 0], gt[:, 0], max_dt)
    if len(ia) < 3:
        return None
    _, est_m = tum_to_mats(est[ia])
    _, gt_m = tum_to_mats(gt[ib])
    ate = T.ate(est_m[:, :3, 3], gt_m[:, :3, 3], with_scale)
    # align before RPE, as evo does
    s, R, t = T.umeyama_alignment(est_m[:, :3, 3], gt_m[:, :3, 3], with_scale)
    A = np.eye(4)
    A[:3, :3] = s * R
    A[:3, 3] = t
    rpe = T.rpe(A[None] @ est_m, gt_m, delta=1)
    return dict(n=len(ia), ate=ate["mean"], ate_rmse=ate["rmse"],
                rpe_t=rpe["trans_mean"], rpe_t_per_m=rpe["trans_per_m"],
                rpe_r=rpe["rot_mean_deg"], scale=ate["scale"])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--gt", required=True)
    ap.add_argument("--est", nargs="+", required=True)
    ap.add_argument("--no-scale", action="store_true")
    ap.add_argument("--latex", action="store_true")
    args = ap.parse_args(argv)

    print(f"{'trajectory':<40} {'n':>5} {'ATE':>8} {'RPE-t':>8} "
          f"{'RPE-t/m':>8} {'RPE-r':>8}")
    for est in args.est:
        r = evaluate(args.gt, est, with_scale=not args.no_scale)
        if r is None:
            print(f"{est:<40}  (no timestamp overlap)")
            continue
        if args.latex:
            print(f"{os.path.basename(est)} & {r['ate']:.2f} & "
                  f"{r['rpe_t']:.2f} & {r['rpe_r']:.2f} \\\\")
        else:
            print(f"{est:<40} {r['n']:>5} {r['ate']:>8.3f} "
                  f"{r['rpe_t']:>8.3f} {r['rpe_t_per_m']:>8.4f} "
                  f"{r['rpe_r']:>8.2f}")


if __name__ == "__main__":
    main()
