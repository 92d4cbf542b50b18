"""Trajectory export + ATE/RPE evaluation (the evo-equivalent harness).

Covers the reference's trajectory writers (System::SaveTrajectoryTUM /
SaveKeyFrameTrajectoryTUM / SaveTrajectoryKITTI, src/System.cc:390-540) and
the Analysis/ suite's evo-based metrics (Analysis/EuRoC/genstats_two_seq.py:
timestamp association, SE3+scale Umeyama alignment, APE/RPE translation and
rotation means — SURVEY.md §4). Implemented in numpy: the `evo` package is
not part of this environment, and the metrics are small host-side math.
"""
from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------------------
# File formats
# ---------------------------------------------------------------------------

def write_tum(path, rows):
    """rows: iterable of (t, tx, ty, tz, qx, qy, qz, qw)."""
    with open(path, "w") as f:
        for r in rows:
            f.write(" ".join(f"{x:.9f}" for x in r) + "\n")


def read_tum(path):
    data = np.loadtxt(path)
    if data.ndim == 1:
        data = data[None]
    return data  # [N, 8]


def write_kitti(path, poses):
    """poses: [N, 3, 4] camera-to-world matrices (KITTI row-major format,
    reference SaveTrajectoryKITTI src/System.cc:487-540)."""
    with open(path, "w") as f:
        for T in poses:
            f.write(" ".join(f"{x:.9e}" for x in np.asarray(T).reshape(-1))
                    + "\n")


def read_kitti(path):
    data = np.loadtxt(path)
    return data.reshape(-1, 3, 4)


# ---------------------------------------------------------------------------
# Association + alignment
# ---------------------------------------------------------------------------

def associate(ts_a, ts_b, max_dt: float = 0.02):
    """Nearest-timestamp association (evo sync.associate_trajectories)."""
    ia, ib = [], []
    j = 0
    for i, t in enumerate(ts_a):
        j = int(np.searchsorted(ts_b, t))
        best, bestd = -1, max_dt
        for jj in (j - 1, j):
            if 0 <= jj < len(ts_b) and abs(ts_b[jj] - t) <= bestd:
                best, bestd = jj, abs(ts_b[jj] - t)
        if best >= 0:
            ia.append(i)
            ib.append(best)
    return np.asarray(ia), np.asarray(ib)


def umeyama_alignment(src, dst, with_scale: bool = True):
    """Least-squares similarity aligning src -> dst, both [N, 3]
    (evo's align(correct_scale=True); Umeyama 1991). Returns (s, R, t)."""
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_s = (xs ** 2).sum() / len(src)
    s = float(np.trace(np.diag(D) @ S) / var_s) if with_scale else 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------

def ate(est_t, gt_t, with_scale: bool = True):
    """Absolute trajectory error after similarity alignment.

    est_t/gt_t: [N, 3] positions. Returns dict with rmse/mean/median (m).
    """
    s, R, t = umeyama_alignment(est_t, gt_t, with_scale)
    aligned = (s * (R @ est_t.T)).T + t
    err = np.linalg.norm(aligned - gt_t, axis=-1)
    return {"rmse": float(np.sqrt((err ** 2).mean())),
            "mean": float(err.mean()), "median": float(np.median(err)),
            "max": float(err.max()), "scale": s}


def rpe(est_T, gt_T, delta: int = 1):
    """Relative pose error at frame offset delta.

    est_T/gt_T: [N, 4, 4] camera-to-world. Returns the translation (m) and
    rotation (deg) means per frame pair, the reference tables' RPE-t / RPE-r
    columns, and the translation error per metre of ground-truth travel
    (summed errors over summed step lengths: the in-place turns of the loop
    corridor have steps of millimetres, so a per-pair ratio would be
    meaningless there).
    """
    dts, drs, steps = [], [], []
    for i in range(len(est_T) - delta):
        de = np.linalg.inv(est_T[i]) @ est_T[i + delta]
        dg = np.linalg.inv(gt_T[i]) @ gt_T[i + delta]
        e = np.linalg.inv(dg) @ de
        dts.append(np.linalg.norm(e[:3, 3]))
        steps.append(np.linalg.norm(dg[:3, 3]))
        c = np.clip((np.trace(e[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)
        drs.append(np.degrees(np.arccos(c)))
    return {"trans_mean": float(np.mean(dts)),
            "rot_mean_deg": float(np.mean(drs)),
            "trans_per_m": float(np.sum(dts) / max(np.sum(steps), 1e-12))}


def poses_to_matrices(qs, ts):
    """Quaternion (wxyz) + translation arrays -> [N, 4, 4] matrices."""
    qs = np.asarray(qs, np.float64)
    ts = np.asarray(ts, np.float64)
    w, x, y, z = qs[..., 0], qs[..., 1], qs[..., 2], qs[..., 3]
    R = np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], axis=-1).reshape(qs.shape[:-1] + (3, 3))
    T = np.zeros(qs.shape[:-1] + (4, 4))
    T[..., :3, :3] = R
    T[..., :3, 3] = ts
    T[..., 3, 3] = 1.0
    return T
