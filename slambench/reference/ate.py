"""Absolute trajectory error against the rendered ground truth: a copy of
the arithmetic of the port's ``analysis/genstats`` (``io/trajectory``'s
Umeyama similarity alignment, evo's ``align(correct_scale=True)``, and the
mean distance after it), in numpy."""
from __future__ import annotations

import numpy as np


def umeyama(src, dst, with_scale: bool = True):
    """Least-squares similarity (s, R, t) taking src [N, 3] onto dst."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    U, D, Vt = np.linalg.svd(xd.T @ xs / len(src))
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = float(np.trace(np.diag(D) @ S) / ((xs ** 2).sum() / len(src))) \
        if with_scale else 1.0
    return s, R, mu_d - s * R @ mu_s


def ate_mean(est, gt, with_scale: bool = True) -> float:
    """Mean position error (m) of est [N, 3] after aligning it onto gt."""
    est, gt = np.asarray(est, np.float64), np.asarray(gt, np.float64)
    s, R, t = umeyama(est, gt, with_scale)
    return float(np.linalg.norm((s * (R @ est.T)).T + t - gt, axis=-1).mean())
