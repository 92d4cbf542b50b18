"""Seeded synthetic bundle-adjustment problems, in numpy.

``build_problem`` is the port's own copy of the generator the JAX package's
benchmark uses (``bench.build_problem``): a forward-moving KITTI-like
trajectory of K keyframes, P points near it, each observed from M keyframes
around its anchor, stereo observations with 0.5 px noise, perturbed initial
poses and points. The same seed gives the same arrays in both packages.
``convert.ba_problem_from_numpy`` turns the fields into a ``BAProblem``.
"""
from __future__ import annotations

import numpy as np

from ..geometry.camera import Intrinsics

BENCH_CAM = Intrinsics(fx=718.9, fy=718.9, cx=607.2, cy=185.2, bf=386.1,
                       width=1241, height=376)


def _qmul(a, b):
    w1, x1, y1, z1 = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    w2, x2, y2, z2 = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return np.stack([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                     w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                     w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                     w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], -1)


def _qrot(q, v):
    qv = q[..., 1:]
    uv = np.cross(qv, v)
    uuv = np.cross(qv, uv)
    return v + 2.0 * (q[..., :1] * uv + uuv)


def _qinv(q):
    return q * np.array([1.0, -1.0, -1.0, -1.0], q.dtype)


def _so3exp(w):
    ang = np.linalg.norm(w, axis=-1, keepdims=True)
    ang = np.maximum(ang, 1e-12)
    axis = w / ang
    return np.concatenate([np.cos(ang / 2), np.sin(ang / 2) * axis],
                          -1).astype(np.float32)


def build_problem(K=256, P=65536, M=8, seed=0, active_share=1.0):
    """(fields, cam): the fields of a BAProblem as numpy arrays.

    `active_share` < 1 masks out observation slots at random (after every
    other draw, so the rest of the problem does not depend on it): local
    bundle adjustment runs at a capacity of which only a part is in use.
    """
    cam = BENCH_CAM
    rng = np.random.default_rng(seed)

    # camera trajectory: forward motion with gentle yaw (KITTI-like)
    t_wc = np.cumsum(np.tile([0.0, 0.0, 1.0], (K, 1))
                     + rng.normal(0, 0.05, (K, 3)), axis=0).astype(np.float32)
    yaw = np.cumsum(rng.normal(0, 0.01, K)).astype(np.float32)
    q_wc = np.stack([np.cos(yaw / 2), np.zeros(K), np.sin(yaw / 2),
                     np.zeros(K)], -1).astype(np.float32)
    q_cw = _qinv(q_wc)
    t_cw = -_qrot(q_cw, t_wc)

    # points near the trajectory
    anchor = rng.integers(0, K, P)
    pw = (t_wc[anchor] + np.stack([rng.uniform(-15, 15, P),
                                   rng.uniform(-3, 3, P),
                                   rng.uniform(5, 40, P)], -1)).astype(np.float32)

    # observations: M keyframes around each point's anchor
    offs = rng.integers(-6, 7, size=(P, M))
    obs_kf = np.clip(anchor[:, None] + offs, 0, K - 1).astype(np.int32)
    qk = q_cw[obs_kf.reshape(-1)]
    tk = t_cw[obs_kf.reshape(-1)]
    pc = _qrot(qk, np.repeat(pw, M, 0)) + tk
    z = pc[:, 2]
    u = cam.fx * pc[:, 0] / np.maximum(z, 1e-3) + cam.cx
    v = cam.fy * pc[:, 1] / np.maximum(z, 1e-3) + cam.cy
    ur = u - cam.bf / np.maximum(z, 1e-3)
    ok = (z > 0.5) & (u >= 0) & (u < cam.width) & (v >= 0) & (v < cam.height)
    noise = rng.normal(0, 0.5, (len(u), 3))
    obs_uvr = (np.stack([u, v, ur], -1) + noise).astype(np.float32)

    # perturb initial estimates so LM has real work (first-order se3 exp)
    xi = rng.normal(0, 0.005, (K, 6)).astype(np.float32)
    dq = _so3exp(xi[:, 3:])
    q0 = _qmul(dq, q_cw)
    q0 = (q0 / np.linalg.norm(q0, axis=-1, keepdims=True)).astype(np.float32)
    t0 = _qrot(dq, t_cw) + xi[:, :3]
    pw0 = pw + rng.normal(0, 0.05, pw.shape).astype(np.float32)

    obs_mask = ok.reshape(P, M)
    if active_share < 1.0:
        obs_mask = obs_mask & (rng.random((P, M)) < active_share)
    pose_fixed = np.zeros(K, bool)
    pose_fixed[0] = True
    fields = dict(
        q=q0, t=t0.astype(np.float32), pose_valid=np.ones(K, bool),
        pose_fixed=pose_fixed, pw=pw0.astype(np.float32),
        point_valid=np.ones(P, bool), obs_kf=obs_kf,
        obs_uvr=obs_uvr.reshape(P, M, 3),
        obs_inv_sigma2=np.ones((P, M), np.float32),
        obs_stereo=np.ones((P, M), bool), obs_mask=obs_mask)
    return fields, cam
