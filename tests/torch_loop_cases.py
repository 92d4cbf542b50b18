"""Fabricated drifted maps for the loop-closing tests of the port, and the
ring that ``chip_smoke.py`` closes on the card.

Copies of ``tests/test_loop_closing.py::build_drifted_loop`` and
``build_drifted_ring`` written with numpy, torch and the port only (the same
seeds, the same draws), so they also run where the JAX package is not
installed. ``tests/test_torch_loop_closing.py`` holds them against the JAX
builders: integers equal, floats within 1e-5.
"""
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from multiagent_orb_slam2_tpu_torch.config import (  # noqa: E402
    Capacities, LoopConfig, OrbConfig, Sensor, SlamConfig)
from multiagent_orb_slam2_tpu_torch.geometry import se3  # noqa: E402
from multiagent_orb_slam2_tpu_torch.geometry.camera import (  # noqa: E402
    Intrinsics)
from multiagent_orb_slam2_tpu_torch.mapstate import state as ms  # noqa: E402
from multiagent_orb_slam2_tpu_torch.ops.frame import (  # noqa: E402
    FrameFeatures)
from multiagent_orb_slam2_tpu_torch.runtime.tracker import (  # noqa: E402
    SharedMap)
from multiagent_orb_slam2_tpu_torch.utils.torch_ops import (  # noqa: E402
    fill_at)

CAM = Intrinsics(fx=450.0, fy=450.0, cx=320.0, cy=240.0, bf=45.0)
CFG = SlamConfig(
    camera=CAM, sensor=Sensor.STEREO,
    orb=OrbConfig(n_features=256, n_levels=4),
    loop=LoopConfig(consistency_th=1, refractory_kfs=3, min_total_matches=30),
    caps=Capacities(max_keyframes=16, max_points=4096, max_features=256,
                    local_points=2048),
)
# the top scale factor the JAX builders read from their module's CFG,
# whatever configuration they are given
SF_TOP = CFG.orb.scale_factors[-1]


def _f32(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float32)


def _quat_y(ang):
    return se3.so3_exp_quat(_f32([0.0, ang, 0.0])).numpy()


def _inverse(q, t):
    qi, ti = se3.inverse(_f32(q), _f32(t))
    return qi.numpy(), ti.numpy()


def _apply(q, t, p):
    return se3.apply(_f32(q), _f32(t), _f32(p)).numpy()


def _gt_poses(angles, radius):
    """Camera-to-world poses on a circle of `radius` around (0, 0, radius)."""
    qs, ts = [], []
    for ang in angles:
        qs.append(_quat_y(ang))
        ts.append(np.array([radius * np.sin(ang), 0.0,
                            radius - radius * np.cos(ang)], np.float32))
    return qs, ts


def _clusters(rng, qs_gt, ts_gt, n_clusters, n_pts_per):
    """One cluster of n_pts_per points 6 m ahead of each of the first
    n_clusters cameras, with random descriptors."""
    pts, descs, owner = [], [], []
    for k in range(n_clusters):
        R = se3.quat_to_matrix(_f32(qs_gt[k])).numpy()
        ahead = ts_gt[k] + R @ np.array([0, 0, 6.0])
        pts.append(ahead + rng.uniform(-2, 2, (n_pts_per, 3)))
        descs.append(rng.integers(0, 2**32, (n_pts_per, 8), dtype=np.uint32))
        owner += [k] * n_pts_per
    return (np.concatenate(pts).astype(np.float32), np.concatenate(descs),
            np.asarray(owner))


def _drifted_chain(rng, qs_gt, ts_gt, drift):
    """World-to-camera estimates whose drift accumulates as a random walk:
    small relative noise between neighbours, growing absolute error."""
    q_est, t_est = [], []
    xi_acc = np.zeros(6)
    for k in range(len(qs_gt)):
        qcw, tcw = se3.inverse(_f32(qs_gt[k]), _f32(ts_gt[k]))
        if k == 0:
            q_est.append(qcw.numpy())
            t_est.append(tcw.numpy())
        else:
            xi_acc = xi_acc + np.concatenate([
                rng.normal(0, drift, 3), rng.normal(0, drift * 0.3, 3)])
            dq, dt = se3.se3_exp(_f32(xi_acc))
            qq, tt = se3.compose(dq, dt, qcw, tcw)
            q_est.append(qq.numpy())
            t_est.append(tt.numpy())
    return q_est, t_est


def _drift_points(pts, owner, qs_gt, ts_gt, q_est, t_est, n_clusters):
    """Each point as its owner keyframe sees it, unprojected through that
    keyframe's drifted pose."""
    pts_est = pts.copy()
    for k in range(n_clusters):
        sel = owner == k
        qcw_gt, tcw_gt = _inverse(qs_gt[k], ts_gt[k])
        pc = _apply(qcw_gt, tcw_gt, pts[sel])
        qwc_e, twc_e = _inverse(q_est[k], t_est[k])
        pts_est[sel] = _apply(qwc_e, twc_e, pc)
    return pts_est


def _visible(pts, vis, qs_gt, ts_gt, k, F):
    """The points of `vis` in front of camera k and inside its 640x480
    image, at most F: (vis, u, v, pc)."""
    qcw_gt, tcw_gt = _inverse(qs_gt[k], ts_gt[k])
    pc = _apply(qcw_gt, tcw_gt, pts[vis])
    ok = pc[:, 2] > 0.5
    vis, pc = vis[ok], pc[ok]
    u = CAM.fx * pc[:, 0] / pc[:, 2] + CAM.cx
    v = CAM.fy * pc[:, 1] / pc[:, 2] + CAM.cy
    inb = (u >= 0) & (u < 640) & (v >= 0) & (v < 480)
    vis, u, v, pc = vis[inb], u[inb], v[inb], pc[inb]
    n = min(len(vis), F)
    return vis[:n], u[:n], v[:n], pc[:n]


def _insert(st, k, F, vis, u, v, pc, slots, is_new, pos_new, descs, twc_e,
            device):
    """Create keyframe k's new points and insert keyframe k (parent k - 1,
    keyframe 0 the fixed origin)."""
    n = len(vis)
    ur = u - CAM.bf / pc[:, 2]

    def padded(a, fill, dtype):
        out = np.full((F,) + np.shape(a)[1:], fill, dtype)
        out[:n] = a
        return torch.from_numpy(out).to(device)

    feats = FrameFeatures(
        xy=padded(np.stack([u, v], -1), 0.0, np.float32),
        response=torch.zeros(F, device=device),
        level=torch.zeros(F, dtype=torch.int32, device=device),
        angle=torch.zeros(F, device=device),
        desc=padded(descs[vis].view(np.int32), 0, np.int32),
        valid=padded(np.ones(n, bool), False, bool),
        u_right=padded(ur, -1.0, np.float32),
        depth=padded(pc[:, 2], -1.0, np.float32))
    frame_mp = padded(slots, -1, np.int32)
    # realistic scale band: max_dist about the creation distance at level 0
    dist_k = np.linalg.norm(pos_new - np.asarray(twc_e)[None], axis=1)
    normal = np.zeros((n, 3), np.float32)
    normal[:, 2] = 1.0

    def dev(a, dtype=np.float32):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    st = ms.add_points(
        st, dev(slots, np.int32), dev(pos_new), dev(descs[vis].view(np.int32),
                                                    np.int32),
        dev(normal), dev(dist_k / SF_TOP), dev(dist_k * 1.05),
        ref_kf=dev(np.full(n, k), np.int32),
        agent=dev(np.zeros(n), np.int32), map_id=dev(np.zeros(n), np.int32),
        valid=dev(is_new, bool))
    return st, feats, frame_mp


def build_drifted_loop(n_kf=10, n_pts_per=80, drift=0.03, seed=0,
                       device="cpu"):
    """Ground truth: cameras on a circle, world points around each position.
    Estimated: a drifting odometry chain. The last keyframe truly revisits
    keyframe 0's area, and its tracking re-created duplicate points for
    keyframe 0's cluster. Returns (shared, (qs_gt, ts_gt), descs)."""
    rng = np.random.default_rng(seed)
    F = CFG.caps.max_features
    shared = SharedMap(CFG, device=device)
    st = shared.state
    qs_gt, ts_gt = _gt_poses(
        [2 * np.pi * k / (n_kf - 1) for k in range(n_kf)], 4)
    pts, descs, owner = _clusters(rng, qs_gt, ts_gt, n_kf, n_pts_per)
    q_est, t_est = _drifted_chain(rng, qs_gt, ts_gt, drift)
    pts_est = _drift_points(pts, owner, qs_gt, ts_gt, q_est, t_est, n_kf)

    mp_ids = np.arange(len(pts))
    n_dup = 0
    for k in range(n_kf):
        is_last = k == n_kf - 1
        vis_mask = owner == k
        if k > 0:
            vis_mask |= owner == k - 1
        if is_last:
            vis_mask |= owner == 0
        vis, u, v, pc = _visible(pts, np.nonzero(vis_mask)[0], qs_gt, ts_gt,
                                 k, F)
        slots = mp_ids[vis].copy()
        is_new = owner[vis] == k
        if is_last:
            dup_sel = owner[vis] == 0
            slots[dup_sel] = len(pts) + np.arange(dup_sel.sum())
            is_new = is_new | dup_sel
            n_dup = int(dup_sel.sum())
        qwc_e, twc_e = _inverse(q_est[k], t_est[k])
        p_drift = _apply(qwc_e, twc_e, pc)
        pos_new = np.where(is_new[:, None], p_drift, pts_est[vis])
        st, feats, frame_mp = _insert(st, k, F, vis, u, v, pc, slots, is_new,
                                      pos_new, descs, twc_e, device)
        st = ms.insert_keyframe(st, k, feats, _f32(q_est[k]).to(device),
                                _f32(t_est[k]).to(device), k, 0, 0, frame_mp,
                                parent=k - 1 if k > 0 else -1,
                                fixed_origin=(k == 0))
    shared.state = st
    shared.n_kf = n_kf
    shared.n_mp = len(pts) + n_dup
    return shared, (qs_gt, ts_gt), descs


def build_drifted_ring(n_kf=110, n_rev=5, n_pts_per=60, drift=0.02, seed=2,
                       cfg=None, device="cpu"):
    """A long drifted ring whose final n_rev keyframes revisit the first
    viewpoints (same clusters, duplicate slots, drifted poses): the input
    DetectLoop and its consistency groups need. Returns (shared, gt poses).
    `cfg` sets the capacities; the camera is always CAM."""
    cfg = cfg or CFG
    rng = np.random.default_rng(seed)
    F = cfg.caps.max_features
    shared = SharedMap(cfg, device=device)
    st = shared.state
    n_base = n_kf - n_rev
    qs_gt, ts_gt = _gt_poses(
        [2 * np.pi * (k if k < n_base else k - n_base) / n_base
         for k in range(n_kf)], 8)
    pts, descs, owner = _clusters(rng, qs_gt, ts_gt, n_base, n_pts_per)
    q_est, t_est = _drifted_chain(rng, qs_gt, ts_gt, drift)
    pts_est = _drift_points(pts, owner, qs_gt, ts_gt, q_est, t_est, n_base)

    next_slot = len(pts)
    for k in range(n_kf):
        k0 = k if k < n_base else k - n_base
        vis_mask = (owner == k0) | (owner == (k0 - 1) % n_base)
        vis, u, v, pc = _visible(pts, np.nonzero(vis_mask)[0], qs_gt, ts_gt,
                                 k, F)
        slots = vis.copy()
        if k < n_base:
            is_new = owner[vis] == k
        else:
            # revisit: tracking re-created duplicate points for everything
            slots = next_slot + np.arange(len(vis))
            next_slot += len(vis)
            is_new = np.ones(len(vis), bool)
        qwc_e, twc_e = _inverse(q_est[k], t_est[k])
        p_drift = _apply(qwc_e, twc_e, pc)
        pos_new = np.where(is_new[:, None], p_drift, pts_est[vis])
        slot = shared.alloc_kf()
        assert slot == k
        st, feats, frame_mp = _insert(st, k, F, vis, u, v, pc, slots, is_new,
                                      pos_new, descs, twc_e, device)
        st = st._replace(kf_seq=fill_at(st.kf_seq.clone(), k, k))
        st = ms.insert_keyframe(st, k, feats, _f32(q_est[k]).to(device),
                                _f32(t_est[k]).to(device), k, 0, 0, frame_mp,
                                parent=k - 1 if k > 0 else -1,
                                fixed_origin=(k == 0))
        shared.state = st
    shared.n_kf = n_kf
    shared.n_mp = next_slot
    return shared, (qs_gt, ts_gt)


def ring_points(n_kf, n_rev, n_pts_per):
    """Point slots the ring fills: one cluster per base keyframe plus the
    revisit keyframes' duplicates (each sees at most its own and the
    previous cluster)."""
    return (n_kf - n_rev) * n_pts_per + n_rev * 2 * n_pts_per
