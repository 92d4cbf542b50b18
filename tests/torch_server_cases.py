"""The multi-agent fixtures of tests/test_server.py (two agents on
overlapping halves of a 20-frame corridor, three agents on overlapping
thirds of a 30-frame one), run through either package's MultiAgentServer on
the same frame features, extracted once by the JAX package, and the same
vocabulary, trained on the scene's own descriptors. Every fusion is
recorded: the agent, the two map ids, the query and match keyframes and the
match's Sim3."""
import dataclasses

import numpy as np
import jax.numpy as jnp

from multiagent_orb_slam2_tpu.config import (SlamConfig, OrbConfig, Capacities,
                                             Sensor, TrackingConfig, LoopConfig)
from multiagent_orb_slam2_tpu.geometry.camera import Intrinsics
from multiagent_orb_slam2_tpu.io.synthetic import BoxScene, corridor_trajectory
from multiagent_orb_slam2_tpu.ops import frame as jframe
from multiagent_orb_slam2_tpu.vocab import bow as jbow

from multiagent_orb_slam2_tpu_torch import convert
from multiagent_orb_slam2_tpu_torch.io import trajectory as ttraj

from torch_parity import threads, torch_feats_from_jax

CAM = Intrinsics(fx=230.0, fy=230.0, cx=160.0, cy=120.0, bf=115.0,
                 width=320, height=240)
CFG = SlamConfig(
    camera=CAM, sensor=Sensor.STEREO,
    orb=OrbConfig(n_features=400, n_levels=4),
    tracking=TrackingConfig(max_frames_between_kf=4, th_depth=60.0),
    loop=LoopConfig(consistency_th=2, refractory_kfs=4),
    caps=Capacities(max_keyframes=64, max_points=16384, max_features=512,
                    local_points=4096),
)
TCFG = convert.config_from_dict({**dataclasses.asdict(CFG), "camera": CAM})

# (scene seed, trajectory seed, frames, vocabulary seed, agent windows)
TWO_AGENTS = (11, 2, 20, 5, ((0, 12), (8, 20)))
THREE_AGENTS = (12, 3, 30, 6, ((0, 14), (10, 24), (20, 30)))


def scenario(case):
    """(JAX features, port features, JAX vocabulary, port vocabulary,
    ground-truth camera centres [N, 3], windows)."""
    scene_seed, traj_seed, n, vocab_seed, windows = case
    scene = BoxScene(seed=scene_seed, z_far=40.0)
    q_wc, t_wc = corridor_trajectory(n, step=0.15, seed=traj_seed)
    frames = []
    for i in range(n):
        left, right, _ = scene.render_stereo(CAM, q_wc[i], t_wc[i])
        frames.append(jframe.extract_frame(jnp.asarray(left), CFG,
                                           right_img=jnp.asarray(right)))
    descs = np.concatenate(
        [np.asarray(frames[i].desc)[np.asarray(frames[i].valid)]
         for i in (0, n // 2, n - 1)])
    jv = jbow.train_vocabulary(descs, k=8, depth=3, seed=vocab_seed)
    tv = convert.vocabulary_from_numpy(
        {"centroids": [np.asarray(c) for c in jv.centroids],
         "idf": np.asarray(jv.idf), "k": jv.k, "depth": jv.depth}, "cpu")
    return (frames, [torch_feats_from_jax(f) for f in frames], jv, tv,
            t_wc, windows)


def run(server, frames, windows):
    """Drive the agents round robin as tests/test_server.py does, the
    server draining the queues after every tick (two intra-op threads for
    the port). Returns the fusion events."""
    events = []
    real = server._fuse

    def fuse(agent, match, sim3_ms):
        events.append({
            "agent": agent, "cur_map": server.multimap.map_of(agent),
            "kf_query": match.kf_query, "kf_match": match.kf_match,
            "sim3": np.concatenate([[match.s], np.asarray(match.q),
                                    np.asarray(match.t)])})
        real(agent, match, sim3_ms)
        events[-1]["dst_map"] = server.stats[-1]["dst_map"]

    server._fuse = fuse
    trackers = [server.register_client(a) for a in range(len(windows))]
    with threads(2):
        for i in range(len(frames)):
            for a, (lo, hi) in enumerate(windows):
                if lo <= i < hi:
                    trackers[a].track_features(frames[i], frame_id=i - lo)
            server.process_new_keyframes()
    return events


def keyframe_ate(fields, windows, t_wc):
    """RMSE of the live keyframes' camera centres against the ground truth
    (no scale), as tests/test_server.py's accuracy test computes it."""
    est, gt = [], []
    for k in np.nonzero(fields["kf_valid"])[0]:
        q, t = fields["kf_q"][k].astype(np.float64), \
            fields["kf_t"][k].astype(np.float64)
        R = _quat_matrix(q)
        est.append(-R.T @ t)
        lo = windows[int(fields["kf_agent"][k])][0]
        gt.append(t_wc[int(fields["kf_frame_id"][k]) + lo])
    return ttraj.ate(np.stack(est), np.stack(gt), with_scale=False)["rmse"]


def _quat_matrix(q):
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def assert_fusions_match(jevents, tevents, sim3_tol=1e-4):
    """The same fusions in the same order: agent, map ids, query and match
    keyframes; the match's Sim3 within sim3_tol."""
    key = ("agent", "cur_map", "dst_map", "kf_query", "kf_match")
    assert [tuple(e[k] for k in key) for e in tevents] == \
        [tuple(e[k] for k in key) for e in jevents]
    for je, te in zip(jevents, tevents):
        want = je["sim3"] * (1 if te["sim3"][1:5] @ je["sim3"][1:5] >= 0
                             else np.r_[1, -np.ones(4), 1, 1, 1])
        np.testing.assert_allclose(te["sim3"], want, atol=sim3_tol)
