"""The multi-agent fixtures of tests/test_server.py (two agents on
overlapping halves of a 20-frame corridor, three agents on overlapping
thirds of a 30-frame one), run through either package's MultiAgentServer on
the same frame features, extracted once by the JAX package, and the same
vocabulary, trained on the scene's own descriptors. Every fusion is
recorded: the agent, the two map ids, the query and match keyframes and the
match's Sim3."""
import contextlib
import dataclasses
import types

import numpy as np
import jax
import jax.numpy as jnp
import torch

from multiagent_orb_slam2_tpu.config import (SlamConfig, OrbConfig, Capacities,
                                             Sensor, TrackingConfig, LoopConfig)
from multiagent_orb_slam2_tpu.geometry.camera import Intrinsics
from multiagent_orb_slam2_tpu.io.synthetic import BoxScene, corridor_trajectory
from multiagent_orb_slam2_tpu.ops import frame as jframe
from multiagent_orb_slam2_tpu.runtime import loop_closing as jlc
from multiagent_orb_slam2_tpu.server import MultiAgentServer as JServer
from multiagent_orb_slam2_tpu.vocab import bow as jbow

from multiagent_orb_slam2_tpu_torch import convert
from multiagent_orb_slam2_tpu_torch.geometry import horn as thorn
from multiagent_orb_slam2_tpu_torch.io import trajectory as ttraj

from torch_parity import (jax_state_from_torch, port_views, threads,
                          torch_feats_from_jax)

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


def jax_sim3_samples(mask, n_iters, seed, size=3):
    """The port's Sim3 RANSAC draw (geometry/horn.draw_samples) replaced by
    the JAX package's: split PRNGKey(seed) n_iters ways, `size` distinct
    indices a row with probabilities mask / sum(mask)."""
    m = jnp.asarray(mask.cpu().numpy())
    keys = jax.random.split(jax.random.PRNGKey(seed), n_iters)
    probs = m.astype(jnp.float32) / jnp.maximum(jnp.sum(m), 1)
    s = jax.vmap(lambda k: jax.random.choice(
        k, m.shape[0], shape=(size,), replace=False, p=probs))(keys)
    return torch.from_numpy(np.array(s)).to(torch.int64).to(mask.device)


@contextlib.contextmanager
def jax_sim3_draws():
    """While active, the port's Sim3 RANSAC (loop and fusion detection)
    draws the JAX package's samples: the two packages' generators differ,
    and a RANSAC hypothesis depends on its samples. On the three-agent
    fixture's two fusions, on the port's state, the port's Sim3 is within
    6.0e-8 of the JAX compute_sim3 with these samples and within 2.1e-7
    with its own (tools/torch_fixture_parting.py)."""
    real = thorn.draw_samples
    thorn.draw_samples = jax_sim3_samples
    try:
        yield
    finally:
        thorn.draw_samples = real


def run(server, frames, windows, views=True, stop=None, centres=None):
    """Drive the agents round robin as tests/test_server.py does, the
    server draining the queues after every tick (two intra-op threads for
    the port, which draws the JAX package's Sim3 RANSAC samples,
    jax_sim3_draws). With views the JAX server's trackers take the port's
    repairs (torch_parity.port_views): they count their own map's
    keyframes at the keyframe-count gates (fault 9) and age map points in
    their own agent's keyframes (fault 11; ROADMAP.md queue 3). stop(server,
    tick), where given, ends the run before the first tick for which it is
    true; centres, where given, gets each tracked frame's camera centre as
    its tracker returned it, None for a frame it did not track, keyed
    (agent, frame_id). Returns the fusion events; the port's carry the map
    state the match was computed on, as the JAX package's MapState, and
    the keyframe uids."""
    events = []
    real = server._fuse

    def fuse(agent, match, sim3_ms):
        events.append({
            "agent": agent, "cur_map": server.multimap.map_of(agent),
            "kf_query": match.kf_query, "kf_match": match.kf_match,
            "sim3": np.concatenate([[match.s], np.asarray(match.q),
                                    np.asarray(match.t)])})
        if not isinstance(server, JServer):
            events[-1].update(state=jax_state_from_torch(server.shared.state),
                              kf_uid=server.shared.kf_uid.copy())
        real(agent, match, sim3_ms)
        events[-1]["dst_map"] = server.stats[-1]["dst_map"]

    server._fuse = fuse
    trackers = [server.register_client(a) for a in range(len(windows))]
    if views and isinstance(server, JServer):
        trackers = [port_views(server, t) for t in trackers]
    with threads(2), jax_sim3_draws():
        for i in range(len(frames)):
            if stop is not None and stop(server, i):
                break
            for a, (lo, hi) in enumerate(windows):
                if lo <= i < hi:
                    pose = trackers[a].track_features(frames[i],
                                                      frame_id=i - lo)
                    if centres is not None:
                        centres[a, i - lo] = None if pose is None else \
                            _centre(*pose)
            server.process_new_keyframes()
    return events


def _centre(q, t):
    q, t = (np.asarray(x, np.float64) for x in (q, t))
    return -_quat_matrix(q).T @ t


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


def _aligned(sim3, ref):
    """sim3 [s, q, t] with q's sign taken to agree with ref's."""
    return sim3 * (1 if sim3[1:5] @ ref[1:5] >= 0
                   else np.r_[1, -np.ones(4), 1, 1, 1])


def assert_fusions_match(jevents, tevents, jvocab, sim3_tol=1e-4,
                         parted=()):
    """The same fusions in the same order: agent, map ids, query and match
    keyframes. Each of the port's matches within sim3_tol of the JAX run's
    match, and within sim3_tol of the JAX package's compute_sim3 on the map
    state the port computed it on, with the same RANSAC samples
    (jax_sim3_draws). `parted` names the fusions (by index) that are held
    by the second comparison only: fusions at which the two runs' maps are
    measured to have parted further than a Sim3 between those keyframes
    can absorb (tests/test_torch_server_three_agents.py says where and
    why)."""
    key = ("agent", "cur_map", "dst_map", "kf_query", "kf_match")
    assert [tuple(e[k] for k in key) for e in tevents] == \
        [tuple(e[k] for k in key) for e in jevents]
    for i, (je, te) in enumerate(zip(jevents, tevents)):
        if i not in parted:
            np.testing.assert_allclose(_aligned(te["sim3"], je["sim3"]),
                                       je["sim3"], atol=sim3_tol)
        shared = types.SimpleNamespace(state=te["state"],
                                       kf_uid=te["kf_uid"])
        m = jlc.LoopCloser(CFG, jvocab).compute_sim3(
            shared, te["kf_query"], te["kf_match"])
        assert m is not None, te["kf_query"]
        want = np.concatenate([[m.s], np.asarray(m.q), np.asarray(m.t)])
        np.testing.assert_allclose(_aligned(te["sim3"], want), want,
                                   atol=sim3_tol)