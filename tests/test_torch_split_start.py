"""Fault 11 (ROADMAP.md queue 3): agent 0 of the 2-agent split reset at
its frame 5, in the port and, with the port's keyframe-count gates, in the
JAX package too.

The clip is the first 7 ticks of trial 0's split: frames 0-6 (agent 0) and
330-336 (agent 1) of the 660-frame loop corridor (make_synth_seq seed 0,
512x288, 600 ORB features, its settings) at small capacities, the frames'
features extracted once by the JAX package and given to both packages,
with a vocabulary trained on them. tools/jax_split_start.py prints the
same ticks at the default capacities.

The cause: map-point culling's age test counts keyframe creations, and
every agent's keyframes advance that count, so agent 1's keyframes age
agent 0's young map and cull it (the JAX package: agent 1's keyframe at
tick 4 takes all but one of agent 0's points; agent 0 is LOST at tick 5
and resets at tick 6). The port counts a point's age in its own agent's
keyframes (SharedMap.kf_agent_seq), as a single run does.

- The deviation, at the step: on the state of the JAX run before agent
  1's keyframe of tick 4, the JAX cull_points_step culls agent 0's points;
  the port's, with the port's sequence, culls none of them, and equals the
  JAX step run on the same sequence (the JAX state's kf_seq replaced by
  it) field for field.
- The deviation, whole run: the JAX server with the port's gates
  (OwnMapGates) resets agent 0 at tick 6; the port's server resets no
  agent, and neither does the JAX server through port_views (OwnMapGates
  and OwnAgentAges), which the port equals tick by tick: the same tracking
  states and keyframes made, inliers within 2 of 300, camera centres within
  2 mm (the whole-run tolerance of tests/test_torch_system.py).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multiagent_orb_slam2_tpu.config import Capacities, Sensor, from_yaml_dict
from multiagent_orb_slam2_tpu.ops import frame as jframe
from multiagent_orb_slam2_tpu.runtime import mapping as jmapping
from multiagent_orb_slam2_tpu.server import MultiAgentServer as JServer
from multiagent_orb_slam2_tpu.vocab import bow as jbow
from multiagent_orb_slam2_tpu_torch import convert
from multiagent_orb_slam2_tpu_torch.analysis import make_synth_seq
from multiagent_orb_slam2_tpu_torch.runtime import mapping as tmapping
from multiagent_orb_slam2_tpu_torch.runtime.tracker import _np_inverse
from multiagent_orb_slam2_tpu_torch.server import MultiAgentServer as TServer

from torch_parity import (OwnMapGates, assert_states_match, port_views,
                          threads, torch_feats_from_jax, torch_state_from_jax)

TICKS, HALF = 7, 330
SETTINGS = {
    "Camera.fx": 260.0, "Camera.fy": 260.0, "Camera.cx": 256.0,
    "Camera.cy": 144.0, "Camera.bf": 260.0 * 0.12, "Camera.width": 512,
    "Camera.height": 288, "Camera.fps": 10.0, "ThDepth": 35.0,
    "ORBextractor.nFeatures": 600}
CFG = from_yaml_dict(SETTINGS, sensor=Sensor.STEREO).replace(
    caps=Capacities(max_keyframes=16, max_points=8192, max_features=1024,
                    local_points=4096))
TCFG = convert.config_from_dict({**dataclasses.asdict(CFG),
                                 "camera": CFG.camera})


@pytest.fixture(scope="module")
def clip():
    """(JAX features of agent 0's and agent 1's frames, the port's, the
    JAX vocabulary, the port's)."""
    q, t = make_synth_seq.loop_trajectory(2 * HALF, 1.0, 24.0, seed=0)
    picked = list(range(TICKS)) + list(range(HALF, HALF + TICKS))
    frames = make_synth_seq.render_stereo_frames(
        0, make_synth_seq.camera(), q[picked], t[picked])

    def stored(img):
        # as the drivers read a sequence: uint8 on disk, float32 in memory
        return jnp.asarray(np.clip(img, 0, 255).astype(np.uint8)
                           .astype(np.float32))
    jf = [jframe.extract_frame(stored(left), CFG, right_img=stored(right))
          for left, right, _ in frames]
    descs = np.concatenate([np.asarray(f.desc)[np.asarray(f.valid)]
                            for f in jf])
    jv = jbow.train_vocabulary(descs, k=8, depth=3, seed=5)
    tv = convert.vocabulary_from_numpy(
        {"centroids": [np.asarray(c) for c in jv.centroids],
         "idf": np.asarray(jv.idf), "k": jv.k, "depth": jv.depth}, "cpu")
    jfeats = (jf[:TICKS], jf[TICKS:])
    return jfeats, tuple([torch_feats_from_jax(f) for f in part]
                         for part in jfeats), jv, tv


def _drive(server, trackers, feats, current=None):
    """Track the clip round robin, the server draining its queues after
    every tick; per agent and tick (state, inliers or None, keyframes
    made, camera centre or None) and the resets. current["agent"], where
    given, names the agent being tracked."""
    resets = [0] * len(trackers)
    for a, tr in enumerate(trackers):
        def counting(real=tr.reset, a=a):
            resets[a] += 1
            real()
        tr.reset = counting
    ticks = []
    with threads(2):
        for i in range(TICKS):
            row = []
            for a, tr in enumerate(trackers):
                if current is not None:
                    current["agent"] = a
                n0 = server.shared.n_created
                pose = tr.track_features(feats[a][i], frame_id=i)
                dec = tr._last_decision
                row.append((int(tr.state),
                            None if dec is None else int(dec[1]),
                            server.shared.n_created - n0,
                            None if pose is None else _centre(*pose)))
            server.process_new_keyframes()
            ticks.append(row)
    return ticks, resets


def _centre(q, t):
    return _np_inverse(np.asarray(q, np.float64),
                       np.asarray(t, np.float64))[1]


@pytest.fixture(scope="module")
def jax_gates_only(clip):
    """The JAX server with the port's keyframe-count gates only; its state
    just before agent 1's keyframe of tick 4 is inserted, that keyframe's
    slot and uid, and every keyframe allocation as (agent, uid)."""
    jfeats, _, jv, _ = clip
    server = JServer(CFG, jv)
    trackers = [server.register_client(a) for a in range(2)]
    for tr in trackers:
        tr.shared = OwnMapGates(
            tr.shared, lambda tr=tr: server.multimap.map_of(tr.agent))
    shared, current, kept = server.shared, {}, {"allocs": []}
    real_alloc = shared.alloc_kf

    def alloc():
        slot = real_alloc()
        kept["allocs"].append((current["agent"], int(shared.kf_uid[slot])))
        return slot
    shared.alloc_kf = alloc
    real = trackers[1]._create_keyframe

    def keep(feats, tr):
        if trackers[1].frame_id == 4:
            kept.update(state=shared.state, uid=shared.n_created,
                        slot=shared.free_kf[-1] if shared.free_kf
                        else shared.n_kf, n_allocs=len(kept["allocs"]))
        return real(feats, tr)
    trackers[1]._create_keyframe = keep
    ticks, resets = _drive(server, trackers, jfeats, current)
    return ticks, resets, kept


def test_jax_culls_the_other_agents_young_map(jax_gates_only):
    ticks, resets, _ = jax_gates_only
    assert resets == [1, 0]
    state, _, _, _ = ticks[5][0]
    assert state == 2                      # agent 0 LOST at tick 5
    assert ticks[6][0][1] is None          # and initialized anew at tick 6


def test_cull_step_ages_points_per_agent(jax_gates_only):
    _, _, kept = jax_gates_only
    jstate, slot = kept["state"], kept["slot"]
    # the keyframe about to be inserted: agent 1's, with the next uid
    allocs = kept["allocs"][:kept["n_allocs"]] + [(1, kept["uid"])]
    seq = np.asarray(jstate.kf_seq).copy()
    agent = np.asarray(jstate.kf_agent).copy()
    seq[slot], agent[slot] = kept["uid"], 1
    jstate = jstate._replace(kf_seq=jnp.asarray(seq),
                             kf_agent=jnp.asarray(agent))
    # the port's sequence (SharedMap.kf_agent_seq): each keyframe's ordinal
    # among its agent's creations plus agent * AGENT_SEQ_STRIDE
    ordinal = {uid: a * tmapping.AGENT_SEQ_STRIDE
               + sum(1 for b, _ in allocs[:i] if b == a)
               for i, (a, uid) in enumerate(allocs)}
    ords = np.array([ordinal.get(int(u), -1) if u >= 0 else -1
                     for u in seq], np.int32)
    mp_agent = np.asarray(jstate.mp_agent)
    valid = np.asarray(jstate.mp_valid)
    jcut = np.asarray(jmapping.cull_points_step(jstate, slot, CFG).mp_valid)
    assert np.sum(valid & ~jcut & (mp_agent == 0)) > 100
    tstate = torch_state_from_jax(jstate)
    got = tmapping.cull_points_step(tstate, slot, TCFG,
                                    torch.from_numpy(ords))
    assert not np.any(valid & ~got.mp_valid.numpy() & (mp_agent == 0))
    want = jmapping.cull_points_step(
        jstate._replace(kf_seq=jnp.asarray(ords)), slot, CFG)
    assert_states_match(want, got, skip=("kf_seq",))


def test_port_split_start_matches_jax_through_port_views(clip):
    jfeats, tfeats, jv, tv = clip
    tserver = TServer(TCFG, tv, device="cpu")
    tticks, tresets = _drive(
        tserver, [tserver.register_client(a) for a in range(2)], tfeats)
    jserver = JServer(CFG, jv)
    jticks, jresets = _drive(
        jserver, [port_views(jserver, jserver.register_client(a))
                  for a in range(2)], jfeats)
    assert tresets == jresets == [0, 0]
    for i, (trow, jrow) in enumerate(zip(tticks, jticks)):
        for a, (got, want) in enumerate(zip(trow, jrow)):
            assert got[0] == want[0] == 1 and got[2] == want[2], (i, a)
            if want[1] is not None:
                assert abs(got[1] - want[1]) <= 2, (i, a, got[1], want[1])
            assert np.abs(got[3] - want[3]).max() <= 2e-3, (i, a)
