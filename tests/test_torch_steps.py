"""One call each of the port's runtime steps against the JAX ones, from the
same converted MapState and FrameFeatures: pose 1e-4, decision vector equal
except n_inliers within 2, integer map arrays equal on >= 99.5 % of their
entries, covis equal."""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from multiagent_orb_slam2_tpu.mapstate import state as jms
from multiagent_orb_slam2_tpu.runtime import mapping as jmapping
from multiagent_orb_slam2_tpu.runtime import steps as jsteps
from multiagent_orb_slam2_tpu_torch.mapstate import state as tms
from multiagent_orb_slam2_tpu_torch.ops import frame as tframe
from multiagent_orb_slam2_tpu_torch.runtime import mapping as tmapping
from multiagent_orb_slam2_tpu_torch.runtime import steps as tsteps

from torch_parity import (CFG, TCFG, assert_states_match,
                          jax_feats_from_torch, jax_state_from_torch,
                          port_tracker_after, t2j)


@pytest.fixture(scope="module")
def world():
    tr, shared, feats = port_tracker_after(4)
    return tr, shared, feats, jax_state_from_torch(shared.state)


def test_stereo_init_step(world):
    _, _, feats, _ = world
    f = feats[0]
    js, jmp, jn = jsteps.stereo_init_step(
        jms.empty_map_state(CFG), jax_feats_from_torch(f), 0, 0, 0, 0, 0, CFG)
    ts, tmp, tn = tsteps.stereo_init_step(
        tms.empty_map_state(TCFG, device="cpu"), f, 0, 0, 0, 0, 0, TCFG)
    assert int(jn) == int(tn) > 100
    np.testing.assert_array_equal(tmp.numpy(), np.asarray(jmp))
    assert_states_match(js, ts, atol=1e-5)


def test_track_frame_step(world):
    tr, shared, feats, jstate = world
    cur, prev = feats[4], feats[3]
    args_t = (shared.state, cur, prev, tr.last_frame_mp, tr.ref_kf,
              tr.last_q, tr.last_t, tr.vel_q, tr.vel_t, tr.has_velocity,
              shared.n_kf > 2, TCFG)
    out_t, st_t, dec_t, aux_t = tsteps.track_frame_step(*args_t)
    out_j, st_j, dec_j, aux_j = jsteps.track_frame_step(
        jstate, jax_feats_from_torch(cur), jax_feats_from_torch(prev),
        t2j(tr.last_frame_mp), tr.ref_kf, t2j(tr.last_q), t2j(tr.last_t),
        t2j(tr.vel_q), t2j(tr.vel_t), tr.has_velocity, shared.n_kf > 2, CFG)
    np.testing.assert_allclose(out_t.q.numpy(), np.asarray(out_j.q), atol=1e-4)
    np.testing.assert_allclose(out_t.t.numpy(), np.asarray(out_j.t), atol=1e-4)
    dj, dt = np.asarray(dec_j), dec_t.numpy()
    assert dt[0] == dj[0] == 1
    assert abs(int(dt[1]) - int(dj[1])) <= 2
    np.testing.assert_array_equal(dt[2:], dj[2:])
    assert np.mean(out_t.frame_mp.numpy() == np.asarray(out_j.frame_mp)) >= 0.995
    assert_states_match(st_j, st_t, int_share=0.995, atol=1e-5)
    for a, b in zip(aux_j, aux_t):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-4)


def test_keyframe_pipeline_step(world):
    tr, shared, feats, jstate = world
    cur = feats[4]
    slot, base = shared.n_kf, shared.n_mp
    # the keyframe's creation sequence number, as SharedMap.alloc_kf writes it
    kf_seq = shared.state.kf_seq.clone()
    kf_seq[slot] = shared.n_created
    tstate = shared.state._replace(kf_seq=kf_seq)
    jstate = jstate._replace(kf_seq=t2j(kf_seq))
    tr_out, _, _, _ = tsteps.track_frame_step(
        shared.state, cur, feats[3], tr.last_frame_mp, tr.ref_kf, tr.last_q,
        tr.last_t, tr.vel_q, tr.vel_t, tr.has_velocity, True, TCFG)
    out_t = tsteps.keyframe_pipeline_step(
        tstate, cur, tr_out.q, tr_out.t, tr_out.frame_mp, 4, 0, 0, slot, base,
        TCFG, False, kf_seq)
    out_j = jsteps.keyframe_pipeline_step(
        jstate, jax_feats_from_torch(cur), t2j(tr_out.q), t2j(tr_out.t),
        t2j(tr_out.frame_mp), 4, 0, 0, slot, base, CFG, False)
    st_j, mp_j, q_j, t_j, n_j, cull_j = out_j
    st_t, mp_t, q_t, t_t, n_t, cull_t = out_t
    assert abs(int(n_j) - int(n_t)) <= 2 and int(n_t) > 50
    np.testing.assert_allclose(q_t.numpy(), np.asarray(q_j), atol=1e-4)
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), atol=1e-4)
    assert np.mean(mp_t.numpy() == np.asarray(mp_j)) >= 0.995
    np.testing.assert_array_equal(cull_t.numpy(), np.asarray(cull_j))
    np.testing.assert_array_equal(st_t.covis.numpy(), np.asarray(st_j.covis))
    assert_states_match(st_j, st_t, int_share=0.995, atol=1e-4,
                        float_share=0.995)


def test_create_keyframe_and_triangulate_pair(world):
    tr, shared, feats, jstate = world
    cur = feats[4]
    slot, base = shared.n_kf, shared.n_mp
    fmp = tr.last_frame_mp
    js, jmp, jn = jsteps.create_keyframe_step(
        jstate, jax_feats_from_torch(cur), t2j(tr.last_q), t2j(tr.last_t),
        t2j(fmp), 4, 0, 0, slot, base, CFG)
    ts, tmp, tn = tsteps.create_keyframe_step(
        shared.state, cur, tr.last_q, tr.last_t, fmp, 4, 0, 0, slot, base,
        TCFG)
    assert int(jn) == int(tn)
    np.testing.assert_array_equal(tmp.numpy(), np.asarray(jmp))
    assert_states_match(js, ts, atol=1e-5)
    js2, jn2 = jsteps.triangulate_pair_step(js, 3, 1, base + int(jn), CFG)
    ts2, tn2 = tsteps.triangulate_pair_step(ts, 3, 1, base + int(tn), TCFG)
    assert abs(int(jn2) - int(tn2)) <= 1
    assert_states_match(js2, ts2, int_share=0.995, atol=1e-4,
                        float_share=0.995)


def test_mapping_steps(world):
    tr, shared, feats, jstate = world
    tstate = shared.state
    assert_states_match(jmapping.rebuild_observations(jstate),
                        tmapping.rebuild_observations(tstate))
    assert_states_match(jsteps.recompute_covisibility(jstate),
                        tsteps.recompute_covisibility(tstate))
    assert_states_match(jmapping.cull_points_step(jstate, 3, CFG),
                        tmapping.cull_points_step(tstate, 3, TCFG,
                                                  tstate.kf_seq))
    P = CFG.caps.max_points
    own = tstate.kf_mp[3]
    ids = torch.where(own >= 0, own.long(), torch.full_like(own, P).long())
    jf = jmapping.fuse_into_kf(jstate, t2j(ids).astype(jnp.int32), 2, CFG)
    tf = tmapping.fuse_into_kf(tstate, ids, 2, TCFG)
    assert_states_match(jf, tf)
    erase = np.zeros(tuple(tstate.mp_obs_kf.shape), bool)
    erase[:200, 0] = True
    assert_states_match(
        jsteps.erase_observations(jstate, jnp.asarray(erase)),
        tsteps.erase_observations(tstate, torch.from_numpy(erase)))


def _local_map_past_f(F=32, n_kf=3, seed=3):
    """A map whose local map lists more candidates than the frame has
    feature slots: keyframe 0 and its two covisible neighbours observe
    points 0..n_kf*F-1 (one per slot), so the candidate list is those ids
    in order and query q is point q. The frame (identity pose, stereo,
    level 0) has features on points 0-7 (queries < F), on points 40-47,
    which lie at point F - 1's position, and on points 80-95 (queries >=
    F) at their own pixels; every feature carries its point's
    descriptor."""
    rng = np.random.default_rng(seed)
    caps = dataclasses.replace(CFG.caps, max_keyframes=4, max_points=128,
                               max_features=F, local_points=4 * F)
    jcfg = dataclasses.replace(CFG, caps=caps)
    tcfg = dataclasses.replace(TCFG, caps=dataclasses.replace(TCFG.caps,
                                                              **vars(caps)))
    cam = TCFG.camera
    n = n_kf * F
    gu, gv = np.meshgrid(np.arange(12), np.arange(8))
    uv = np.stack([24.0 + 25.0 * gu.ravel(), 22.0 + 27.0 * gv.ravel()],
                  -1)[:n]
    z = rng.uniform(4.0, 8.0, n)
    uv[40:48], z[40:48] = uv[F - 1], z[F - 1]
    pos = np.stack([(uv[:, 0] - cam.cx) * z / cam.fx,
                    (uv[:, 1] - cam.cy) * z / cam.fy, z], -1)
    desc = rng.integers(-2**31, 2**31, (n, 8), dtype=np.int64)
    st = tms.empty_map_state(tcfg, device="cpu")
    P = caps.max_points
    dist = np.linalg.norm(pos, axis=-1)
    pad = np.zeros((P - n,))
    kf_mp = st.kf_mp.clone()
    kf_mp[:n_kf] = torch.arange(n, dtype=torch.int32).reshape(n_kf, F)
    covis = st.covis.clone()
    covis[0, 1:n_kf] = covis[1:n_kf, 0] = 10
    st = st._replace(
        kf_valid=torch.arange(4) < n_kf, kf_mp=kf_mp, covis=covis,
        mp_pos=torch.from_numpy(np.concatenate([pos, np.zeros((P - n, 3))])
                                .astype(np.float32)),
        mp_valid=torch.arange(P) < n,
        mp_desc=torch.from_numpy(np.concatenate(
            [desc, np.zeros((P - n, 8), np.int64)]).astype(np.int32)),
        mp_normal=torch.from_numpy(np.concatenate(
            [pos / dist[:, None], np.zeros((P - n, 3))]).astype(np.float32)),
        mp_min_dist=torch.from_numpy(np.concatenate([0.5 * dist, pad])
                                     .astype(np.float32)),
        mp_max_dist=torch.from_numpy(np.concatenate([dist, pad + 1e9])
                                     .astype(np.float32)))
    pts = np.r_[0:8, 40:48, 80:96]
    assert len(pts) == F
    feats = tframe.FrameFeatures(
        xy=torch.from_numpy(uv[pts].astype(np.float32)),
        response=torch.ones(F), level=torch.zeros(F, dtype=torch.int32),
        angle=torch.zeros(F),
        desc=torch.from_numpy(desc[pts].astype(np.int32)),
        valid=torch.ones(F, dtype=torch.bool),
        u_right=torch.from_numpy((uv[pts, 0] - cam.bf / z[pts])
                                 .astype(np.float32)),
        depth=torch.from_numpy(z[pts].astype(np.float32)))
    return jcfg, tcfg, st, feats, pts


def test_local_map_association_past_f():
    """Fault 4 (ROADMAP.md queue 3), the port's departure from the JAX
    package: a feature won by local-map query q takes point ids[q] for every
    q in [0, LP), as the reference's SearchByProjection assigns every local
    point; the JAX package gives a win by q >= F point ids[F - 1]. Both
    packages agree where q < F (points 0-7). Points 40-47 lie where point
    F - 1 does, so the JAX package's wrong association is an inlier there
    and shows: ids[F - 1] for each; points 80-95 lie elsewhere, and there
    the JAX package's ids[F - 1] is an outlier the pose optimizer drops."""
    jcfg, tcfg, st, feats, pts = _local_map_past_f()
    F = tcfg.caps.max_features
    q0, t0 = torch.tensor([1.0, 0.0, 0.0, 0.0]), torch.zeros(3)
    none = torch.full((F,), -1, dtype=torch.int32)
    ttr, _ = tsteps.track_local_map_step(st, feats, q0, t0, none, 0, tcfg)
    jtr, _ = jsteps.track_local_map_step(
        jax_state_from_torch(st), jax_feats_from_torch(feats), t2j(q0),
        t2j(t0), t2j(none), 0, jcfg)
    tmp, jmp = ttr.frame_mp.numpy(), np.asarray(jtr.frame_mp)
    np.testing.assert_array_equal(tmp, pts)          # every q: ids[q]
    below = pts < F
    np.testing.assert_array_equal(jmp[below], tmp[below])
    np.testing.assert_array_equal(jmp[(pts >= 40) & (pts < 48)], F - 1)
    np.testing.assert_array_equal(jmp[pts >= 80], -1)
    assert int(ttr.n_inliers) == F
    np.testing.assert_allclose(ttr.q.numpy(), np.asarray(jtr.q), atol=1e-5)
    np.testing.assert_allclose(ttr.t.numpy(), np.asarray(jtr.t), atol=1e-4)
