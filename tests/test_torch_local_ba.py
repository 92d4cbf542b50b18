"""Local bundle adjustment and keyframe culling of the port against the JAX
package: one call each of local_ba_step, _kf_culling_core, kf_redundancy,
erase_keyframe_step, keyframe_culling, fuse_into_neighborhood,
local_mapping_pass and keyframe_pipeline_step(run_local_ba=True), from the
same converted 6-keyframe map (CPU, small configuration).

Tolerances: optimized poses 1e-4 (found 1e-6), optimized points within 1e-4 m
+ 1e-5 relative on >= 99.9 % (found: all within 2e-4 m), integer map arrays
equal on >= 99.9 % of their entries, culled slots and covisibility equal.
The default 90 % redundancy rule culls nothing on this short corridor, so the
culling calls use a 70 % rule in both packages.
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

pytestmark = pytest.mark.e2e

from multiagent_orb_slam2_tpu.config import MappingConfig
from multiagent_orb_slam2_tpu.runtime import mapping as jmapping
from multiagent_orb_slam2_tpu.runtime import steps as jsteps
from multiagent_orb_slam2_tpu_torch import convert
from multiagent_orb_slam2_tpu_torch.runtime import mapping as tmapping
from multiagent_orb_slam2_tpu_torch.runtime import steps as tsteps

from torch_parity import (CAM, CFG, TCFG, assert_states_match,
                          jax_feats_from_torch, jax_state_from_torch,
                          port_tracker_after, t2j, torch_state_from_jax)

CFG70 = CFG.replace(mapping=MappingConfig(kf_cull_redundancy=0.7))
TCFG70 = convert.config_from_dict({**dataclasses.asdict(CFG70), "camera": CAM})


@pytest.fixture(scope="module")
def world():
    tr, shared, feats = port_tracker_after(8)
    assert shared.n_kf >= 5
    return tr, shared, feats, jax_state_from_torch(shared.state)


@pytest.fixture(scope="module")
def after_ba(world):
    """Both packages' states after local BA around the newest keyframe and
    the covisibility refresh that follows it in the pipeline."""
    _, shared, _, jstate = world
    c = shared.n_kf - 1
    js = jsteps.local_ba_step(jstate, c, CFG)
    ts = tsteps.local_ba_step(shared.state, c, TCFG)
    return js, ts, c


def test_local_ba_step(world, after_ba):
    _, shared, _, jstate = world
    js, ts, c = after_ba
    np.testing.assert_allclose(ts.kf_q.numpy(), np.asarray(js.kf_q), atol=1e-4)
    np.testing.assert_allclose(ts.kf_t.numpy(), np.asarray(js.kf_t), atol=1e-4)
    assert_states_match(js, ts, int_share=0.999, atol=1e-4, float_share=0.999)
    # it did something: poses moved, the origin did not, outliers went
    before = shared.state
    assert float((ts.kf_t - before.kf_t).abs().max()) > 1e-3
    assert torch.equal(ts.kf_t[0], before.kf_t[0])
    n_before = int((before.mp_obs_kf >= 0).sum())
    assert 0 < n_before - int((ts.mp_obs_kf >= 0).sum()) < 0.05 * n_before
    assert int((ts.mp_obs_kf >= 0).sum()) == int((js.mp_obs_kf >= 0).sum())


def test_kf_culling_core(after_ba):
    js, ts, c = after_ba
    js = jsteps.recompute_covisibility(js)
    ts = tsteps.recompute_covisibility(ts)
    js2, cull_j = jsteps._kf_culling_core(js, c, CFG70)
    ts2, cull_t = tsteps._kf_culling_core(ts, c, TCFG70)
    cull_j, cull_t = np.asarray(cull_j), cull_t.numpy()
    assert cull_t.shape == (3, 9) and cull_t.dtype == np.float32
    np.testing.assert_array_equal(cull_t[:, :2], cull_j[:, :2])
    np.testing.assert_allclose(cull_t[:, 2:], cull_j[:, 2:], atol=1e-5)
    culled = [int(s) for s in cull_t[:, 0] if s >= 0]
    assert 1 <= len(culled) <= 3 and 0 not in culled and c not in culled
    assert not ts2.kf_valid[culled].any()
    assert_states_match(js2, ts2, int_share=0.999, atol=1e-4,
                        float_share=0.999)
    # the default rule culls nothing here, and reports so
    _, none_t = tsteps._kf_culling_core(ts, c, TCFG)
    np.testing.assert_array_equal(
        none_t.numpy()[:, :2], np.asarray(
            jsteps._kf_culling_core(js, c, CFG)[1])[:, :2])
    assert (none_t[:, 0] == -1).all()


def test_kf_redundancy(world):
    _, shared, _, jstate = world
    ts = shared.state
    slots = torch.arange(shared.n_kf)
    ratio_b, n_b = tmapping.kf_redundancy(ts, slots, TCFG)
    for k in range(shared.n_kf):
        rj, nj = jmapping.kf_redundancy(jstate, k, CFG)
        rt, nt = tmapping.kf_redundancy(ts, k, TCFG)
        assert int(nt) == int(nj) == int(n_b[k]) > 20
        assert abs(float(rt) - float(rj)) <= 1e-6
        assert float(ratio_b[k]) == float(rt)
    assert float(ratio_b.max()) > 0.7


def test_erase_keyframe_step(world):
    _, shared, _, jstate = world
    ts = shared.state
    K = TCFG.caps.max_keyframes
    je = jmapping.erase_keyframe_step(jstate, 2)
    te = tmapping.erase_keyframe_step(ts, 2)
    assert_states_match(je, te)
    assert not te.kf_valid[2] and int(te.covis[2].sum()) == 0
    assert not (te.kf_parent == 2).any()
    # a slot on the device, and the out-of-bounds slot that erases nothing
    assert_states_match(je, tmapping.erase_keyframe_step(ts, torch.tensor(2)))
    assert_states_match(jstate, tmapping.erase_keyframe_step(ts, K))
    assert_states_match(jmapping.erase_keyframe_step(jstate, K),
                        tmapping.erase_keyframe_step(ts, torch.tensor(K)))


def test_keyframe_culling(after_ba):
    js, ts, c = after_ba
    js = jsteps.recompute_covisibility(js)
    ts = tsteps.recompute_covisibility(ts)
    js2, culled_j, info_j = jmapping.keyframe_culling(js, c, CFG70)
    ts2, culled_t, info_t = tmapping.keyframe_culling(ts, c, TCFG70)
    assert culled_t == culled_j and 1 <= len(culled_t) <= 3
    assert sorted(info_t) == sorted(info_j)
    for k in info_t:
        assert info_t[k][0] == info_j[k][0]
        np.testing.assert_allclose(info_t[k][1], info_j[k][1], atol=1e-5)
        np.testing.assert_allclose(info_t[k][2], info_j[k][2], atol=1e-5)
    assert_states_match(js2, ts2, int_share=0.999, atol=1e-4,
                        float_share=0.999)
    _, culled_none, _ = tmapping.keyframe_culling(ts, c, TCFG)
    assert culled_none == jmapping.keyframe_culling(js, c, CFG)[1] == []


def test_fuse_into_neighborhood(world):
    _, shared, _, jstate = world
    ts = shared.state
    P = TCFG.caps.max_points
    c = shared.n_kf - 1
    own = ts.kf_mp[c]
    ids = torch.where(own >= 0, own.long(), torch.full_like(own, P).long())
    jf = jmapping.fuse_into_neighborhood(jstate, t2j(ids).astype(jnp.int32),
                                         c - 2, CFG, n_max=4)
    tf = tmapping.fuse_into_neighborhood(ts, ids, c - 2, TCFG, n_max=4)
    assert_states_match(jf, tf)
    assert not torch.equal(tf.kf_mp, ts.kf_mp)


def test_local_mapping_pass(world):
    _, shared, _, jstate = world
    c = shared.n_kf - 1
    jm = jmapping.local_mapping_pass(jstate, c, CFG)
    tm = tmapping.local_mapping_pass(shared.state, c, TCFG,
                                     shared.state.kf_seq)
    assert_states_match(jm, tm, int_share=0.999, atol=1e-5, float_share=0.999)
    np.testing.assert_array_equal(tm.covis.numpy(), np.asarray(jm.covis))


def test_keyframe_pipeline_step_with_local_ba(world):
    """The keyframe pipeline as a whole with local BA and culling on."""
    tr, shared, feats, jstate = world
    cur = feats[8]
    slot, base = shared.n_kf, shared.n_mp
    kf_seq = shared.state.kf_seq.clone()
    kf_seq[slot] = shared.n_created
    tstate = shared.state._replace(kf_seq=kf_seq)
    jstate = jstate._replace(kf_seq=t2j(kf_seq))
    tr_out, _, _, _ = tsteps.track_frame_step(
        shared.state, cur, feats[7], tr.last_frame_mp, tr.ref_kf, tr.last_q,
        tr.last_t, tr.vel_q, tr.vel_t, tr.has_velocity, True, TCFG)
    out_t = tsteps.keyframe_pipeline_step(
        tstate, cur, tr_out.q, tr_out.t, tr_out.frame_mp, 8, 0, 0, slot, base,
        TCFG70, True, kf_seq)
    out_j = jsteps.keyframe_pipeline_step(
        jstate, jax_feats_from_torch(cur), t2j(tr_out.q), t2j(tr_out.t),
        t2j(tr_out.frame_mp), 8, 0, 0, slot, base, CFG70, True)
    st_j, mp_j, q_j, t_j, n_j, cull_j = out_j
    st_t, mp_t, q_t, t_t, n_t, cull_t = out_t
    assert abs(int(n_j) - int(n_t)) <= 2 and int(n_t) > 50
    np.testing.assert_allclose(q_t.numpy(), np.asarray(q_j), atol=1e-4)
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), atol=1e-4)
    # BA moved the keyframe off its tracked pose
    assert float((t_t - tr_out.t).abs().max()) > 1e-4
    assert np.mean(mp_t.numpy() == np.asarray(mp_j)) >= 0.995
    np.testing.assert_array_equal(cull_t.numpy()[:, :2],
                                  np.asarray(cull_j)[:, :2])
    np.testing.assert_allclose(cull_t.numpy(), np.asarray(cull_j), atol=1e-4)
    np.testing.assert_array_equal(st_t.covis.numpy(), np.asarray(st_j.covis))
    assert_states_match(st_j, st_t, int_share=0.995, atol=1e-4,
                        float_share=0.995)
    # the converted result round-trips
    assert_states_match(st_j, torch_state_from_jax(st_j))
