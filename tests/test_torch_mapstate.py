"""The port's mapstate/state.py against the JAX one, from the same converted
MapState (the port's tracker after four corridor frames): integer outputs
exact, floats 1e-5."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from multiagent_orb_slam2_tpu.mapstate import state as jms
from multiagent_orb_slam2_tpu_torch import convert
from multiagent_orb_slam2_tpu_torch.mapstate import state as tms
from multiagent_orb_slam2_tpu_torch.utils.torch_ops import set_drop

from torch_parity import (CFG, TCFG, assert_states_match, j2t,
                          jax_feats_from_torch, jax_state_from_torch,
                          port_tracker_after)


@pytest.fixture(scope="module")
def world():
    tr, shared, feats = port_tracker_after(4)
    tstate = shared.state
    return tstate, jax_state_from_torch(tstate), shared, feats


def test_empty_map_state_matches():
    assert_states_match(jms.empty_map_state(CFG),
                        tms.empty_map_state(TCFG, device="cpu"))


def test_roundtrip_through_numpy(world):
    tstate, jstate, _, _ = world
    assert_states_match(jstate, tstate)
    back = convert.map_state_from_numpy(convert.map_state_to_numpy(tstate),
                                        "cpu")
    for a, b in zip(tstate, back):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert convert.map_state_to_numpy(tstate)["kf_desc"].dtype == np.uint32
    assert tstate.caps == jstate.caps
    np.testing.assert_array_equal(tstate.mp_n_obs().numpy(),
                                  np.asarray(jstate.mp_n_obs()))


def test_add_points(world):
    tstate, jstate, shared, feats = world
    rng = np.random.default_rng(3)
    n = 64
    slots = (shared.n_mp + np.arange(n)).astype(np.int32)
    slots[5] = 8192                         # out of range: must be dropped
    valid = rng.random(n) < 0.8
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    desc = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(np.uint32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    mn = rng.uniform(1, 2, n).astype(np.float32)
    mx = rng.uniform(5, 9, n).astype(np.float32)
    ref = np.full(n, 2, np.int32)
    js = jms.add_points(jstate, jnp.asarray(slots), jnp.asarray(pos),
                        jnp.asarray(desc), jnp.asarray(nrm), jnp.asarray(mn),
                        jnp.asarray(mx), jnp.asarray(ref), jnp.asarray(ref * 0),
                        jnp.asarray(ref * 0), jnp.asarray(valid))
    ts = tms.add_points(tstate, j2t(slots), j2t(pos), j2t(desc), j2t(nrm),
                        j2t(mn), j2t(mx), 2, 0, 0, j2t(valid))
    assert_states_match(js, ts)
    assert int(ts.mp_valid.sum()) > int(tstate.mp_valid.sum())
    assert_states_match(jstate, tstate)      # inputs untouched


def test_add_observations_and_update_covisibility(world):
    tstate, jstate, shared, _ = world
    F = CFG.caps.max_features
    rng = np.random.default_rng(4)
    kf = 1
    free = np.nonzero(tstate.kf_mp[kf].numpy() < 0)[0][:50]
    feat_idx = np.zeros(F, np.int32)
    feat_idx[:50] = free
    mp_idx = rng.permutation(shared.n_mp)[:F].astype(np.int32)  # injective
    valid = np.zeros(F, bool)
    valid[:50] = True
    js = jms.add_observations(jstate, kf, jnp.asarray(feat_idx),
                              jnp.asarray(mp_idx), jnp.asarray(valid))
    ts = tms.add_observations(tstate, kf, j2t(feat_idx), j2t(mp_idx),
                              j2t(valid))
    assert_states_match(js, ts)
    assert int((ts.kf_mp[kf] >= 0).sum()) == int((tstate.kf_mp[kf] >= 0).sum()) + 50
    js2 = jms.update_covisibility(js, kf)
    ts2 = tms.update_covisibility(ts, kf)
    assert_states_match(js2, ts2)
    np.testing.assert_array_equal(
        tms.covis_neighbors_mask(ts2, kf, 15).numpy(),
        np.asarray(jms.covis_neighbors_mask(js2, kf, 15)))


def test_add_observations_with_a_repeated_point(world):
    """Two features of one keyframe carrying the same point: the point's
    new observation slot names the later feature in both packages (the
    last of duplicate writes wins, as in XLA's sequential scatter; on CUDA
    an index_put would pick one at random)."""
    tstate, jstate, shared, _ = world
    F = CFG.caps.max_features
    kf = 1
    free = np.nonzero(tstate.kf_mp[kf].numpy() < 0)[0][:6]
    feat_idx = np.zeros(F, np.int32)
    feat_idx[:6] = free
    mp_idx = np.zeros(F, np.int32)
    mp_idx[:6] = [3, 5, 3, 7, 5, 3]
    valid = np.zeros(F, bool)
    valid[:6] = True
    js = jms.add_observations(jstate, kf, jnp.asarray(feat_idx),
                              jnp.asarray(mp_idx), jnp.asarray(valid))
    ts = tms.add_observations(tstate, kf, j2t(feat_idx), j2t(mp_idx),
                              j2t(valid))
    assert_states_match(js, ts)
    obs_kf, obs_ft = ts.mp_obs_kf.numpy(), ts.mp_obs_feat.numpy()
    for p, last in ((3, free[5]), (5, free[4])):
        slot = int(np.nonzero(tstate.mp_obs_kf[p].numpy() < 0)[0][0])
        assert (obs_kf[p, slot], obs_ft[p, slot]) == (kf, last)


def test_set_drop_last_write_wins():
    dst = torch.zeros(6, dtype=torch.int32)
    idx = torch.tensor([1, 3, 1, 6, 3, 2, 1])
    val = torch.tensor([10, 30, 11, 99, 31, 20, 12], dtype=torch.int32)
    np.testing.assert_array_equal(set_drop(dst, idx, val).numpy(),
                                  [0, 12, 20, 31, 0, 0])


@pytest.mark.cuda
def test_set_drop_last_write_wins_on_the_card():
    """Many duplicate writes on the card: the last one wins, every time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(9)
    idx = torch.from_numpy(rng.integers(0, 64, 1 << 16)).cuda()
    val = torch.arange(1 << 16, dtype=torch.int32, device="cuda")
    dst = torch.zeros(64, dtype=torch.int32, device="cuda")
    want = np.zeros(64, np.int32)       # val rises: the last write is the max
    np.maximum.at(want, idx.cpu().numpy(), val.cpu().numpy())
    for _ in range(3):
        np.testing.assert_array_equal(set_drop(dst, idx, val).cpu().numpy(),
                                      want)


def test_insert_keyframe(world):
    tstate, jstate, shared, feats = world
    F = CFG.caps.max_features
    f = feats[4]
    slot = shared.n_kf
    assign = np.full(F, -1, np.int32)
    assign[:120] = np.arange(100, 220)
    q = np.array([0.999, 0.01, -0.02, 0.03], np.float32)
    t = np.array([0.1, -0.2, 0.3], np.float32)
    js = jms.insert_keyframe(jstate, slot, jax_feats_from_torch(f),
                             jnp.asarray(q), jnp.asarray(t), 4, 0, 0,
                             jnp.asarray(assign), parent=1)
    ts = tms.insert_keyframe(tstate, slot, f, j2t(q), j2t(t), 4, 0, 0,
                             j2t(assign), parent=1)
    assert_states_match(js, ts)
    assert bool(ts.kf_valid[slot]) and int(ts.covis[slot].sum()) > 0


def test_update_point_descriptors_and_normals(world):
    tstate, jstate, shared, _ = world
    mask = np.zeros(CFG.caps.max_points, bool)
    mask[:shared.n_mp:2] = True
    js = jms.update_point_descriptors(jstate, jnp.asarray(mask))
    ts = tms.update_point_descriptors(tstate, j2t(mask))
    assert_states_match(js, ts)
    js = jms.update_point_normals(js, jnp.asarray(mask),
                                  CFG.orb.scale_factor, CFG.orb.n_levels)
    ts = tms.update_point_normals(ts, j2t(mask), TCFG.orb.scale_factor,
                                  TCFG.orb.n_levels)
    assert_states_match(js, ts, atol=1e-5)


def test_predict_scale():
    rng = np.random.default_rng(5)
    dist = rng.uniform(0.5, 30, 500).astype(np.float32)
    mx = rng.uniform(1, 40, 500).astype(np.float32)
    a = np.asarray(jms.predict_scale(jnp.asarray(dist), jnp.asarray(mx), 1.2, 8))
    b = tms.predict_scale(j2t(dist), j2t(mx), 1.2, 8).numpy()
    np.testing.assert_array_equal(b, a)
