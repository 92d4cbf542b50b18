"""Relocalization and map checkpoints of the port against the JAX package.

- Kidnap (test_system.py's test_relocalization_after_kidnap) through both
  packages' System, on features the JAX package extracts once: ten corridor
  frames tracked (camera centres within 2 mm frame by frame), two black
  frames (both LOST), then frame 3's view again. The port's RANSAC samples
  are the JAX package's own (jax.random.choice keyed by PRNGKey(candidate)),
  so both score the same hypotheses: both recover, with the same accepted
  candidate keyframe, inlier counts within 2 and the pose within 1e-3 (EPnP
  hypotheses are float32-chaotic, tests/test_torch_epnp.py; the K1 polish
  brings both onto the same optimum). Then each package's camera centre is
  within test_system's 0.1 m of the truth.
- Match growth (test_system.py's test_relocalization_match_growth): brute
  matching alone is short of 50 inliers, so success needs the growth
  rounds; both recover, inliers within 2, pose within 1e-3, within 0.05 m of
  the truth.
- Checkpoints: the port's own round trip (test_checkpoint_roundtrip), and a
  map saved by either package loaded by the other, every MapState field
  equal (descriptors as uint32 words in the file), n_kf, n_mp and n_created
  equal, the database rebuilt from the restored keyframes.
- Reset (test_system.py's test_auto_reset_when_lost_early) on the port:
  losing track with a map of at most 5 keyframes resets to NOT_INITIALIZED,
  as the reference does (the JAX package leaves the state LOST there, and
  its own test of this fails; ROADMAP.md queue 3).
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

torch.set_num_threads(1)   # several test workers share few cores

from multiagent_orb_slam2_tpu.geometry import se3 as jse3
from multiagent_orb_slam2_tpu.io.synthetic import BoxScene, corridor_trajectory
from multiagent_orb_slam2_tpu.ops import frame as jframe
from multiagent_orb_slam2_tpu.runtime import steps as jsteps
from multiagent_orb_slam2_tpu.runtime.system import System as JSystem
from multiagent_orb_slam2_tpu.vocab import bow as jbow
from multiagent_orb_slam2_tpu_torch import convert
from multiagent_orb_slam2_tpu_torch.geometry import epnp as tepnp
from multiagent_orb_slam2_tpu_torch.optim import pose_opt as tpo
from multiagent_orb_slam2_tpu_torch.runtime import steps as tsteps
from multiagent_orb_slam2_tpu_torch.runtime.system import System as TSystem
from multiagent_orb_slam2_tpu_torch.runtime.tracker import (TrackerState,
                                                            _np_inverse)
from multiagent_orb_slam2_tpu_torch.vocab import bow as tbow

import test_system as jts
from torch_parity import jax_fields, torch_feats_from_jax

CFG = jts.CFG
CAM = jts.CAM
TCFG = convert.config_from_dict({**dataclasses.asdict(CFG), "camera": CAM})
N = jts.N


def jax_draw_samples(mask, n_iters, sample, seed):
    """The port's draw_samples replaced by the JAX package's sampling."""
    m = jnp.asarray(mask.cpu().numpy())
    keys = jax.random.split(jax.random.PRNGKey(seed), n_iters)
    probs = m.astype(jnp.float32) / jnp.maximum(jnp.sum(m), 1)
    s = jax.vmap(lambda k: jax.random.choice(
        k, m.shape[0], shape=(sample,), replace=False, p=probs))(keys)
    return torch.from_numpy(np.array(s)).to(torch.int64)


def _centre(q, t):
    return _np_inverse(np.asarray(q, np.float64),
                       np.asarray(t, np.float64))[1]


def _n_tracked(tracker):
    """Frame features associated with a map point (the inliers kept)."""
    return int((np.asarray(tracker.last_frame_mp) >= 0).sum())


@pytest.fixture(scope="module")
def kidnapped():
    """Both Systems after ten frames, two black frames and the revisit."""
    scene = BoxScene(seed=17, z_far=40.0)
    q_wc, t_wc = corridor_trajectory(N, step=0.15, seed=4)
    frames = [scene.render_stereo(CAM, q_wc[i], t_wc[i])[:2] for i in range(N)]
    feats = [jframe.extract_frame(jnp.asarray(left), CFG,
                                  right_img=jnp.asarray(right))
             for left, right in frames]
    descs = [np.asarray(feats[i].desc)[np.asarray(feats[i].valid)]
             for i in (0, N - 1)]
    corpus = np.concatenate(descs)
    jv = jbow.train_vocabulary(corpus, k=8, depth=3, seed=6)
    tv = tbow.train_vocabulary(corpus, k=8, depth=3, seed=6, device="cpu")
    js = JSystem(CFG, jv, enable_loop_closing=False)
    ts = TSystem(TCFG, tv, enable_loop_closing=False, device="cpu")
    for i, f in enumerate(feats):
        js._track(f, i)
        ts._track(torch_feats_from_jax(f), i)
        rj, rt = js.tracker.trajectory[-1], ts.tracker.trajectory[-1]
        assert rj.lost == rt.lost is False, i
        assert np.linalg.norm(_centre(rj.q, rj.t)
                              - _centre(rt.q, rt.t)) <= 2e-3, i
    black = np.zeros((CAM.height, CAM.width), np.float32)
    fb = jframe.extract_frame(jnp.asarray(black), CFG,
                              right_img=jnp.asarray(black))
    for j in range(2):
        js._track(fb, N + j)
        ts._track(torch_feats_from_jax(fb), N + j)
        assert js.tracker.state == ts.tracker.state == TrackerState.LOST
    mp = pytest.MonkeyPatch()
    mp.setattr(tepnp, "draw_samples", jax_draw_samples)
    try:
        js._track(feats[3], N + 2)
        ts._track(torch_feats_from_jax(feats[3]), N + 2)
    finally:
        mp.undo()
    return js, ts, (q_wc, t_wc)


@pytest.mark.e2e
def test_relocalization_after_kidnap_matches_jax(kidnapped):
    js, ts, (q_wc, t_wc) = kidnapped
    jt, tt = js.tracker, ts.tracker
    assert jt.state == tt.state == TrackerState.OK
    assert js.n_relocalizations == ts.n_relocalizations >= 1
    assert jt.ref_kf == tt.ref_kf                 # the accepted candidate
    assert abs(_n_tracked(jt) - _n_tracked(tt)) <= 2
    np.testing.assert_allclose(tt.last_q.numpy(), np.asarray(jt.last_q),
                               atol=1e-3)
    np.testing.assert_allclose(tt.last_t.numpy(), np.asarray(jt.last_t),
                               atol=1e-3)
    # the record of the relocalized frame is rewritten, as in the JAX package
    rj, rt = jt.trajectory[-1], tt.trajectory[-1]
    assert rj.lost == rt.lost is False
    assert (rj.ref_kf, rj.ref_uid) == (rt.ref_kf, rt.ref_uid)
    np.testing.assert_allclose(rt.ref_t, np.asarray(rj.ref_t), atol=1e-3)
    for q, t in ((jt.last_q, jt.last_t), (tt.last_q, tt.last_t)):
        assert np.linalg.norm(_centre(q, t) - t_wc[3]) < 0.1


def _growth_systems():
    """Both packages' System with test_system.py's under-matched keyframe
    and query frame (returns the systems, the query features and the true
    pose)."""
    rng = np.random.default_rng(7)
    n = 150
    z = rng.uniform(4, 12, n)
    pw = np.stack([rng.uniform(-0.4, 0.4, n) * z,
                   rng.uniform(-0.3, 0.3, n) * z, z], -1).astype(np.float32)
    descs = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
    jv = jbow.train_vocabulary(descs, k=8, depth=2)
    tv = tbow.train_vocabulary(descs, k=8, depth=2, device="cpu")
    F = CFG.caps.max_features
    u = CAM.fx * pw[:, 0] / z + CAM.cx
    v = CAM.fy * pw[:, 1] / z + CAM.cy
    kf_feats = jframe.FrameFeatures(
        xy=jnp.zeros((F, 2)).at[:n].set(jnp.asarray(np.stack([u, v], -1))),
        response=jnp.zeros(F), level=jnp.zeros(F, jnp.int32),
        angle=jnp.zeros(F),
        desc=jnp.zeros((F, 8), jnp.uint32).at[:n].set(jnp.asarray(descs)),
        valid=jnp.zeros(F, bool).at[:n].set(True),
        u_right=jnp.full(F, -1.0).at[:n].set(jnp.asarray(u - CAM.bf / z)),
        depth=jnp.full(F, -1.0).at[:n].set(jnp.asarray(z)))
    q_cw, t_cw = jse3.inverse(*jse3.se3_exp(jnp.asarray(
        [0.25, -0.1, 0.1, 0.0, 0.03, 0.0])))
    pc = np.asarray(jse3.apply(q_cw, t_cw, jnp.asarray(pw)))
    zq = pc[:, 2]
    uq = CAM.fx * pc[:, 0] / zq + CAM.cx + rng.normal(0, 0.3, n)
    vq = CAM.fy * pc[:, 1] / zq + CAM.cy + rng.normal(0, 0.3, n)
    bits = np.unpackbits(descs.copy().view(np.uint8), axis=1)
    for i in range(40, n):
        bits[i, rng.choice(256, size=70, replace=False)] ^= 1
    descs_q = np.packbits(bits, axis=1).view(np.uint32)
    vis = (uq >= 0) & (uq < CAM.width) & (vq >= 0) & (vq < CAM.height) \
        & (zq > 0.1)
    q_feats = jframe.FrameFeatures(
        xy=jnp.zeros((F, 2)).at[:n].set(jnp.asarray(np.stack([uq, vq], -1))),
        response=jnp.zeros(F), level=jnp.zeros(F, jnp.int32),
        angle=jnp.zeros(F),
        desc=jnp.zeros((F, 8), jnp.uint32).at[:n].set(jnp.asarray(descs_q)),
        valid=jnp.zeros(F, bool).at[:n].set(jnp.asarray(vis)),
        u_right=jnp.full(F, -1.0), depth=jnp.full(F, -1.0))

    js = JSystem(CFG, jv, enable_loop_closing=False)
    ts = TSystem(TCFG, tv, enable_loop_closing=False, device="cpu")
    for system, init, f in ((js, jsteps.stereo_init_step, kf_feats),
                            (ts, tsteps.stereo_init_step,
                             torch_feats_from_jax(kf_feats))):
        sh = system.shared
        slot = sh.alloc_kf()
        sh.state, _, n_new = init(sh.state, f, 0, 0, 0, slot, sh.mp_base(),
                                  system.cfg)
        sh.commit_mp(int(n_new))
        system.tracker.new_kf_slots.append(slot)
        system.tracker.ref_kf = slot
        system._process_keyframes()      # registers keyframe 0 in the DB
        system.tracker.state = TrackerState.LOST
    return js, ts, q_feats, jse3.inverse(q_cw, t_cw)[1]


@pytest.mark.e2e
def test_relocalization_match_growth_matches_jax(monkeypatch):
    js, ts, q_feats, t_wc = _growth_systems()
    monkeypatch.setattr(tepnp, "draw_samples", jax_draw_samples)
    calls = []
    real = tpo.pose_optimize

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(tpo, "pose_optimize", counting)
    assert js._relocalize(q_feats)
    assert ts._relocalize(torch_feats_from_jax(q_feats))
    assert len(calls) >= 2               # the polish and a growth round
    assert js.n_relocalizations == ts.n_relocalizations == 1
    jt, tt = js.tracker, ts.tracker
    assert abs(_n_tracked(jt) - _n_tracked(tt)) <= 2
    assert _n_tracked(tt) >= CFG.tracking.reloc_min_inliers
    np.testing.assert_allclose(tt.last_q.numpy(), np.asarray(jt.last_q),
                               atol=1e-3)
    np.testing.assert_allclose(tt.last_t.numpy(), np.asarray(jt.last_t),
                               atol=1e-3)
    assert np.linalg.norm(_centre(tt.last_q, tt.last_t)
                          - np.asarray(t_wc)) < 0.05


def _assert_maps_equal(jstate_fields: dict, tstate):
    got = convert.map_state_to_numpy(tstate)
    assert sorted(got) == sorted(jstate_fields)
    for name, want in jstate_fields.items():
        assert got[name].dtype == want.dtype, name
        np.testing.assert_array_equal(got[name], want, err_msg=name)


@pytest.mark.e2e
def test_checkpoint_roundtrip(kidnapped, tmp_path):
    _, ts, _ = kidnapped
    p = str(tmp_path / "map.npz")
    ts.save_map(p)
    s2 = TSystem(TCFG, ts.vocab, enable_loop_closing=False, device="cpu")
    s2.load_map(p)
    sh, sh2 = ts.shared, s2.shared
    assert (sh2.n_kf, sh2.n_mp, sh2.n_created) == (sh.n_kf, sh.n_mp,
                                                   sh.n_created)
    for name, a in sh.state._asdict().items():
        assert torch.equal(getattr(sh2.state, name), a), name
    assert sh2.uid_slot == sh.uid_slot
    assert torch.equal(s2.loop_closer.db.active, sh.state.kf_valid)
    assert torch.equal(s2.loop_closer.db.words[sh.state.kf_valid],
                       ts.loop_closer.db.words[sh.state.kf_valid])


@pytest.mark.e2e
@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_checkpoint_across_packages(kidnapped, tmp_path, direction):
    js, ts, _ = kidnapped
    p = str(tmp_path / "map.npz")
    if direction == "jax_to_torch":
        js.save_map(p)
        s2 = TSystem(TCFG, ts.vocab, enable_loop_closing=False, device="cpu")
        s2.load_map(p)
        _assert_maps_equal(jax_fields(js.shared.state), s2.shared.state)
        src, dst = js.shared, s2.shared
    else:
        ts.save_map(p)
        s2 = JSystem(CFG, js.vocab, enable_loop_closing=False)
        s2.load_map(p)
        _assert_maps_equal(jax_fields(s2.shared.state), ts.shared.state)
        assert s2.shared.state.kf_desc.dtype == jnp.uint32
        src, dst = ts.shared, s2.shared
    assert (dst.n_kf, dst.n_mp, dst.n_created) == (src.n_kf, src.n_mp,
                                                   src.n_created)
    assert dst.uid_slot == src.uid_slot and dst.free_kf == src.free_kf
    with np.load(p, allow_pickle=True) as z:
        assert z["ms_kf_desc"].dtype == np.uint32
        assert z["ms_kf_seq"].dtype == np.int32
        assert z["ms_kf_q"].dtype == np.float32


@pytest.mark.e2e
def test_auto_reset_when_lost_early():
    """Losing track with <= 5 keyframes resets the map and the tracker to
    NOT_INITIALIZED (reference src/Tracking.cc:483-491 and 1522-1572)."""
    scene = BoxScene(seed=3, z_far=40.0)
    q_wc, t_wc = corridor_trajectory(3, step=0.15, seed=1)
    vocab = tbow.train_vocabulary(
        np.random.default_rng(0).integers(0, 2**32, (300, 8),
                                          dtype=np.uint32), k=8, depth=2,
        device="cpu")
    sys_ = TSystem(TCFG, vocab, enable_loop_closing=False, device="cpu")
    for i in range(3):
        L, R, _ = scene.render_stereo(CAM, q_wc[i], t_wc[i])
        sys_.track_stereo(L, R, frame_id=i)
    assert sys_.tracker.state == TrackerState.OK
    assert sys_.shared.n_created <= 5
    black = np.zeros((240, 320), np.float32)
    sys_.track_stereo(black, black, frame_id=3)      # -> LOST
    assert sys_.tracker.state == TrackerState.LOST
    sys_.track_stereo(black, black, frame_id=4)      # LOST + tiny map -> reset
    assert sys_.tracker.state == TrackerState.NOT_INITIALIZED
    assert int(sys_.shared.state.kf_valid.sum()) == 0
    assert sys_.n_relocalizations == 0
    # and tracking restarts cleanly on real imagery
    L, R, _ = scene.render_stereo(CAM, q_wc[0], t_wc[0])
    sys_.track_stereo(L, R, frame_id=5)
    assert sys_.tracker.state == TrackerState.OK
