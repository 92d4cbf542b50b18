"""Monocular tracking in the port against the JAX package.

- steps.nanmedian_linear against jnp.nanmedian: an even count averages
  the two middle values (torch.nanmedian would return the lower one), an
  odd count takes the middle one, no value gives NaN. Equal to the bit.
- steps.mono_init_map_step against the JAX step on the same two frames
  (JAX features of the test_mono scene), triangulated points, a two-view
  motion and a tri_ok mask with an even (120) and an odd (121) count: the
  scale equal to the bit, the same number of points, and every MapState
  field within the standing tolerance (floats 1e-5, integer arrays equal).
- A whole Tracker.track_mono run on tests/test_mono.py's scene (320x240,
  400 features, 16 frames), local BA on, with the JAX package's RANSAC
  samples injected (jax.random.choice with p under PRNGKey(frame id), as
  the JAX tracker draws them): the same initialization frame, the same
  frames lost (none after it), the same keyframes; rotations within 1e-5
  [3.4e-6]; camera centres, after the one scale that best aligns them,
  within 0.1 % of the trajectory's extent. That scale is held within 2 %
  [0.63 %]: the initial 20-iteration global BA leaves a monocular map's
  scale free, and float32 CG moves it (global BA is held by outcome). The
  scale-free ATE under the JAX test's 0.08 and within 10 % or 2 mm of the
  JAX run's.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multiagent_orb_slam2_tpu.mapstate import state as jms
from multiagent_orb_slam2_tpu.ops import frame as jframe
from multiagent_orb_slam2_tpu.runtime import steps as jsteps
from multiagent_orb_slam2_tpu.runtime import tracker as jtr
from multiagent_orb_slam2_tpu_torch import convert
from multiagent_orb_slam2_tpu_torch.io import trajectory as ttraj
from multiagent_orb_slam2_tpu_torch.runtime import steps as tsteps
from multiagent_orb_slam2_tpu_torch.runtime import tracker as ttr
from multiagent_orb_slam2_tpu_torch.runtime.tracker import _np_inverse

import test_mono as jmono
from torch_parity import (assert_states_match, threads, torch_feats_from_jax,
                          torch_state_from_jax)

TCFG = convert.config_from_dict({**dataclasses.asdict(jmono.CFG),
                                 "camera": jmono.CAM})


def jax_draw(mask, n_iters, seed):
    """The JAX tracker's RANSAC samples for this mask under PRNGKey(seed)
    (its initialize_two_view splits the key and draws with p = mask /
    sum(mask), without replacement)."""
    m = mask.cpu().numpy()
    N = m.shape[0]
    keys = jax.random.split(jax.random.PRNGKey(seed), n_iters)
    probs = jnp.asarray(m, jnp.float32) / max(int(m.sum()), 1)
    return torch.from_numpy(np.array(jax.vmap(lambda k: jax.random.choice(
        k, N, shape=(8,), replace=False, p=probs))(keys)))


@pytest.fixture(scope="module")
def images():
    scene = jmono.BoxScene(seed=13, z_far=30.0)
    q_wc, t_wc = jmono.make_traj()
    return [scene.render(jmono.CAM, q_wc[i], t_wc[i])[0]
            for i in range(jmono.N_FRAMES)], t_wc


@pytest.mark.parametrize("values", [
    [3.0, 1.0, 2.0, 4.0, np.nan, 7.5],      # even count: (2 + 3) / 2
    [3.0, 1.0, np.nan, 2.0, 9.0, 7.5],      # odd count: 3
    [np.nan, np.nan],                        # none: NaN
    [0.25]])
def test_nanmedian_linear_matches_jnp(values):
    z = np.asarray(values, np.float32)
    want = np.asarray(jnp.nanmedian(jnp.asarray(z)))
    got = tsteps.nanmedian_linear(torch.from_numpy(z)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_ok", [120, 121])
def test_mono_init_map_step_matches_jax(images, n_ok):
    imgs, _ = images
    cfg = jmono.CFG
    f0 = jframe.extract_frame(jnp.asarray(imgs[0]), cfg)
    f1 = jframe.extract_frame(jnp.asarray(imgs[3]), cfg)
    F = cfg.caps.max_features
    rng = np.random.default_rng(n_ok)
    points = np.concatenate([rng.uniform(-3, 3, (F, 2)),
                             rng.uniform(2, 10, (F, 1))], 1).astype(np.float32)
    tri_ok = np.zeros(F, bool)
    tri_ok[rng.choice(int(np.asarray(f0.valid).sum()), n_ok,
                      replace=False)] = True
    cur_idx = rng.permutation(F).astype(np.int32)
    q2 = np.array([0.999, 0.02, -0.03, 0.01], np.float32)
    q2 /= np.linalg.norm(q2)
    t2 = np.array([-0.9, 0.05, -0.4], np.float32)
    jstate = jms.empty_map_state(cfg)
    args = (q2, t2, points, tri_ok, np.arange(F, dtype=np.int32), cur_idx)
    js, jfm, jscale, jn = jsteps.mono_init_map_step(
        jstate, f0, f1, *(jnp.asarray(a) for a in args), 4, 7, 0, 0, 1, 2,
        5, cfg)
    ts, tfm, tscale, tn = tsteps.mono_init_map_step(
        torch_state_from_jax(jstate), torch_feats_from_jax(f0),
        torch_feats_from_jax(f1), *(torch.from_numpy(a) for a in args),
        4, 7, 0, 0, 1, 2, 5, TCFG)
    assert int(tn) == int(jn) == n_ok
    np.testing.assert_array_equal(tscale.numpy(), np.asarray(jscale))
    np.testing.assert_array_equal(tfm.numpy(), np.asarray(jfm))
    assert_states_match(js, ts)


@pytest.fixture(scope="module")
def mono_runs(images):
    imgs, t_wc = images
    jt = jtr.Tracker(jmono.CFG, jtr.SharedMap(jmono.CFG))
    for i, img in enumerate(imgs):
        jt.track_mono(img, frame_id=i)
    tt = ttr.Tracker(TCFG, ttr.SharedMap(TCFG, device="cpu"), device="cpu")
    tt.draw_twoview_samples = jax_draw
    with threads(2):
        for i, img in enumerate(imgs):
            tt.track_mono(img, frame_id=i)
    return jt, tt, t_wc


def _centres(trajectory):
    return np.stack([_np_inverse(r.q.astype(np.float64),
                                 r.t.astype(np.float64))[1]
                     for r in trajectory])


@pytest.mark.e2e
def test_track_mono_matches_jax(mono_runs):
    jt, tt, t_wc = mono_runs
    lost_t = [r.lost for r in tt.trajectory]
    assert lost_t == [r.lost for r in jt.trajectory]
    init = lost_t.index(False)
    assert init <= 2 and not any(lost_t[init:])
    assert tt.state == ttr.TrackerState.OK
    np.testing.assert_array_equal(tt.shared.state.kf_frame_id.numpy(),
                                  np.asarray(jt.shared.state.kf_frame_id))
    np.testing.assert_array_equal(tt.shared.state.kf_valid.numpy(),
                                  np.asarray(jt.shared.state.kf_valid))
    qt = np.stack([r.q for r in tt.trajectory])
    qj = np.stack([r.q for r in jt.trajectory])
    np.testing.assert_allclose(qt, qj, atol=1e-5)
    ct, cj = _centres(tt.trajectory), _centres(jt.trajectory)
    extent = np.linalg.norm(cj.max(0) - cj.min(0))
    scale = float(np.sum(ct * cj) / np.sum(ct * ct))
    assert abs(scale - 1.0) < 0.02, scale
    err = np.abs(scale * ct - cj).max()
    assert err <= 1e-3 * extent, (err, extent, scale)


@pytest.mark.e2e
def test_track_mono_scale_free_ate(mono_runs):
    jt, tt, t_wc = mono_runs
    ates = []
    for tr in (tt, jt):
        rows = [r for r in tr.trajectory if not r.lost]
        est = _centres(rows)
        gt = t_wc[[r.frame_id for r in rows]]
        ates.append(ttraj.ate(est, gt, with_scale=True)["rmse"])
    t_ate, j_ate = ates
    assert t_ate < 0.08
    assert abs(t_ate - j_ate) <= max(0.1 * j_ate, 2e-3), (t_ate, j_ate)
