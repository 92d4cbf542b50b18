"""RGB-D frames and tracking in the port against the JAX package.

- compute_stereo_from_rgbd: the same depth, bit for bit, and u_right
  within 3.1e-5 px, one float32 ulp at 320 px [1.9e-6 px: XLA rounds
  x - bf / d otherwise], on
  random keypoints (border ones included, features invalid or on zero
  depth among them) and a random depth map with holes, at a depth map
  factor other than 1.
- extract_frame with a depth map: the same features as the JAX frame, with
  the same depth and u_right as above.
- A short RGB-D run: Tracker.track_rgbd of both packages over the first 8
  frames of the seed-7 corridor (left image + the renderer's exact depth),
  local BA on: the same frames tracked, the same keyframes, camera centres
  within 2 mm (the standing tolerance of whole tracker runs).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multiagent_orb_slam2_tpu.config import Sensor as JSensor
from multiagent_orb_slam2_tpu.io.synthetic import BoxScene, corridor_trajectory
from multiagent_orb_slam2_tpu.ops import frame as jframe
from multiagent_orb_slam2_tpu.runtime import tracker as jtr
from multiagent_orb_slam2_tpu_torch import convert
from multiagent_orb_slam2_tpu_torch.config import Sensor
from multiagent_orb_slam2_tpu_torch.ops import frame as tframe
from multiagent_orb_slam2_tpu_torch.runtime import tracker as ttr

from torch_parity import (CAM, CFG, STEP, jax_fields, threads,
                          torch_feats_from_jax)

JCFG = CFG.replace(sensor=JSensor.RGBD)
TCFG = convert.config_from_dict({**dataclasses.asdict(JCFG), "camera": CAM})
N_FRAMES = 8


def _centres(trajectory):
    out = []
    for r in trajectory:
        q = r.q.astype(np.float64) / np.linalg.norm(r.q)
        w, x, y, z = q
        R = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
        out.append(-R.T @ r.t.astype(np.float64))
    return np.stack(out)


@pytest.fixture(scope="module")
def rgbd_frames():
    scene = BoxScene(seed=7, z_far=40.0)
    q_wc, t_wc = corridor_trajectory(N_FRAMES, step=STEP, seed=1)
    frames = []
    for i in range(N_FRAMES):
        left, _, depth = scene.render_stereo(CAM, q_wc[i], t_wc[i])
        frames.append((left, depth))
    return frames, t_wc


def test_compute_stereo_from_rgbd_exact():
    rng = np.random.default_rng(3)
    H, W, N = 60, 80, 300
    depth = rng.uniform(0.5, 30.0, (H, W)).astype(np.float32)
    depth[rng.uniform(size=(H, W)) < 0.2] = 0.0          # holes
    xy = np.concatenate([rng.uniform(-2, W + 2, (N, 1)),
                         rng.uniform(-2, H + 2, (N, 1))], 1).astype(np.float32)
    valid = rng.uniform(size=N) < 0.9
    cfg = JCFG.replace(depth_map_factor=0.5)
    tcfg = TCFG.replace(depth_map_factor=0.5)
    neg = -np.ones(N, np.float32)
    jf = jframe.FrameFeatures(
        jnp.asarray(xy), jnp.zeros(N), jnp.zeros(N, jnp.int32), jnp.zeros(N),
        jnp.zeros((N, 8), jnp.int32), jnp.asarray(valid), jnp.asarray(neg),
        jnp.asarray(neg))
    want = jframe.compute_stereo_from_rgbd(jf, jnp.asarray(depth), cfg)
    got = tframe.compute_stereo_from_rgbd(torch_feats_from_jax(jf),
                                          torch.from_numpy(depth), tcfg)
    np.testing.assert_array_equal(got.depth.numpy(), np.asarray(want.depth))
    np.testing.assert_allclose(got.u_right.numpy(), np.asarray(want.u_right),
                               rtol=0, atol=3.1e-5)
    assert (got.depth.numpy() > 0).sum() > 150
    assert (got.depth.numpy()[~valid] == -1).all()


def test_extract_frame_with_depth_matches_jax(rgbd_frames):
    frames, _ = rgbd_frames
    left, depth = frames[0]
    fj = jframe.extract_frame(jnp.asarray(left), JCFG,
                              depth_map=jnp.asarray(depth))
    ft = tframe.extract_frame(left, TCFG, depth_map=depth, device="cpu")
    same = np.all(np.asarray(fj.xy) == ft.xy.numpy(), axis=-1) \
        & np.asarray(fj.valid) & ft.valid.numpy()
    assert same.sum() >= 0.95 * np.asarray(fj.valid).sum()
    np.testing.assert_array_equal(ft.depth.numpy()[same],
                                  np.asarray(fj.depth)[same])
    np.testing.assert_allclose(ft.u_right.numpy()[same],
                               np.asarray(fj.u_right)[same], rtol=0, atol=3.1e-5)
    assert (ft.depth.numpy()[same] > 0).sum() > 200


@pytest.mark.e2e
def test_track_rgbd_matches_jax(rgbd_frames):
    frames, t_wc = rgbd_frames
    jshared = jtr.SharedMap(JCFG)
    jt = jtr.Tracker(JCFG, jshared)
    for i, (left, depth) in enumerate(frames):
        jt.track_rgbd(left, depth, frame_id=i)
    tshared = ttr.SharedMap(TCFG, device="cpu")
    tt = ttr.Tracker(TCFG, tshared, device="cpu")
    assert TCFG.sensor == Sensor.RGBD
    with threads(2):
        for i, (left, depth) in enumerate(frames):
            tt.track_rgbd(left, depth, frame_id=i)
    assert [r.lost for r in tt.trajectory] == [r.lost for r in jt.trajectory]
    assert not any(r.lost for r in tt.trajectory)
    assert tshared.n_kf == jshared.n_kf >= 2
    jf = jax_fields(jshared.state)
    np.testing.assert_array_equal(tshared.state.kf_valid.numpy(),
                                  jf["kf_valid"])
    np.testing.assert_array_equal(tshared.state.kf_frame_id.numpy(),
                                  jf["kf_frame_id"])
    ct, cj = _centres(tt.trajectory), _centres(jt.trajectory)
    assert np.abs(ct - cj).max() < 2e-3
    assert np.sqrt(np.mean(np.sum((ct - t_wc) ** 2, -1))) < 0.05
