"""The port's ops/frame.py against the JAX one: stereo matching given the
SAME left/right keypoints (extracted once by the JAX package)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from multiagent_orb_slam2_tpu.ops import frame as jframe
from multiagent_orb_slam2_tpu.ops import orb as jorb
from multiagent_orb_slam2_tpu_torch import convert
from multiagent_orb_slam2_tpu_torch.ops import frame as tframe
from multiagent_orb_slam2_tpu_torch.ops import orb as torb

from torch_parity import (CFG, TCFG, jax_fields, sequence,
                          torch_feats_from_jax)


@pytest.fixture(scope="module")
def stereo_inputs():
    frames, _ = sequence(12)
    left, right = (np.ascontiguousarray(a) for a in frames[2])
    F = CFG.caps.max_features
    kl = jorb.pad_keypoints(jorb.extract(jnp.asarray(left), CFG.orb), F)
    kr = jorb.pad_keypoints(jorb.extract(jnp.asarray(right), CFG.orb), F)
    return left, right, kl, kr


def _torch_kp(kp):
    return torb.Keypoints(**{k: convert.to_tensor(v, "cpu")
                             for k, v in jax_fields(kp).items()})


def test_compute_stereo_matches(stereo_inputs):
    """u_right within 1e-3 px and depth within 1e-4 relative where both are
    valid; validity masks equal on >= 99 % (found: all)."""
    left, right, kl, kr = stereo_inputs
    fj = jframe.compute_stereo_matches(
        jframe.from_keypoints(kl, CFG), kr, jnp.asarray(left),
        jnp.asarray(right), CFG)
    ft = tframe.compute_stereo_matches(
        tframe.from_keypoints(_torch_kp(kl), TCFG), _torch_kp(kr),
        torch.from_numpy(left), torch.from_numpy(right), TCFG)
    dj, dt = np.asarray(fj.depth), ft.depth.numpy()
    vj, vt = dj > 0, dt > 0
    assert vj.sum() > 100
    assert np.mean(vj == vt) >= 0.99, np.mean(vj == vt)
    both = vj & vt
    np.testing.assert_allclose(ft.u_right.numpy()[both],
                               np.asarray(fj.u_right)[both], atol=1e-3, rtol=0)
    np.testing.assert_allclose(dt[both], dj[both], rtol=1e-4, atol=0)
    assert (ft.u_right.numpy()[~vt] == -1.0).all()


def test_sad_refine_border_clamp(stereo_inputs):
    """Matches whose strip would leave the image are shifted by the clamp,
    in both packages alike (the JAX behaviour is reproduced, not repaired)."""
    left, right, _, _ = stereo_inputs
    xy_l = np.array([[2.0, 3.0], [317.0, 236.0], [160.0, 120.0],
                     [8.4, 100.6]], np.float32)
    x_r = np.array([0.0, 319.0, 150.0, 3.5], np.float32)
    valid = np.ones(4, bool)
    xj, okj = jframe.sad_subpixel_refine(
        jnp.asarray(left), jnp.asarray(right), jnp.asarray(xy_l),
        jnp.asarray(x_r), jnp.asarray(valid))
    xt, okt = tframe.sad_subpixel_refine(
        torch.from_numpy(left), torch.from_numpy(right),
        torch.from_numpy(xy_l), torch.from_numpy(x_r),
        torch.from_numpy(valid))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-3)


def test_features_in_area(stereo_inputs):
    _, _, kl, _ = stereo_inputs
    fj = jframe.from_keypoints(kl, CFG)
    ft = torch_feats_from_jax(fj)
    centers = np.array([[100.0, 80.0], [250.0, 200.0]], np.float32)
    mj = jframe.features_in_area(fj, jnp.asarray(centers),
                                 jnp.asarray([30.0, 50.0]),
                                 min_level=jnp.asarray([0, 1]),
                                 max_level=jnp.asarray([3, 2]))
    mt = tframe.features_in_area(ft, centers, [30.0, 50.0],
                                 min_level=[0, 1], max_level=[3, 2])
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    assert mt.any()


def test_extract_frame_stereo_and_mono(stereo_inputs):
    """extract_frame end to end (the port's own extraction): depths agree
    with the JAX frame on the keypoints both packages found."""
    left, right, _, _ = stereo_inputs
    fj = jframe.extract_frame(jnp.asarray(left), CFG,
                              right_img=jnp.asarray(right))
    ft = tframe.extract_frame(left, TCFG, right_img=right, device="cpu")
    assert ft.xy.device.type == "cpu" and ft.xy.shape == (512, 2)
    same = np.all(np.asarray(fj.xy) == ft.xy.numpy(), axis=-1) \
        & np.asarray(fj.valid) & ft.valid.numpy()
    assert same.sum() >= 0.95 * np.asarray(fj.valid).sum()
    dj, dt = np.asarray(fj.depth)[same], ft.depth.numpy()[same]
    assert np.mean((dj > 0) == (dt > 0)) >= 0.99
    both = (dj > 0) & (dt > 0)
    np.testing.assert_allclose(dt[both], dj[both], rtol=1e-4)
    mono = tframe.extract_frame(left, TCFG, device="cpu")
    assert (mono.depth == -1).all() and (mono.u_right == -1).all()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tframe.extract_frame(left, TCFG, depth_map=left, device="cpu")
