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
    """Fault 5 (ROADMAP.md queue 3), the port's departure from the JAX
    package: a match whose left patch or right strip would leave the image
    is rejected, as the reference's ComputeStereoMatches rejects it by its
    iniu / endu test; the JAX package shifts the strip inside the image and
    may keep the match (it keeps (317, 236) here). Inside the image both
    packages agree: a real match of the frame (the last row) is kept by
    both at the same right-x."""
    left, right, kl, kr = stereo_inputs
    fj = jframe.compute_stereo_matches(
        jframe.from_keypoints(kl, CFG), kr, jnp.asarray(left),
        jnp.asarray(right), CFG)
    f = int(np.nonzero(np.asarray(fj.depth) > 0)[0][0])
    xy_l = np.array([[2.0, 3.0], [317.0, 236.0], [160.0, 120.0],
                     [8.4, 100.6], np.asarray(fj.xy)[f]], np.float32)
    x_r = np.array([0.0, 319.0, 150.0, 3.5,
                    np.round(np.asarray(fj.u_right)[f])], np.float32)
    valid = np.ones(5, bool)
    xj, okj = jframe.sad_subpixel_refine(
        jnp.asarray(left), jnp.asarray(right), jnp.asarray(xy_l),
        jnp.asarray(x_r), jnp.asarray(valid))
    xt, okt = tframe.sad_subpixel_refine(
        torch.from_numpy(left), torch.from_numpy(right),
        torch.from_numpy(xy_l), torch.from_numpy(x_r),
        torch.from_numpy(valid))
    inside = np.array([False, False, True, False, True])
    np.testing.assert_array_equal(
        tframe.sad_window_inside(torch.round(torch.from_numpy(xy_l)).int(),
                                 torch.from_numpy(x_r).int(),
                                 left.shape).numpy(), inside)
    okj, okt = np.asarray(okj), okt.numpy()
    np.testing.assert_array_equal(okt, okj & inside)
    assert okj[1] and not okt[1]                      # the departure
    assert okt[4]
    np.testing.assert_allclose(xt.numpy()[inside], np.asarray(xj)[inside],
                               atol=1e-3)


def test_sad_in_bounds_term_rejects_nothing_on_the_sequence(monkeypatch):
    """On the frames of the parity sequence the keypoints' border keeps
    every stereo candidate's patch and strip inside the image: the
    in-bounds term of sad_subpixel_refine rejects no match."""
    frames, _ = sequence(12)
    real = tframe.sad_subpixel_refine
    seen = []

    def counted(left_img, right_img, xy_l, x_r, valid, win=5, search=5):
        inside = tframe.sad_window_inside(
            torch.round(xy_l).to(torch.int32),
            torch.round(x_r).to(torch.int32), left_img.shape, win, search)
        seen.append((int(valid.sum()), int((valid & ~inside).sum())))
        return real(left_img, right_img, xy_l, x_r, valid, win, search)

    monkeypatch.setattr(tframe, "sad_subpixel_refine", counted)
    for left, right in frames:
        tframe.extract_frame(left, TCFG, right_img=right, device="cpu")
    assert len(seen) == len(frames)
    assert min(n for n, _ in seen) > 100
    assert [r for _, r in seen] == [0] * len(frames)


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
    # an RGB-D frame (ported): the same keypoints as the mono frame, the
    # depth map read at each rounded keypoint, u_right = x - bf / d
    depth = np.full(left.shape, 4.0, np.float32)
    depth[:, : left.shape[1] // 2] = 0.0          # no depth on the left half
    rgbd = tframe.extract_frame(left, TCFG, depth_map=depth, device="cpu")
    assert torch.equal(rgbd.xy, mono.xy) and torch.equal(rgbd.desc, mono.desc)
    has = rgbd.valid & (torch.round(rgbd.xy[:, 0]) >= left.shape[1] // 2)
    assert int(has.sum()) > 50
    assert bool((rgbd.depth[has] == 4.0).all())
    assert bool((rgbd.depth[~has] == -1.0).all())
    np.testing.assert_allclose(rgbd.u_right[has].numpy(),
                               (rgbd.xy[has, 0] - TCFG.camera.bf / 4.0).numpy(),
                               rtol=0, atol=0)
