"""The port's stereo rectification (io/rectify.py) and its driver hook
against the JAX package's.

- rectify_map: the JAX function's map, bit for bit (the same numpy code),
  on an identity camera and on a EuRoC-like camera with distortion and a
  1.3 degree rectifying rotation.
- remap_bilinear: the same four-tap gather, zero outside the image, against
  the JAX function on a random image sampled at a map reaching outside it:
  within 1e-4 grey levels (float32 rounding of the weights; measured
  below 2e-5); the identity map returns the image, a one-pixel shift moves
  it by one pixel.
- drivers/common.get_rectifier on a settings YAML with LEFT. / RIGHT. K, D,
  R, P blocks: a StereoRectifier on the requested device whose maps equal
  the JAX rectifier's and whose output pair matches the JAX pair as above;
  None for settings without those blocks.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multiagent_orb_slam2_tpu.drivers import common as jcommon
from multiagent_orb_slam2_tpu.io import rectify as jrect
from multiagent_orb_slam2_tpu_torch.drivers import common
from multiagent_orb_slam2_tpu_torch.io import rectify as trect

K = np.array([[458.654, 0, 367.215], [0, 457.296, 248.375], [0, 0, 1]])
D = np.array([-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0])
TH = np.deg2rad(1.3)
R = np.array([[np.cos(TH), -np.sin(TH), 0], [np.sin(TH), np.cos(TH), 0],
              [0, 0, 1.0]])
P = np.array([[435.2, 0, 367.4, 0], [0, 435.2, 252.2, 0], [0, 0, 1, 0]])


def _matrix(name, M):
    M = np.atleast_2d(M)
    data = ", ".join(repr(float(v)) for v in M.ravel())
    return (f"{name}: !!opencv-matrix\n   rows: {M.shape[0]}\n"
            f"   cols: {M.shape[1]}\n   dt: d\n   data: [{data}]\n")


@pytest.mark.parametrize("case", ["identity", "euroc"])
def test_rectify_map_equals_jax(case):
    if case == "identity":
        Kc = np.array([[100.0, 0, 32], [0, 100.0, 24], [0, 0, 1]])
        args = (Kc, np.zeros(5), np.eye(3), np.hstack([Kc, np.zeros((3, 1))]),
                64, 48)
    else:
        args = (K, D, R, P, 752, 480)
    np.testing.assert_array_equal(trect.rectify_map(*args),
                                  jrect.rectify_map(*args))


def test_remap_bilinear_matches_jax():
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (48, 64)).astype(np.float32)
    m = np.stack([rng.uniform(-3, 67, (40, 50)),
                  rng.uniform(-3, 51, (40, 50))], -1).astype(np.float32)
    want = np.asarray(jrect.remap_bilinear(jnp.asarray(img), jnp.asarray(m)))
    got = trect.remap_bilinear(torch.from_numpy(img),
                               torch.from_numpy(m)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert (got == 0).sum() == (want == 0).sum() > 0
    # identity and a one-pixel shift (tests/test_rectify.py's cases)
    u, v = np.meshgrid(np.arange(64.0), np.arange(48.0))
    ident = torch.from_numpy(np.stack([u, v], -1).astype(np.float32))
    np.testing.assert_allclose(
        trect.remap_bilinear(torch.from_numpy(img), ident).numpy(), img,
        atol=1e-3)
    dot = torch.zeros((10, 10))
    dot[5, 5] = 1.0
    u, v = np.meshgrid(np.arange(10.0), np.arange(10.0))
    shift = torch.from_numpy(np.stack([u + 1.0, v], -1).astype(np.float32))
    out = trect.remap_bilinear(dot, shift)
    assert float(out[5, 4]) == pytest.approx(1.0)
    assert float(out[5, 5]) == pytest.approx(0.0)


def test_get_rectifier_from_left_right_yaml(tmp_path):
    y = tmp_path / "euroc.yaml"
    R2 = R.T
    P2 = P.copy()
    P2[0, 3] = -47.9
    y.write_text("%YAML:1.0\nCamera.fx: 435.2\n"
                 "LEFT.height: 120\nLEFT.width: 160\n"
                 + _matrix("LEFT.K", K) + _matrix("LEFT.D", D)
                 + _matrix("LEFT.R", R) + _matrix("LEFT.P", P)
                 + "RIGHT.height: 120\nRIGHT.width: 160\n"
                 + _matrix("RIGHT.K", K) + _matrix("RIGHT.D", D * 0.9)
                 + _matrix("RIGHT.R", R2) + _matrix("RIGHT.P", P2))
    rect = common.get_rectifier(str(y), device="cpu")
    jr = jcommon.get_rectifier(str(y))
    assert isinstance(rect, trect.StereoRectifier)
    assert rect.map_l.device.type == "cpu"
    np.testing.assert_array_equal(rect.map_l.numpy(), np.asarray(jr.map_l))
    np.testing.assert_array_equal(rect.map_r.numpy(), np.asarray(jr.map_r))
    rng = np.random.default_rng(1)
    left = rng.uniform(0, 255, (120, 160)).astype(np.float32)
    right = rng.uniform(0, 255, (120, 160)).astype(np.float32)
    got = rect(left, right)
    want = jr(left, right)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (120, 160)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=0)
    # no LEFT. / RIGHT. blocks (KITTI, TUM, the synthetic corridor): None
    plain = tmp_path / "kitti.yaml"
    plain.write_text("%YAML:1.0\nCamera.fx: 718.9\nCamera.bf: 386.1\n")
    assert common.get_rectifier(str(plain), device="cpu") is None
    assert common.get_rectifier(str(tmp_path / "s.json"), device="cpu") is None
