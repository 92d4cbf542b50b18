"""The card renderer against the port's host renderer, and the loop path
against the port's generator."""
import numpy as np
import pytest
import torch

from multiagent_orb_slam2_tpu_torch.analysis import make_synth_seq
from multiagent_orb_slam2_tpu_torch.geometry.camera import Intrinsics
from multiagent_orb_slam2_tpu_torch.io import synthetic
from slambench import render

CAM = dict(fx=40.0, fy=40.0, cx=32.0, cy=24.0, bf=4.8, width=64, height=48)


@pytest.mark.parametrize("i", [0, 30, 45, 70])
def test_render_equals_box_scene(i):
    host = synthetic.BoxScene(seed=3, z_far=12.0)
    card = render.CardScene([torch.from_numpy(t) for t in host.textures],
                            z_far=12.0)
    q, t = render.loop_trajectory(80, 1.0, 10.0, seed=5)
    cam = Intrinsics(**CAM)
    left, right, _ = host.render_stereo(cam, q[i], t[i])
    R = torch.tensor(synthetic._quat_to_matrix(q[i]), dtype=torch.float64)
    tt = torch.tensor(t[i], dtype=torch.float64)
    got = card.render(CAM, R, tt).numpy()
    assert np.abs(got - left).max() < 1e-3
    R_wc = torch.tensor(synthetic._quat_to_matrix(q[i]), dtype=torch.float64)
    l8, r8 = card.render_stereo_u8(CAM, R_wc, tt)
    assert np.abs(l8.numpy().astype(int)
                  - np.clip(left, 0, 255).astype(np.uint8)).max() <= 1
    assert np.abs(r8.numpy().astype(int)
                  - np.clip(right, 0, 255).astype(np.uint8)).max() <= 1


def test_loop_trajectory_is_the_generators():
    q, t = render.loop_trajectory(120, 1.0, 24.0, seed=9)
    q2, t2 = make_synth_seq.loop_trajectory(120, 1.0, 24.0, seed=9)
    assert np.array_equal(q, q2) and np.array_equal(t, t2)


def test_textures_from_seed():
    a = render.CardScene.from_seed(7, "cpu", z_far=4.0)
    b = render.CardScene.from_seed(7, "cpu", z_far=4.0)
    c = render.CardScene.from_seed(8, "cpu", z_far=4.0)
    assert len(a.textures) == 6 and a.textures[0].shape == (1024, 1024)
    assert all(torch.equal(x, y) for x, y in zip(a.textures, b.textures))
    assert not torch.equal(a.textures[0], c.textures[0])
    tex = a.textures[0]
    assert 0 <= float(tex.min()) and float(tex.max()) <= 255
    assert float(tex.std()) > 30          # high contrast, as the host's
