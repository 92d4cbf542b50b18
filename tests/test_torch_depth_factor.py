"""Fault 12: the drivers hand the frame depth in metres.

A TUM-layout RGB-D clip written here (16-bit depth PNGs at the TUM factor
5000, rgb.txt / depth.txt, which both packages' ``load_tum_rgbd``
associate by timestamp, and a TUM-style settings file with
``DepthMapFactor: 5000``). ``io/datasets._imread_depth`` already divides the
raw depth by 5000, so the depth map times ``cfg.depth_map_factor`` that
reaches ``compute_stereo_from_rgbd`` must equal the loader's metres, and
they are within half a raw unit (1e-4 m) of the rendered depth.

The port's ``run_single`` and ``generic_split_seq.run_server`` run for
real on the CPU. The JAX drivers, which are not changed, are run with a
recording stand-in for their System / server (no tracking), and their
deviations are asserted: ``run_single`` multiplies the metres by 1/5000
again, ``generic_split_seq`` by the settings' 5000.
"""
import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from multiagent_orb_slam2_tpu.drivers import common as jcommon
from multiagent_orb_slam2_tpu.drivers import generic_split_seq as jsplit
from multiagent_orb_slam2_tpu.drivers import run_single as jrun_single
from multiagent_orb_slam2_tpu_torch.config import Capacities
from multiagent_orb_slam2_tpu_torch.drivers import common, generic_split_seq
from multiagent_orb_slam2_tpu_torch.drivers import run_single
from multiagent_orb_slam2_tpu_torch.geometry.camera import Intrinsics
from multiagent_orb_slam2_tpu_torch.io import datasets, synthetic
from multiagent_orb_slam2_tpu_torch.ops import frame as frame_mod

import torch_parity  # noqa: F401  (one torch thread per test worker)

CAM = Intrinsics(fx=230.0, fy=230.0, cx=160.0, cy=120.0, bf=115.0,
                 width=320, height=240)
N_FRAMES = 2
SETTINGS = """%YAML:1.0
Camera.fx: 230.0
Camera.fy: 230.0
Camera.cx: 160.0
Camera.cy: 120.0
Camera.width: 320
Camera.height: 240
Camera.bf: 115.0
Camera.fps: 10.0
ORBextractor.nFeatures: 400
ORBextractor.nLevels: 4
ThDepth: 40.0
DepthMapFactor: 5000.0
"""
SMALL = dict(max_keyframes=16, max_points=4096, max_features=512,
             local_points=2048)


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """(root, settings path, [raw uint16 depth], [rendered metres])."""
    root = tmp_path_factory.mktemp("tum")
    (root / "rgb").mkdir()
    (root / "depth").mkdir()
    scene = synthetic.BoxScene(seed=7, z_far=40.0)
    q_wc, t_wc = synthetic.corridor_trajectory(N_FRAMES, step=0.15, seed=1)
    raws, metres, rgb, dep = [], [], [], []
    for i in range(N_FRAMES):
        left, _, depth = scene.render_stereo(CAM, q_wc[i], t_wc[i])
        m = np.nan_to_num(depth, nan=0.0, posinf=0.0)
        raw = np.where((m > 0) & (m * 5000.0 < 65535),
                       np.round(m * 5000.0), 0).astype(np.uint16)
        cv2.imwrite(str(root / "rgb" / f"{i}.png"),
                    np.clip(left, 0, 255).astype(np.uint8))
        cv2.imwrite(str(root / "depth" / f"{i}.png"), raw)
        raws.append(raw)
        metres.append(np.where(raw > 0, m, 0.0))
        rgb.append(f"{i / 10.0:.6f} rgb/{i}.png")
        dep.append(f"{i / 10.0:.6f} depth/{i}.png")
    for name, rows in (("rgb.txt", rgb), ("depth.txt", dep)):
        (root / name).write_text("\n".join(rows) + "\n")
    settings = root / "TUM1.yaml"
    settings.write_text(SETTINGS)
    return str(root), str(settings), raws, metres


def _metres(raw):
    # what the loader returns: the raw depth over the TUM factor
    return raw.astype(np.float32) / 5000.0


def _spy(monkeypatch):
    """Record depth_map * cfg.depth_map_factor at every call of the port's
    compute_stereo_from_rgbd."""
    seen = []
    real = frame_mod.compute_stereo_from_rgbd

    def spy(feats, depth_map, cfg):
        seen.append((depth_map * cfg.depth_map_factor).cpu().numpy())
        return real(feats, depth_map, cfg)
    monkeypatch.setattr(frame_mod, "compute_stereo_from_rgbd", spy)
    real_settings = common.load_settings
    monkeypatch.setattr(common, "load_settings", lambda p, s: real_settings(
        p, s).replace(caps=Capacities(**SMALL)))
    return seen


def _check_metres(seen, raws, metres):
    assert len(seen) == len(raws)
    for got, raw, m in zip(seen, raws, metres):
        np.testing.assert_array_equal(got, _metres(raw))
        assert np.abs(got - m).max() <= 1e-4 + 1e-6
        assert got.max() > 1.0          # metres, not metres / 5000


def test_settings_carry_the_tum_factor(clip):
    _, settings, _, _ = clip
    cfg = common.load_settings(settings, common.SENSOR_OF["rgbd"])
    assert cfg.depth_map_factor == 5000.0
    assert common.metric_depth(cfg).depth_map_factor == 1.0
    seq = datasets.load_tum_rgbd(clip[0])
    assert len(seq) == N_FRAMES and seq.depth_factor == 5000.0
    np.testing.assert_array_equal(seq.load(0)[2], _metres(clip[2][0]))


def test_run_single_hands_the_frame_metres(clip, tmp_path, monkeypatch):
    root, settings, raws, metres = clip
    seen = _spy(monkeypatch)
    sys_, summary = run_single.run(
        ["-t", "rgbd_tum", "-d", root, "-s", settings, "-o",
         str(tmp_path / "out"), "--no-loop-closing", "--device", "cpu"])
    assert summary["frames"] == N_FRAMES and summary["lost"] == 0
    assert sys_.cfg.depth_map_factor == 1.0
    _check_metres(seen, raws, metres)


def test_split_driver_hands_the_frame_metres(clip, tmp_path, monkeypatch):
    root, settings, raws, metres = clip
    seen = _spy(monkeypatch)
    seq = datasets.load_tum_rgbd(root)
    server, _ = generic_split_seq.run_server(seq.split(2), "rgbd_tum",
                                             settings, "", str(tmp_path),
                                             "cpu")
    assert server.cfg.depth_map_factor == 1.0
    _check_metres(seen, raws, metres)


class _Recorder:
    """Stands in for the JAX System, server and trackers: records the
    configuration and every depth map handed to track_rgbd."""

    def __init__(self, cfg, *args, **kwargs):
        self.cfg, self.depths = cfg, []
        self.tracker, self.shared, self.stats = self, None, []
        self.n_relocalizations = 0
        self.multimap = type("MM", (), {"n_maps": 1})()
        _Recorder.last = self

    def track_rgbd(self, img, depth, frame_id=0):
        self.depths.append(np.asarray(depth) * self.cfg.depth_map_factor)

    def register_client(self, agent):
        return self

    def trajectory_tum(self, timestamps):
        return []

    def __getattr__(self, name):     # shutdown, save_*, process_new_...
        return lambda *a, **k: None


def test_jax_drivers_scale_the_metres_again(clip, tmp_path, monkeypatch):
    """The deviation, asserted: the unchanged JAX run_single multiplies the
    loader's metres by 1 / 5000, the JAX split driver by the settings'
    DepthMapFactor 5000."""
    root, settings, raws, _ = clip
    monkeypatch.delenv("SLAM_DIAG", raising=False)
    monkeypatch.setattr(jrun_single, "System", _Recorder)
    jrun_single.main(["-t", "rgbd_tum", "-d", root, "-s", settings, "-o",
                      str(tmp_path / "single"), "--no-loop-closing"])
    rec = _Recorder.last
    assert rec.cfg.depth_map_factor == pytest.approx(1 / 5000.0)
    assert len(rec.depths) == N_FRAMES
    for got, raw in zip(rec.depths, raws):
        np.testing.assert_allclose(got, _metres(raw) / 5000.0, rtol=1e-6)

    monkeypatch.setattr(jsplit, "MultiAgentServer", _Recorder)
    jsplit.main(["-t", "rgbd_tum", "-n", "2", "-d", root, "-s", settings,
                 "-o", str(tmp_path / "split")])
    rec = _Recorder.last
    assert rec.cfg.depth_map_factor == 5000.0
    jcfg = jcommon.load_settings(settings, jcommon.SENSOR_OF["rgbd"])
    assert jcfg.depth_map_factor == 5000.0
    for got, raw in zip(rec.depths, raws):
        np.testing.assert_allclose(got, _metres(raw) * 5000.0, rtol=1e-6)
