"""The port's single-agent driver and accuracy protocol against the JAX
package's.

- make_synth_seq.loop_trajectory equal to the JAX generator's (1e-6: both
  draw the same numpy numbers; the quaternion is float32 in both).
- A sequence written by the port's generator (the first 12 frames of the
  660-frame loop corridor, seed 0, 512x288) is the JAX generator's format:
  rendering with a pool of processes gives the serial result bit for bit.
- run_single end to end on the CPU over those frames, with small
  capacities substituted into the settings: every output written, nothing
  lost, ATE under 0.05 m, the per-frame diagnostics row written, and the
  map restores into a fresh System.
- The protocol's table (collect_synthetic.write_table).
- genstats.evaluate against the JAX one on the same files: ATE, RMSE,
  RPE-t and scale within 1e-6 (the JAX package builds its matrices in
  float32), RPE-r within 2e-3 degrees (arccos near 1 amplifies float32
  rounding of a 0.1-degree rotation); rpe_t_per_m is summed errors over
  summed ground-truth steps.
- Both packages' System, built as run_single builds it (the committed
  vocabulary, loop closing on), over the corridor's first 10 frames on
  features the JAX package extracts once: camera centres within 2 mm frame
  by frame, the same keyframe frames, n_kf, n_mp and database rows.
"""
import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

torch.set_num_threads(1)   # several test workers share few cores

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "analysis"))
import genstats as jgenstats
import make_synth_seq as jmake

from multiagent_orb_slam2_tpu import config as jconfig
from multiagent_orb_slam2_tpu.ops import frame as jframe
from multiagent_orb_slam2_tpu.runtime import system as jsys
from multiagent_orb_slam2_tpu.vocab import bow as jbow
from multiagent_orb_slam2_tpu_torch import convert
from multiagent_orb_slam2_tpu_torch.analysis import collect_synthetic
from multiagent_orb_slam2_tpu_torch.analysis import genstats
from multiagent_orb_slam2_tpu_torch.analysis import make_synth_seq
from multiagent_orb_slam2_tpu_torch.config import Capacities
from multiagent_orb_slam2_tpu_torch.drivers import common, run_single
from multiagent_orb_slam2_tpu_torch.io import datasets
from multiagent_orb_slam2_tpu_torch.io import trajectory as ttraj
from multiagent_orb_slam2_tpu_torch.runtime import system as tsys
from multiagent_orb_slam2_tpu_torch.runtime.tracker import _np_inverse
from multiagent_orb_slam2_tpu_torch.utils import diag as tdiag
from multiagent_orb_slam2_tpu_torch.vocab import bow as tbow

from torch_parity import torch_feats_from_jax

N_FRAMES = 12
SMALL = dict(max_keyframes=16, max_points=8192, max_features=1024,
             local_points=4096)


def test_loop_trajectory_matches_jax():
    for n, seed in ((60, 3), (660, 0)):
        qj, tj = jmake.loop_trajectory(n, 1.0, 24.0, seed=seed)
        qt, tt = make_synth_seq.loop_trajectory(n, 1.0, 24.0, seed=seed)
        np.testing.assert_allclose(qt, qj, atol=1e-6)
        np.testing.assert_allclose(tt, tj, atol=1e-6)


@pytest.fixture(scope="module")
def corridor(tmp_path_factory):
    """The first N_FRAMES frames of the 660-frame loop corridor (seed 0),
    written by the port's generator."""
    root = tmp_path_factory.mktemp("corridor")
    q, t = make_synth_seq.loop_trajectory(660, 1.0, 24.0, seed=0)
    make_synth_seq.write_sequence(str(root), 0, q[:N_FRAMES], t[:N_FRAMES],
                                  make_synth_seq.camera())
    return str(root), t[:N_FRAMES]


def test_sequence_files_and_pool(corridor, tmp_path):
    root, t_gt = corridor
    seq = datasets.load_synth_stereo(root)
    assert len(seq) == N_FRAMES
    left, right, depth = seq.load(0)
    assert left.shape == right.shape == (288, 512) and depth is None
    assert left.dtype == np.float32
    gt = ttraj.read_tum(os.path.join(root, "gt_tum.txt"))
    np.testing.assert_allclose(gt[:, 1:4], t_gt, atol=1e-8)
    with open(os.path.join(root, "settings.json")) as f:
        s = json.load(f)
    assert (s["Camera.width"], s["Camera.fx"], s["ORBextractor.nFeatures"]) \
        == (512, 260.0, 600)
    q, t = make_synth_seq.loop_trajectory(660, 1.0, 24.0, seed=0)
    make_synth_seq.write_sequence(str(tmp_path), 0, q[:2], t[:2],
                                  make_synth_seq.camera(), workers=2)
    for i in range(2):
        for side in ("left", "right"):
            name = f"{side}_{i:05d}.npy"
            np.testing.assert_array_equal(np.load(tmp_path / name),
                                          np.load(os.path.join(root, name)))


def _small_settings(monkeypatch):
    real = common.load_settings
    monkeypatch.setattr(common, "load_settings", lambda p, s: real(p, s)
                        .replace(caps=Capacities(**SMALL)))


@pytest.mark.e2e
def test_run_single_end_to_end_cpu(corridor, tmp_path, monkeypatch):
    root, t_gt = corridor
    _small_settings(monkeypatch)
    log = tmp_path / "diag.jsonl"
    monkeypatch.setenv("SLAM_DIAG", str(log))
    monkeypatch.setattr(tdiag, "_frame_sink", None)
    out = tmp_path / "out"
    system, summary = run_single.run(
        ["-t", "stereo_synth", "-d", root, "-s",
         os.path.join(root, "settings.json"), "-o", str(out),
         "--device", "cpu"])
    tdiag.frame_sink().f.close()
    assert system.device == torch.device("cpu")
    assert system.enable_loop_closing and system.loop_closer is not None
    assert summary["frames"] == N_FRAMES and summary["lost"] == 0
    assert summary["keyframes_created"] >= 2
    assert summary["relocalizations"] == summary["loops_corrected"] == 0
    for name in ("CameraTrajectory.txt", "KeyFrameTrajectory.txt",
                 "map.npz"):
        assert (out / name).is_file(), name
    rows = ttraj.read_tum(out / "CameraTrajectory.txt")
    assert rows.shape == (N_FRAMES, 8)
    assert ttraj.read_tum(out / "KeyFrameTrajectory.txt").shape[0] == \
        summary["keyframes_live"]
    assert ttraj.ate(rows[:, 1:4], t_gt)["mean"] < 0.05
    diag_rows = [json.loads(x) for x in log.read_text().splitlines()]
    assert [r["frame"] for r in diag_rows] == list(range(N_FRAMES))
    assert all(r["state"] == 1 for r in diag_rows)
    restored = tsys.System(system.cfg, system.vocab, device="cpu")
    restored.load_map(str(out / "map.npz"))
    for name, a in system.shared.state._asdict().items():
        assert torch.equal(getattr(restored.shared.state, name), a), name
    r = genstats.evaluate(os.path.join(root, "gt_tum.txt"),
                          str(out / "CameraTrajectory.txt"))
    j = jgenstats.evaluate(os.path.join(root, "gt_tum.txt"),
                           str(out / "CameraTrajectory.txt"))
    assert r["n"] == j["n"] == N_FRAMES
    for k in ("ate", "ate_rmse", "rpe_t", "scale"):
        assert abs(r[k] - j[k]) <= 1e-6, k
    assert abs(r["rpe_r"] - j["rpe_r"]) <= 2e-3


def test_collect_synthetic_table(tmp_path):
    """The protocol's table: per-trial rows with every column the JAX
    record has and the port adds, and means over the trials."""
    acc = dict(n=660, ate=0.02, ate_rmse=0.025, rpe_t=0.007,
               rpe_t_per_m=0.09, rpe_r=0.09, scale=1.0)
    meta = dict(frames=660, lost=0, relocalizations=1, loops_corrected=1,
                keyframes_created=180, keyframes_live=80, resets=2)
    rows = [{"trial": 0, "meta": meta, "single": acc},
            {"trial": 1, "meta": meta,
             "single": {**acc, "ate": 0.04}}]
    out = tmp_path / "table.txt"
    collect_synthetic.write_table(str(out), rows, 3, "cpu")
    text = out.read_text()
    assert "# device: cpu" in text and "trials completed: 2/3" in text
    single = next(x for x in text.splitlines() if x.startswith("single"))
    assert float(single.split()[1]) == pytest.approx(0.03)
    assert "trial1: ate=0.0400 ate_rmse=0.0250 rpe_t=0.0070 " \
        "rpe_t_per_m=0.0900 rpe_r=0.0900 exported=660/660 lost=0 " \
        "relocs=1 loops=1 resets=2" in text
    assert collect_synthetic.device_line("cpu") == "cpu"


def test_genstats_matches_jax(corridor, tmp_path):
    """An estimate with drift and noise, written in TUM format."""
    root, _ = corridor
    gt = ttraj.read_tum(os.path.join(root, "gt_tum.txt"))
    rng = np.random.default_rng(5)
    est = gt.copy()
    est[:, 1:4] += np.cumsum(rng.normal(0, 0.01, (len(gt), 3)), 0)
    q = est[:, 4:8] + rng.normal(0, 2e-3, (len(gt), 4))
    est[:, 4:8] = q / np.linalg.norm(q, axis=1, keepdims=True)
    path = str(tmp_path / "est.txt")
    ttraj.write_tum(path, est[1:])          # one frame missing
    r = genstats.evaluate(os.path.join(root, "gt_tum.txt"), path)
    j = jgenstats.evaluate(os.path.join(root, "gt_tum.txt"), path)
    assert r["n"] == j["n"] == len(gt) - 1
    for k in ("ate", "ate_rmse", "rpe_t", "scale"):
        assert abs(r[k] - j[k]) <= 1e-6, (k, r[k], j[k])
    assert abs(r["rpe_r"] - j["rpe_r"]) <= 2e-3
    steps = np.linalg.norm(np.diff(gt[1:, 1:4], axis=0), axis=1).sum()
    np.testing.assert_allclose(r["rpe_t_per_m"],
                               r["rpe_t"] * (len(gt) - 2) / steps, rtol=1e-6)


@pytest.mark.e2e
def test_system_over_loop_corridor_matches_jax(corridor):
    """Both Systems as run_single builds them (the committed vocabulary,
    loop closing on), on the corridor's first 10 frames."""
    root, _ = corridor
    with open(os.path.join(root, "settings.json")) as f:
        d = json.load(f)
    cfg = jconfig.from_yaml_dict(d).replace(caps=jconfig.Capacities(**SMALL))
    tcfg = convert.config_from_dict({**dataclasses.asdict(cfg),
                                     "camera": cfg.camera})
    assert tcfg == common.load_settings(
        os.path.join(root, "settings.json"),
        common.SENSOR_OF["stereo"]).replace(caps=Capacities(**SMALL))
    seq = datasets.load_synth_stereo(root)
    js = jsys.System(cfg, jbow.load_vocabulary(str(tbow.DEFAULT_VOCAB)))
    ts = tsys.System(tcfg, tbow.load_vocabulary(device="cpu"), device="cpu")
    kf_j, kf_t = [], []
    for i in range(10):
        left, right, _ = seq.load(i)
        f = jframe.extract_frame(jnp.asarray(left), cfg,
                                 right_img=jnp.asarray(right))
        nj, nt = js.shared.n_created, ts.shared.n_created
        js._track(f, i)
        ts._track(torch_feats_from_jax(f), i)
        kf_j += [i] * (js.shared.n_created > nj)
        kf_t += [i] * (ts.shared.n_created > nt)
        rj, rt = js.tracker.trajectory[-1], ts.tracker.trajectory[-1]
        assert rj.lost == rt.lost is False, i
        cj = _np_inverse(rj.q.astype(np.float64), rj.t.astype(np.float64))
        ct = _np_inverse(rt.q.astype(np.float64), rt.t.astype(np.float64))
        assert np.linalg.norm(cj[1] - ct[1]) <= 2e-3, i
    assert kf_j == kf_t and len(kf_t) >= 2
    assert (js.shared.n_kf, js.shared.n_mp) == (ts.shared.n_kf,
                                                ts.shared.n_mp)
    np.testing.assert_array_equal(ts.loop_closer.db.active.numpy(),
                                  np.asarray(js.loop_closer.db.active))
    np.testing.assert_array_equal(ts.loop_closer.db.words.numpy(),
                                  np.asarray(js.loop_closer.db.words))
