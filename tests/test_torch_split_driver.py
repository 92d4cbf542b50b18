"""The port's multi-agent drivers and the split half of its accuracy
protocol, against the JAX package's.

- collect_synthetic over one trial of the first 12 frames of the loop
  corridor (seed 0, 512x288), small capacities substituted into the
  settings as tests/test_torch_driver.py does: the table has the single row
  and the agent0 / agent1 rows, and each trial its split line with the
  final maps, fusions and relocalizations.
- generic_split_seq -n 2 on that sequence (run by collect_synthetic):
  SLAM0.txt, SLAM1.txt and stats.csv written; the same frames exported as
  by the JAX driver on the same files, camera centres within 2 mm; the
  same stats.csv (its header, the JAX write_fusion_stats header); the
  returned final_maps / fusions / relocalizations equal to the JAX
  driver's. The two halves fuse at the hand-over into one map in both
  packages (before fault 11 was repaired, agent 1's keyframes culled agent
  0's young map and the clip ended with two maps).
- two_seq on two 6-frame sequences: the same outputs as the JAX driver's,
  and final maps and fusions equal to what it prints.
- write_fusion_stats: the same file as the JAX package's for the same
  stats rows.
- The drivers run on the CUDA device unless the caller passes another: on
  a machine without one they raise. Mono and RGB-D sub-sequences run
  through run_server on a short clip.
- Fault 9 (ROADMAP.md queue 3): the JAX runs above count each agent's own
  map at the two keyframe-count gates (torch_parity.OwnMapGates), as the
  port does; the unchanged JAX driver's agent 1 loses its first frames,
  the port's does not.
"""
import dataclasses
import os
import re

import numpy as np
import pytest
import torch

from multiagent_orb_slam2_tpu import config as jconfig
from multiagent_orb_slam2_tpu.drivers import common as jcommon
from multiagent_orb_slam2_tpu.drivers import generic_split_seq as jsplit
from multiagent_orb_slam2_tpu.drivers import two_seq as jtwo
from multiagent_orb_slam2_tpu.server import MultiAgentServer as JServer
from multiagent_orb_slam2_tpu_torch.analysis import (collect_synthetic,
                                                     make_synth_seq)
from multiagent_orb_slam2_tpu_torch.config import Capacities
from multiagent_orb_slam2_tpu_torch.drivers import common
from multiagent_orb_slam2_tpu_torch.drivers import generic_split_seq
from multiagent_orb_slam2_tpu_torch.drivers import two_seq
from multiagent_orb_slam2_tpu_torch.io import datasets
from multiagent_orb_slam2_tpu_torch.io import trajectory as ttraj

from torch_parity import port_views

torch.set_num_threads(1)   # several test workers share few cores

N_FRAMES = 12
SMALL = dict(max_keyframes=16, max_points=8192, max_features=1024,
             local_points=4096)


def _small_settings(monkeypatch):
    real, jreal = common.load_settings, jcommon.load_settings
    monkeypatch.setattr(common, "load_settings", lambda p, s: real(p, s)
                        .replace(caps=Capacities(**SMALL)))
    monkeypatch.setattr(jcommon, "load_settings", lambda p, s: jreal(p, s)
                        .replace(caps=jconfig.Capacities(**SMALL)))


@pytest.fixture(scope="module")
def protocol(tmp_path_factory):
    """One trial of the port's collect_synthetic on the CPU: run_single and
    generic_split_seq -n 2 on the corridor's first frames, rendered here
    (collect_synthetic renders a trial only when its sequence is missing;
    --frames would make a whole loop of that many frames)."""
    work = tmp_path_factory.mktemp("protocol")
    q, t = make_synth_seq.loop_trajectory(660, 1.0, 24.0, seed=0)
    make_synth_seq.write_sequence(str(work / "seq0"), 0, q[:N_FRAMES],
                                  t[:N_FRAMES], make_synth_seq.camera())
    with pytest.MonkeyPatch.context() as mp:
        _small_settings(mp)
        rows = collect_synthetic.main(
            ["--trials", "1", "--frames", str(N_FRAMES), "--work", str(work),
             "--out", str(work / "table.txt"), "--device", "cpu"])
    return str(work), rows[0]


@pytest.mark.e2e
def test_collect_synthetic_split_table(protocol):
    work, row = protocol
    text = open(os.path.join(work, "table.txt")).read()
    for run in ("single", "agent0", "agent1"):
        line = next(x for x in text.splitlines() if x.startswith(run + " "))
        assert np.isfinite(float(line.split()[1])), line
    split = row["split"]
    assert (split["frames0"], split["frames1"]) == (6, 6)
    assert (f"trial0 split: maps={split['final_maps']} "
            f"fusions={split['fusions']} "
            f"relocs={split['relocalizations']} "
            f"resets={split['resets'][0]}/{split['resets'][1]}") in text
    assert split["resets"] == [0, 0]
    for a in (0, 1):
        assert re.search(rf"trial0 agent{a}: ate=\S+ .* "
                         rf"exported={row[f'agent{a}']['n']}/6", text)
        assert row[f"agent{a}"]["ate"] < 0.05
    assert row["agent0"]["n"] == 6 and row["agent1"]["n"] >= 3


def _jax_port_views(monkeypatch):
    """The JAX drivers' trackers take the port's repairs
    (torch_parity.port_views): they count their own map's keyframes at the
    two keyframe-count gates (fault 9) and age map points in their own
    agent's keyframes (fault 11; ROADMAP.md queue 3)."""
    real = JServer.register_client

    def register_client(self, agent):
        return port_views(self, real(self, agent))
    monkeypatch.setattr(JServer, "register_client", register_client)


@pytest.mark.e2e
def test_split_driver_matches_jax(protocol, tmp_path, monkeypatch):
    """The port's split against the JAX driver's with the port's repairs
    (port_views): the same summary, the same frames exported, camera
    centres within 2 mm, stats.csv with the same header and, row for row
    (one a fusion), the same keyframe and point counts of the two maps
    (the other columns are the packages' times)."""
    work, row = protocol
    out = os.path.join(work, "split0")
    _small_settings(monkeypatch)
    _jax_port_views(monkeypatch)
    seq = os.path.join(work, "seq0")
    want = jsplit.main(["-t", "stereo_synth", "-n", "2", "-d", seq,
                        "-s", os.path.join(seq, "settings.json"),
                        "-o", str(tmp_path)])
    got = {k: row["split"][k] for k in want}
    assert got == want and (want["final_maps"], want["fusions"]) == (1, 1)
    subs = datasets.load_synth_stereo(seq).split(2)
    _same_trajectories(out, str(tmp_path), [len(s) for s in subs])
    rows = [open(path).read().splitlines() for path in
            (os.path.join(out, "stats.csv"), tmp_path / "stats.csv")]
    assert rows[0][0] == rows[1][0] and len(rows[0]) == len(rows[1]) == 2
    header = rows[0][0].split(",")
    counts = [header.index(k) for k in ("ckf", "cmp", "mkf", "mmp")]
    for got_row, want_row in zip(rows[0][1:], rows[1][1:]):
        got_row, want_row = got_row.split(","), want_row.split(",")
        assert [got_row[i] for i in counts] == [want_row[i] for i in counts]


@pytest.mark.e2e
def test_split_gates_count_own_map(protocol, tmp_path, monkeypatch):
    """Fault 9, the deviation asserted: the JAX package's gates read the
    slot high-water mark, so its agent 1, which starts on a map of one
    keyframe while agent 0 has made two, gets no reference matches, makes no
    keyframe, loses track and resets: it exports 3 of its 6 frames. The
    port's gates count agent 1's own map: it exports all 6. Agent 0's
    frames are exported by both."""
    work, row = protocol
    _small_settings(monkeypatch)
    seq = os.path.join(work, "seq0")
    jsplit.main(["-t", "stereo_synth", "-n", "2", "-d", seq,
                 "-s", os.path.join(seq, "settings.json"),
                 "-o", str(tmp_path)])
    got = [ttraj.read_tum(os.path.join(work, "split0", f"SLAM{a}.txt"))
           for a in (0, 1)]
    want = [ttraj.read_tum(str(tmp_path / f"SLAM{a}.txt")) for a in (0, 1)]
    assert (len(want[0]), len(want[1])) == (6, 3)
    assert (len(got[0]), len(got[1])) == (6, 6)
    assert row["agent1"]["n"] == 6


def _same_trajectories(got_dir, want_dir, n_frames):
    """SLAM{a}.txt of both packages: the same frames exported, camera
    centres within 2 mm."""
    for a, n in enumerate(n_frames):
        got = ttraj.read_tum(os.path.join(got_dir, f"SLAM{a}.txt"))
        want = ttraj.read_tum(os.path.join(want_dir, f"SLAM{a}.txt"))
        np.testing.assert_array_equal(got[:, 0], want[:, 0])
        assert 0 < len(got) <= n
        assert np.abs(got[:, 1:4] - want[:, 1:4]).max() <= 2e-3


@pytest.mark.e2e
def test_two_seq_matches_jax(protocol, tmp_path, monkeypatch, capsys):
    work, _ = protocol
    seq = os.path.join(work, "seq0")
    _small_settings(monkeypatch)
    _jax_port_views(monkeypatch)
    argv = ["-t", "stereo_synth", "-d1", seq, "-d2", seq, "-s",
            os.path.join(seq, "settings.json"), "--max-frames", "6"]
    got = two_seq.main(argv + ["-o", str(tmp_path / "t"), "--device", "cpu"])
    capsys.readouterr()
    jtwo.main(argv + ["-o", str(tmp_path / "j")])
    printed = capsys.readouterr().out
    assert f"final maps: {got['final_maps']}, fusions: {got['fusions']}" \
        in printed
    assert (tmp_path / "t" / "stats.csv").is_file()
    _same_trajectories(str(tmp_path / "t"), str(tmp_path / "j"), [6, 6])


def test_write_fusion_stats_matches_jax(tmp_path):
    rng = np.random.default_rng(4)
    stats = [dict(sim3_ms=rng.uniform(1, 2000), mf_ms=rng.uniform(1, 500),
                  ckf=int(rng.integers(1, 90)), cmp=int(rng.integers(1, 9000)),
                  mkf=int(rng.integers(1, 90)), mmp=int(rng.integers(1, 9000)),
                  cd_ms=rng.uniform(1, 900), cd_sum_ms=rng.uniform(1, 900),
                  cd_mean_ms=rng.uniform(1, 9), cd_stdev_ms=rng.uniform(0, 1),
                  cd_med_ms=rng.uniform(1, 9), n_cd=int(rng.integers(0, 40)),
                  gba_ms=rng.uniform(1, 2000), cur_map=1, dst_map=0)
             for _ in range(3)]
    common.write_fusion_stats(str(tmp_path / "t.csv"), stats)
    jcommon.write_fusion_stats(str(tmp_path / "j.csv"), stats)
    text = (tmp_path / "t.csv").read_text()
    assert text == (tmp_path / "j.csv").read_text()
    assert text.splitlines()[0] == \
        "sim3,mf,ckf,cmp,mkf,mmp,cd,cdsum,cdmean,cdstdev,cdmed,gba"


def test_drivers_default_to_cuda(tmp_path):
    """Without --device the drivers ask for the CUDA device: on a machine
    without one they raise instead of carrying on on the CPU."""
    q, t = make_synth_seq.loop_trajectory(660, 1.0, 24.0, seed=0)
    make_synth_seq.write_sequence(str(tmp_path), 0, q[:2], t[:2],
                                  make_synth_seq.camera())
    argv = ["-t", "stereo_synth", "-s", str(tmp_path / "settings.json"),
            "-o", str(tmp_path / "out")]
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((AssertionError, RuntimeError)):
        generic_split_seq.main(argv + ["-n", "2", "-d", str(tmp_path)])
    with pytest.raises((AssertionError, RuntimeError)):
        two_seq.main(argv + ["-d1", str(tmp_path), "-d2", str(tmp_path)])


def _write_tum_rgbd(root, q_wc, t_wc, cam):
    """A TUM-layout RGB-D clip of the corridor (rgb.txt, depth.txt, 8-bit
    grey and 16-bit depth PNGs at the TUM factor 5000, 0 where there is no
    depth or it is beyond the 16-bit range), written from the renderer's
    left image and exact depth: test data for datasets.load_tum_rgbd."""
    import cv2
    from multiagent_orb_slam2_tpu_torch.io.synthetic import BoxScene
    scene = BoxScene(seed=0, z_far=30.0)
    os.makedirs(os.path.join(root, "rgb"))
    os.makedirs(os.path.join(root, "depth"))
    rgb, dep = [], []
    for i in range(len(q_wc)):
        left, _, depth = scene.render_stereo(cam, q_wc[i], t_wc[i])
        d = np.nan_to_num(depth, nan=0.0, posinf=0.0) * 5000.0
        d = np.where((d > 0) & (d < 65535), d, 0).astype(np.uint16)
        ts = f"{i / 10.0:.6f}"
        cv2.imwrite(os.path.join(root, "rgb", f"{i}.png"),
                    np.clip(left, 0, 255).astype(np.uint8))
        cv2.imwrite(os.path.join(root, "depth", f"{i}.png"), d)
        rgb.append(f"{ts} rgb/{i}.png")
        dep.append(f"{ts} depth/{i}.png")
    for name, rows in (("rgb.txt", rgb), ("depth.txt", dep)):
        with open(os.path.join(root, name), "w") as f:
            f.write("# written by the test\n" + "\n".join(rows) + "\n")
    return datasets.load_tum_rgbd(str(root))


@pytest.mark.parametrize("kind", ["mono_kitti", "rgbd_tum"])
def test_unported_sensors_raise(kind, tmp_path):
    """Mono and RGB-D sub-sequences, which raised NotImplementedError
    before the port had them, now run through run_server: two agents on 12
    frames of the corridor (6 an agent) at the small capacities. RGB-D: a
    TUM-layout clip of the first 12 frames' left images and the renderer's
    depth; every frame of both agents is tracked, and the two maps fuse at
    the hand-over (they ended apart before fault 11 was repaired). Mono:
    the left images of every third frame (the corridor's 3.6 cm a frame
    give too little parallax for two views); each agent keeps its first
    frame as the two-view reference, initializes from a later one and ends
    tracking on its own map (an agent that loses its young map resets and
    initializes again on a fresh map id, as the server does)."""
    n = 12
    q, t = make_synth_seq.loop_trajectory(660, 1.0, 24.0, seed=0)
    step = 3 if kind == "mono_kitti" else 1
    q, t = q[:step * n:step], t[:step * n:step]
    cam = make_synth_seq.camera()
    make_synth_seq.write_sequence(str(tmp_path / "seq"), 0, q, t, cam)
    if kind == "mono_kitti":
        seq = datasets.load_synth_stereo(str(tmp_path / "seq"))
        seq = datasets.Sequence([dataclasses.replace(it, right=None)
                                 for it in seq.items])
    else:
        seq = _write_tum_rgbd(tmp_path / "tum", q, t, cam)
    assert len(seq) == n
    out = tmp_path / "out"
    with pytest.MonkeyPatch.context() as mp:
        _small_settings(mp)
        server, summary = generic_split_seq.run_server(
            seq.split(2), kind, str(tmp_path / "seq" / "settings.json"), "",
            str(out), "cpu")
    assert (summary["final_maps"], summary["fusions"]) == \
        ((1, 1) if kind == "rgbd_tum" else (2, 0))
    st = server.shared.state
    for a in (0, 1):
        rows = ttraj.read_tum(str(out / f"SLAM{a}.txt"))
        tracker = server.trackers[a]
        assert tracker.state == 1
        if kind == "rgbd_tum":
            assert len(rows) == n // 2
        else:
            assert tracker.trajectory[0].lost and len(rows) >= 2
        mine = (st.kf_agent == a) & st.kf_valid
        assert int(mine.sum()) >= 2
        assert set(st.kf_map[mine].tolist()) == {tracker.map_id}
    assert (server.trackers[0].map_id == server.trackers[1].map_id) == \
        (kind == "rgbd_tum")
