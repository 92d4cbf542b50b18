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
  driver's. A clip this short ends with two maps in both packages (fusion
  needs the corridor's revisit).
- two_seq on two 6-frame sequences: the same outputs as the JAX driver's,
  and final maps and fusions equal to what it prints.
- write_fusion_stats: the same file as the JAX package's for the same
  stats rows.
- The drivers run on the CUDA device unless the caller passes another: on
  a machine without one they raise, and mono / RGB-D sub-sequences reach
  the NotImplementedError that names ROADMAP.md queue 1 item 13.
"""
import os
import re

import numpy as np
import pytest
import torch

from multiagent_orb_slam2_tpu import config as jconfig
from multiagent_orb_slam2_tpu.drivers import common as jcommon
from multiagent_orb_slam2_tpu.drivers import generic_split_seq as jsplit
from multiagent_orb_slam2_tpu.drivers import two_seq as jtwo
from multiagent_orb_slam2_tpu_torch.analysis import (collect_synthetic,
                                                     make_synth_seq)
from multiagent_orb_slam2_tpu_torch.config import Capacities
from multiagent_orb_slam2_tpu_torch.drivers import common
from multiagent_orb_slam2_tpu_torch.drivers import generic_split_seq
from multiagent_orb_slam2_tpu_torch.drivers import two_seq
from multiagent_orb_slam2_tpu_torch.io import datasets
from multiagent_orb_slam2_tpu_torch.io import trajectory as ttraj

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
            f"relocs={split['relocalizations']}") in text
    for a in (0, 1):
        assert re.search(rf"trial0 agent{a}: ate=\S+ .* "
                         rf"exported={row[f'agent{a}']['n']}/6", text)
        assert row[f"agent{a}"]["ate"] < 0.05
    assert row["agent0"]["n"] == 6 and row["agent1"]["n"] >= 3


@pytest.mark.e2e
def test_split_driver_matches_jax(protocol, tmp_path, monkeypatch):
    work, row = protocol
    out = os.path.join(work, "split0")
    _small_settings(monkeypatch)
    seq = os.path.join(work, "seq0")
    want = jsplit.main(["-t", "stereo_synth", "-n", "2", "-d", seq,
                        "-s", os.path.join(seq, "settings.json"),
                        "-o", str(tmp_path)])
    got = {k: row["split"][k] for k in want}
    assert got == want and want["final_maps"] == 2
    subs = datasets.load_synth_stereo(seq).split(2)
    _same_trajectories(out, str(tmp_path), [len(s) for s in subs])
    assert open(os.path.join(out, "stats.csv")).read() == \
        open(tmp_path / "stats.csv").read()


def _same_trajectories(got_dir, want_dir, n_frames):
    """SLAM{a}.txt of both packages: the same frames exported (agent 1 of
    a split loses its first frames in both: the tracker's minimum-
    observation gate counts every agent's keyframes, ROADMAP.md queue 3),
    camera centres within 2 mm."""
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


@pytest.mark.parametrize("kind", ["mono_kitti", "rgbd_tum"])
def test_unported_sensors_raise(kind, tmp_path):
    q, t = make_synth_seq.loop_trajectory(660, 1.0, 24.0, seed=0)
    make_synth_seq.write_sequence(str(tmp_path), 0, q[:2], t[:2],
                                  make_synth_seq.camera())
    seq = datasets.load_synth_stereo(str(tmp_path))
    with pytest.raises(NotImplementedError, match="item 13"):
        generic_split_seq.run_server(
            seq.split(2), kind, str(tmp_path / "settings.json"), "",
            str(tmp_path / "out"), "cpu")
