"""The port's five-trial protocol (analysis/collect_results, the
counterpart of the JAX package's analysis/collect_results.sh) and the
protocol table at more than two agents (analysis/collect_synthetic
--agents), on the CPU at small capacities (substituted into the settings
as tests/test_torch_split_driver.py does).

- collect_synthetic --agents 3 over one trial of the loop corridor's first
  12 frames (seed 0, 512x288): run_single and generic_split_seq -n 3 (4
  frames an agent); the table has the single row, one "n3 agent<a>" row
  for each agent with a finite ATE, each agent's exported frames out of 4,
  and the trial's "n3 split" line with the final maps, fusions,
  relocalizations and every agent's resets (none); the trial's rows are in
  WORK/trial0.json, with each run's kernel launches (none on the CPU).
- The table rebuilt from per-trial JSON files written by two calls over one
  work directory (--only 0 1, then --only 2) equals the table of one call
  making all three trials, byte for byte, "trials completed: 3/3"; the
  table of the first call alone reads 2/3. The trials' rows are canned
  here (run_trial replaced): what is held is the files and the rebuild.
  Each file records the protocol (--agents, --frames); a later call with
  other values refuses the file and writes nothing. --trials defaults to
  the protocol's five.
- collect_results: the driver arguments with -o OUT run generic_split_seq
  five times, into OUT/trial0..4, each with its SLAM0.txt, SLAM1.txt and
  stats.csv; the five summaries are returned. Without -o it refuses.
"""
import json
import os
import re

import numpy as np
import pytest
import torch

from multiagent_orb_slam2_tpu_torch.analysis import (collect_results,
                                                     collect_synthetic,
                                                     make_synth_seq)
from multiagent_orb_slam2_tpu_torch.config import Capacities
from multiagent_orb_slam2_tpu_torch.drivers import common

torch.set_num_threads(1)   # several test workers share few cores

N_FRAMES = 12
SMALL = dict(max_keyframes=16, max_points=8192, max_features=1024,
             local_points=4096)


def _small_settings(mp):
    real = common.load_settings
    mp.setattr(common, "load_settings", lambda p, s: real(p, s)
               .replace(caps=Capacities(**SMALL)))


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """The corridor's first 12 frames as trial 0's sequence."""
    work = tmp_path_factory.mktemp("protocol")
    q, t = make_synth_seq.loop_trajectory(660, 1.0, 24.0, seed=0)
    make_synth_seq.write_sequence(str(work / "seq0"), 0, q[:N_FRAMES],
                                  t[:N_FRAMES], make_synth_seq.camera())
    return work


@pytest.mark.e2e
def test_three_agent_table(work):
    with pytest.MonkeyPatch.context() as mp:
        _small_settings(mp)
        rows = collect_synthetic.main(
            ["--trials", "1", "--agents", "3", "--frames", str(N_FRAMES),
             "--work", str(work), "--out", str(work / "table.txt"),
             "--device", "cpu"])
    (row,) = rows
    text = (work / "table.txt").read_text()
    assert "trials completed: 1/1" in text and "# device: cpu" in text
    split = row["n3"]["split"]
    assert [split[f"frames{a}"] for a in range(3)] == [4, 4, 4]
    assert split["resets"] == [0, 0, 0]
    assert (f"trial0 n3 split: maps={split['final_maps']} "
            f"fusions={split['fusions']} relocs={split['relocalizations']} "
            f"resets=0/0/0") in text
    for a in range(3):
        r = row["n3"][f"agent{a}"]
        line = next(x for x in text.splitlines()
                    if x.startswith(f"n3 agent{a} "))
        assert np.isfinite(float(line.split()[2])), line
        assert re.search(rf"trial0 n3 agent{a}: ate=\S+ .* "
                         rf"exported={r['n']}/4", text)
        assert r["ate"] < 0.05
    assert "split" not in row and not any(
        x.startswith("agent0 ") for x in text.splitlines())
    assert os.path.isfile(work / "trial0.json")
    assert row["launches"] == {run: {"pose_opt": 0, "ba_prep": 0, "pcg": 0}
                               for run in ("single", "split_n3")}


def _canned(trial, work, frames, vocab_path, workers=1, device="cuda",
            agents=(2,)):
    rng = np.random.default_rng(trial)

    def acc():
        return dict(n=int(rng.integers(300, 331)), **{
            k: float(rng.uniform(0.01, 0.1)) for k in (
                "ate", "ate_rmse", "rpe_t", "rpe_t_per_m", "rpe_r",
                "scale")})
    row = {"trial": trial, "single": acc(), "meta": dict(
        frames=660, lost=0, relocalizations=trial, loops_corrected=1,
        resets=0)}
    for n in agents:
        runs = {"split": dict(final_maps=1, fusions=n - 1,
                              relocalizations=trial, resets=[0] * n,
                              **{f"frames{a}": 660 // n for a in range(n)})}
        runs.update({f"agent{a}": acc() for a in range(n)})
        if n == 2:
            row.update(runs)
        else:
            row[f"n{n}"] = runs
    return row


def test_table_rebuilt_from_trial_files(tmp_path, monkeypatch):
    monkeypatch.setattr(collect_synthetic, "run_trial", _canned)
    argv = ["--trials", "3", "--agents", "2", "3", "4", "--device", "cpu"]
    one = collect_synthetic.main(argv + ["--work", str(tmp_path / "one"),
                                         "--out", str(tmp_path / "one.txt")])
    collect_synthetic.main(argv + ["--only", "0", "1", "--work",
                                   str(tmp_path / "two"), "--out",
                                   str(tmp_path / "first.txt")])
    assert "trials completed: 2/3" in (tmp_path / "first.txt").read_text()
    two = collect_synthetic.main(argv + ["--only", "2", "--work",
                                         str(tmp_path / "two"), "--out",
                                         str(tmp_path / "two.txt")])
    assert one == two and len(one) == 3
    text = (tmp_path / "one.txt").read_text()
    assert text == (tmp_path / "two.txt").read_text()
    assert "trials completed: 3/3" in text
    lines = text.splitlines()
    start = next(i for i, x in enumerate(lines) if x.startswith("run "))
    names = [" ".join(x.split()[:2 if x.startswith("n") else 1])
             for x in lines[start + 1:lines.index("", start)]]
    assert names == ["single", "agent0", "agent1", "n3 agent0", "n3 agent1",
                     "n3 agent2", "n4 agent0", "n4 agent1", "n4 agent2",
                     "n4 agent3"]
    assert "trial2 n4 split: maps=1 fusions=3 relocs=2 resets=0/0/0/0" \
        in text


@pytest.mark.parametrize("other", [("--agents", "2", "3"),
                                   ("--frames", "330")])
def test_trial_files_of_another_protocol_refused(tmp_path, monkeypatch,
                                                 other):
    monkeypatch.setattr(collect_synthetic, "run_trial", _canned)
    argv = ["--trials", "2", "--agents", "2", "3", "4", "--device", "cpu",
            "--work", str(tmp_path), "--out", str(tmp_path / "table.txt")]
    collect_synthetic.main(argv + ["--only", "0"])
    row = json.loads((tmp_path / "trial0.json").read_text())
    assert (row["agents"], row["frames"]) == ([2, 3, 4], 660)
    before = (tmp_path / "table.txt").read_text()
    with pytest.raises(SystemExit, match="trial0.json was made with"):
        collect_synthetic.main(argv + list(other) + ["--only", "1"])
    assert not (tmp_path / "trial1.json").exists()
    assert (tmp_path / "table.txt").read_text() == before


def test_five_trials_by_default(tmp_path, monkeypatch):
    monkeypatch.setattr(collect_synthetic, "run_trial", _canned)
    rows = collect_synthetic.main(["--device", "cpu", "--work",
                                   str(tmp_path), "--out",
                                   str(tmp_path / "table.txt")])
    assert len(rows) == collect_results.TRIALS == 5
    assert "trials completed: 5/5" in (tmp_path / "table.txt").read_text()


def test_collect_results_five_trials(work, tmp_path, capsys):
    seq = str(work / "seq0")
    argv = ["-t", "stereo_synth", "-n", "2", "-d", seq, "-s",
            os.path.join(seq, "settings.json"), "--max-frames", "2",
            "--device", "cpu", "-o", str(tmp_path / "out")]
    with pytest.MonkeyPatch.context() as mp:
        _small_settings(mp)
        summaries = collect_results.main(argv)
    assert len(summaries) == collect_results.TRIALS == 5
    assert sorted(os.listdir(tmp_path / "out")) == [f"trial{t}"
                                                   for t in range(5)]
    for t in range(5):
        for name in ("SLAM0.txt", "SLAM1.txt", "stats.csv"):
            assert os.path.isfile(tmp_path / "out" / f"trial{t}" / name)
    assert all(s == summaries[0] for s in summaries)
    assert "collected 5 trials" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="need -o"):
        collect_results.main(argv[:-2])
