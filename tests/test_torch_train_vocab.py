"""The port's drivers/train_vocab against the JAX driver on a tiny
synthetic clip (three 320x192 frames of the loop corridor, seed 0), the
same command line for both.

- The descriptors each driver trains on: the same count, and at least
  99 % of them the same (the port's ORB holds the JAX package's at the
  standing tolerance of ops/orb, a pyramid within 1e-3 grey levels; here
  1799 of 1800 rows are shared).
- The vocabulary: on the same descriptors (the JAX driver's) the port's
  training gives the JAX driver's file, every level's centroids and the
  idf weights equal to the bit; the port's file loads in the JAX package
  and the JAX one in the port.
- The driver runs on the CUDA device unless --device names another.
"""
import numpy as np
import pytest
import torch

from multiagent_orb_slam2_tpu.drivers import train_vocab as jtrain
from multiagent_orb_slam2_tpu.vocab import bow as jbow
from multiagent_orb_slam2_tpu_torch.analysis import make_synth_seq
from multiagent_orb_slam2_tpu_torch.drivers import train_vocab
from multiagent_orb_slam2_tpu_torch.vocab import bow as tbow


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    root = tmp_path_factory.mktemp("clip")
    q, t = make_synth_seq.loop_trajectory(660, 1.0, 24.0, seed=0)
    make_synth_seq.write_sequence(str(root), 0, q[:30:10], t[:30:10],
                                  make_synth_seq.camera(320, 192))
    return root


def _capture(monkeypatch, module, store):
    real = module.train_vocabulary

    def train(descs, **kw):
        store.append(np.array(descs))
        return real(descs, **kw)
    monkeypatch.setattr(module, "train_vocabulary", train)


def test_train_vocab_matches_jax(clip, tmp_path, monkeypatch):
    argv = ["-t", "stereo_synth", "-d", str(clip), "-s",
            str(clip / "settings.json"), "-k", "4", "--depth", "2",
            "--frames", "3"]
    seen_t, seen_j = [], []
    _capture(monkeypatch, tbow, seen_t)
    _capture(monkeypatch, jbow, seen_j)
    train_vocab.main(argv + ["-o", str(tmp_path / "t.npz"),
                             "--device", "cpu"])
    jtrain.main(argv + ["-o", str(tmp_path / "j.npz")])
    (dt,), (dj,) = seen_t, seen_j
    assert dt.dtype == dj.dtype == np.uint32 and dt.shape == dj.shape
    shared = set(map(bytes, dt)) & set(map(bytes, dj))
    assert len(shared) >= 0.99 * len(dj)

    monkeypatch.undo()
    tbow.save_vocabulary(tbow.train_vocabulary(dj, k=4, depth=2,
                                               device="cpu"),
                         str(tmp_path / "tj.npz"))
    with np.load(tmp_path / "tj.npz") as got, \
            np.load(tmp_path / "j.npz") as want:
        assert sorted(got.files) == sorted(want.files)
        for name in want.files:
            np.testing.assert_array_equal(got[name], want[name], name)
        assert got["level1"].shape == (16, 8)
    tv = tbow.load_vocabulary(str(tmp_path / "j.npz"), device="cpu")
    jv = jbow.load_vocabulary(str(tmp_path / "t.npz"))
    assert (tv.k, tv.depth) == (jv.k, jv.depth) == (4, 2)


def test_train_vocab_defaults_to_cuda(clip, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((AssertionError, RuntimeError)):
        train_vocab.main(["-t", "stereo_synth", "-d", str(clip), "-s",
                          str(clip / "settings.json"), "-o",
                          str(tmp_path / "v.npz"), "--frames", "1"])
