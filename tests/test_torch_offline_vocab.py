"""The port's analysis/train_offline_vocab against the JAX package's script
(analysis/train_offline_vocab.py at the repo root, imported by its file
path), on a corpus of 2 scenes x 3 frames (the scripts' scene seeds from
1000, their walks, 512x288, 600 ORB features).

- The corpus: the JAX script's build_corpus hands extract_frame uint8
  images, and the JAX FAST score then subtracts in uint8, which wraps
  (ROADMAP.md queue 3, fault 14): its keypoints are not the ones the JAX
  system extracts from the float32 images its drivers load. The port's
  script extracts as the system does (extract_frame converts to float32).
  Held against the JAX script with its images made float32 (a view of
  multiagent_orb_slam2_tpu.ops.frame.extract_frame for the call): the same
  count of descriptors within 1 %, at least 99 % of the JAX corpus shared
  with the port's (the port's ORB holds the JAX package's at the standing
  tolerance of ops/orb, a pyramid within 1e-3 grey levels; the walk's
  poses come from the port's so3_exp_quat). The deviation asserted: the
  JAX script as shipped shares less than 90 % (measured: 78 %). The walk's
  scene parameters are the JAX script's draws.
- The vocabulary: the port's script trained on the JAX corpus (given as its
  corpus cache) writes the JAX training's file, every level's centroids and
  the idf weights equal to the bit.
- An output path inside the JAX package, and the JAX script's corpus cache,
  are refused; the committed asset is untouched.
- The script runs extract_frame on the CUDA device unless --device names
  another: on a machine without one it raises.
"""
import hashlib
import importlib.util
import os
import pathlib

import numpy as np
import pytest
import torch

from multiagent_orb_slam2_tpu.vocab import bow as jbow
from multiagent_orb_slam2_tpu_torch.analysis import train_offline_vocab
from multiagent_orb_slam2_tpu_torch.vocab import bow as tbow

ROOT = pathlib.Path(__file__).resolve().parents[1]
SCENES, FRAMES = 2, 3


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_train_offline_vocab", ROOT / "analysis" / "train_offline_vocab.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def corpora():
    """(the JAX script's corpus from float32 images, as shipped, the
    port's, the port's extraction seconds)."""
    from multiagent_orb_slam2_tpu.ops import frame as jframe
    script = _jax_script()
    shipped = script.build_corpus(SCENES, FRAMES)
    real = jframe.extract_frame
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jframe, "extract_frame", lambda img, cfg, **kw: real(
            img.astype(np.float32), cfg, **kw))
        as_float = script.build_corpus(SCENES, FRAMES)
    tdescs, extract_s = train_offline_vocab.build_corpus(SCENES, FRAMES,
                                                         "cpu")
    return as_float, shipped, tdescs, extract_s


def _share(a, b):
    return len(set(map(bytes, a)) & set(map(bytes, b))) / len(b)


def test_corpus_matches_jax(corpora):
    jdescs, shipped, tdescs, extract_s = corpora
    assert jdescs.dtype == tdescs.dtype == shipped.dtype == np.uint32
    assert tdescs.shape[1] == 8 and extract_s > 0
    assert abs(len(tdescs) - len(jdescs)) <= 0.01 * len(jdescs)
    assert _share(tdescs, jdescs) >= 0.99
    assert _share(tdescs, shipped) < 0.9
    # the walk: the JAX script's draws, in its order
    params, poses = train_offline_vocab.scene_walk(1000, FRAMES)
    rng = np.random.default_rng(1000)
    assert params == {k: float(rng.uniform(lo, hi)) for k, (lo, hi) in (
        ("z_far", (15, 40)), ("half_w", (1.5, 4.0)), ("half_h", (1.0, 2.5)),
        ("tex_scale", (60, 200)))}
    assert len(poses) == FRAMES and poses[0][1][2] > 1.0


def test_vocabulary_exact_on_the_jax_corpus(corpora, tmp_path):
    jdescs = corpora[0]
    cache = tmp_path / "corpus.npy"
    np.save(cache, jdescs)
    out = tmp_path / "sub" / "vocab.npz"
    summary = train_offline_vocab.main(
        ["-o", str(out), "-k", "4", "--depth", "2", "--corpus-cache",
         str(cache), "--device", "cpu"])
    assert summary["descriptors"] == len(jdescs) and summary["words"] == 16
    jbow.save_vocabulary(jbow.train_vocabulary(jdescs, k=4, depth=2,
                                               seed=7),
                         str(tmp_path / "j.npz"))
    with np.load(out) as got, np.load(tmp_path / "j.npz") as want:
        assert sorted(got.files) == sorted(want.files)
        for name in want.files:
            np.testing.assert_array_equal(got[name], want[name], name)
    assert tbow.load_vocabulary(str(out), device="cpu").n_words == 16


def test_refuses_the_jax_package(tmp_path):
    asset = pathlib.Path(tbow.DEFAULT_VOCAB)
    digest = hashlib.sha256(asset.read_bytes()).hexdigest()
    for path in (asset, asset.parent / "new.npz",
                 ROOT / "multiagent_orb_slam2_tpu"):
        with pytest.raises(SystemExit, match="inside the JAX package"):
            train_offline_vocab.main(["-o", str(path), "--device", "cpu"])
    with pytest.raises(SystemExit, match="corpus cache"):
        train_offline_vocab.main(["-o", str(tmp_path / "v.npz"),
                                  "--corpus-cache", "/tmp/vocab_corpus.npy",
                                  "--device", "cpu"])
    assert hashlib.sha256(asset.read_bytes()).hexdigest() == digest
    assert not (asset.parent / "new.npz").exists()
    assert not os.path.exists(tmp_path / "v.npz")


def test_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((AssertionError, RuntimeError)):
        train_offline_vocab.main(["-o", str(tmp_path / "v.npz"),
                                  "--scenes", "1", "--frames-per-scene",
                                  "1"])
