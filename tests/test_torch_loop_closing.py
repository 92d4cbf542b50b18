"""The port's loop closing against the JAX package's.

- The jax-free fixture builders of tests/torch_loop_cases.py against the
  JAX ones at a small size: integers equal, floats within 1e-5 (relative
  above 1).
- Detection (database insert, minScore scan, candidate query, consistency
  groups, recall log) keyframe by keyframe on a converted ring: word tables,
  candidate masks and log rows equal.
- compute_sim3 + correct_loop(run_gba=True) on build_drifted_loop. The port
  draws RANSAC samples with its own generator, so outcomes are compared: the
  same accept, s / q / t within 1e-3, every keyframe pose within 2 mm after
  the essential graph. Global BA is compared by its outcome (ROADMAP.md queue
  3): the query keyframe within 2 mm of the JAX result, the JAX test's drift
  bounds, and the mean keyframe error against ground truth within 10 % of
  the JAX package's.
- A front-door detection run of the port on a 40-keyframe ring.
- The System with a vocabulary (loop closing and global BA on, the default)
  against the JAX System over 12 corridor frames: the keyframe databases
  equal, no loop in either.
"""
import json

import numpy as np
import pytest
import torch

torch.set_num_threads(1)   # several test workers share few cores

import test_loop_closing as jlc
import torch_loop_cases as tlc
from multiagent_orb_slam2_tpu.config import Capacities as JCaps
from multiagent_orb_slam2_tpu.runtime import loop_closing as jlcm
from multiagent_orb_slam2_tpu.runtime.tracker import SharedMap as JShared
from multiagent_orb_slam2_tpu.utils import diag as jdiag
from multiagent_orb_slam2_tpu.vocab import bow as jbow
from multiagent_orb_slam2_tpu_torch import convert
from multiagent_orb_slam2_tpu_torch.config import Capacities, LoopConfig
from multiagent_orb_slam2_tpu_torch.geometry import se3
from multiagent_orb_slam2_tpu_torch.runtime import loop_closing as tlcm
from multiagent_orb_slam2_tpu_torch.utils import diag as tdiag
from multiagent_orb_slam2_tpu_torch.vocab import bow as tbow

from torch_parity import jax_fields, jax_state_from_torch

RING_CAPS = dict(max_keyframes=64, max_points=8192, max_features=256,
                 local_points=2048)


def _vocabs(seed, n):
    corpus = np.random.default_rng(seed).integers(0, 2**32, (n, 8),
                                                  dtype=np.uint32)
    return (jbow.train_vocabulary(corpus, k=6, depth=3),
            tbow.train_vocabulary(corpus, k=6, depth=3, device="cpu"))


def _jax_shared(cfg, tshared):
    """The JAX package's SharedMap holding the port's map."""
    js = JShared(cfg)
    js.state = jax_state_from_torch(tshared.state)
    js.n_kf, js.n_mp, js.n_created = (tshared.n_kf, tshared.n_mp,
                                      tshared.n_created)
    js.kf_uid[:] = tshared.kf_uid
    js.uid_slot = dict(tshared.uid_slot)
    return js


def _assert_states_close(jstate, tstate):
    got = convert.map_state_to_numpy(tstate)
    for name, want in jax_fields(jstate).items():
        if want.dtype.kind == "f":
            np.testing.assert_allclose(got[name], want, rtol=1e-5, atol=1e-5,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(got[name], want, err_msg=name)


@pytest.mark.parametrize("which", ["loop", "ring"])
def test_fixture_builders_match_jax(which):
    if which == "loop":
        jsh, jgt, jdesc = jlc.build_drifted_loop(n_kf=5, n_pts_per=30)
        tsh, tgt, tdesc = tlc.build_drifted_loop(n_kf=5, n_pts_per=30)
        np.testing.assert_array_equal(tdesc, jdesc)
    else:
        jsh, jgt = jlc.build_drifted_ring(n_kf=8, n_rev=2, n_pts_per=30)
        tsh, tgt = tlc.build_drifted_ring(n_kf=8, n_rev=2, n_pts_per=30)
        np.testing.assert_array_equal(tsh.kf_uid, jsh.kf_uid)
        assert tsh.uid_slot == jsh.uid_slot
        assert tsh.n_created == jsh.n_created
    for a, b in zip(tgt, jgt):
        np.testing.assert_allclose(np.stack(a), np.stack(b), atol=1e-6)
    assert (tsh.n_kf, tsh.n_mp) == (jsh.n_kf, jsh.n_mp)
    _assert_states_close(jsh.state, tsh.state)


def _read_rows(sink):
    sink.f.flush()
    with open(sink.path) as f:
        return [json.loads(line) for line in f]


def test_detection_matches_jax(tmp_path, monkeypatch):
    """Keyframe by keyframe on a 12-keyframe ring: the database insert and
    candidate query (one program in both packages), then the consistency
    groups, with the recall log on: the same word tables, candidate masks,
    consistent candidates and log rows."""
    jv, tv = _vocabs(11, 3000)
    cfg = tlc.CFG.replace(caps=Capacities(**RING_CAPS))
    jcfg = jlc.CFG.replace(caps=JCaps(**RING_CAPS))
    tsh, _ = tlc.build_drifted_ring(n_kf=12, n_rev=3, drift=0.01, cfg=cfg)
    jsh = _jax_shared(jcfg, tsh)
    jcl, tcl = jlcm.LoopCloser(jcfg, jv), tlcm.LoopCloser(cfg, tv)
    sinks = []
    for mod, name in ((jdiag, "j.jsonl"), (tdiag, "t.jsonl")):
        monkeypatch.setenv("SLAM_RECALL_LOG", str(tmp_path / name))
        monkeypatch.setattr(mod, "_recall_sink", None)
        sinks.append(mod.recall_sink())
    for k in range(12):
        jcl.db, jc, jw, jvld, jvec = jlcm._detect_loop_query(
            jcl.db, jv, jsh.state, k, 15)
        tcl.db, tc, tw, tvld, tvec = tlcm._detect_loop_query(
            tcl.db, tv, tsh.state, k, 15)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
        np.testing.assert_allclose(tvec.numpy(), np.asarray(jvec), atol=1e-6)
        got = convert.kfdb_to_numpy(tcl.db)
        np.testing.assert_array_equal(got["words"], np.asarray(jcl.db.words))
        np.testing.assert_allclose(got["wts"], np.asarray(jcl.db.wts),
                                   atol=1e-6)
        assert jcl._detect(jsh, k, jc, jw, jvld, jvec) == \
            tcl._detect(tsh, k, tc, tw, tvld, tvec)
    jrows, trows = (_read_rows(s) for s in sinks)
    assert len(trows) == len(jrows) == 12
    assert any(r["cand_pre"] for r in trows)
    for jr, tr in zip(jrows, trows):
        for a, b in zip(jr.pop("top_cross"), tr.pop("top_cross")):
            assert (a["kf"], a["common"]) == (b["kf"], b["common"])
            assert abs(a["score"] - b["score"]) <= 1e-4
        assert jr == tr


def _kf_centres(state):
    qwc, twc = se3.inverse(torch.as_tensor(np.asarray(state.kf_q)),
                           torch.as_tensor(np.asarray(state.kf_t)))
    return twc.numpy()


def test_compute_sim3_and_correct_loop_match_jax(monkeypatch):
    tsh, (_, ts_gt), _ = tlc.build_drifted_loop()
    jsh = _jax_shared(jlc.CFG, tsh)
    jv, tv = _vocabs(9, 2000)
    jcl, tcl = jlcm.LoopCloser(jlc.CFG, jv), tlcm.LoopCloser(tlc.CFG, tv)
    last = tsh.n_kf - 1
    ts_gt = np.stack(ts_gt)

    def errs(state):
        return np.linalg.norm(_kf_centres(state)[:tsh.n_kf] - ts_gt, axis=1)

    err_before = errs(tsh.state)[last]
    assert err_before > 0.05

    jm = jcl.compute_sim3(jsh, last, 0)
    tm = tcl.compute_sim3(tsh, last, 0)
    assert jm is not None and tm is not None
    assert (tm.kf_query, tm.kf_match) == (jm.kf_query, jm.kf_match)
    np.testing.assert_allclose(tm.s, jm.s, atol=1e-3)
    np.testing.assert_allclose(tm.q, np.asarray(jm.q), atol=1e-3)
    np.testing.assert_allclose(tm.t, np.asarray(jm.t), atol=1e-3)
    np.testing.assert_array_equal(tm.point_ids.numpy(),
                                  np.asarray(jm.point_ids))

    # the map as it enters global BA, in both packages
    before_gba = {}
    for mod, key in ((jlcm, "jax"), (tlcm, "torch")):
        real = mod.global_bundle_adjustment

        def keep(st, cfg, n_iters=None, real=real, key=key):
            before_gba[key] = st
            return real(st, cfg, n_iters)
        monkeypatch.setattr(mod, "global_bundle_adjustment", keep)
    jcl.correct_loop(jsh, jm, run_gba=True)
    tcl.correct_loop(tsh, tm, run_gba=True)
    np.testing.assert_allclose(_kf_centres(before_gba["torch"]),
                               _kf_centres(before_gba["jax"]), atol=2e-3)
    np.testing.assert_allclose(before_gba["torch"].kf_q.numpy(),
                               np.asarray(before_gba["jax"].kf_q), atol=2e-3)

    # after global BA: outcomes
    ej, et = errs(jsh.state), errs(tsh.state)
    assert abs(et[last] - ej[last]) < 2e-3
    assert et[last] < err_before * 0.6 and et[last] < 0.035
    assert et.mean() <= 1.1 * ej.mean(), (et.mean(), ej.mean())


def test_loop_detected_through_front_door():
    """The port's own detection on a 40-keyframe ring with a 5-keyframe
    revisit tail and the reference thresholds (consistency 3, refractory
    10): the loop is found on a revisit keyframe against an early one, the
    corrected query keyframe snaps onto the revisited place, the tail and
    the mean error improve. The JAX package on the same ring finds the same
    loop (37 against 2) and improves the tail by the same 23 %; the 25 % of
    its 110-keyframe test belongs to that longer ring."""
    cfg = tlc.CFG.replace(caps=Capacities(**RING_CAPS), loop=LoopConfig())
    n_kf, n_rev = 40, 5
    shared, (_, ts_gt) = tlc.build_drifted_ring(n_kf=n_kf, n_rev=n_rev,
                                                drift=0.01, cfg=cfg)
    _, vocab = _vocabs(11, 3000)
    closer = tlcm.LoopCloser(cfg, vocab)
    ts_gt = np.stack(ts_gt)

    def errs():
        return np.linalg.norm(_kf_centres(shared.state)[:n_kf] - ts_gt,
                              axis=1)

    before = errs()
    matches = []
    for k in range(n_kf):
        m = closer.process_keyframe(shared, k)
        if m is not None:
            matches.append(m)
            closer.correct_loop(shared, m, run_gba=True)
    assert matches, "no loop detected through the front door"
    assert matches[0].kf_query >= n_kf - n_rev, matches[0]
    assert matches[0].kf_match <= 8, matches[0]
    after = errs()
    assert after[matches[0].kf_query] < 0.02
    assert after[-1] < before[-1] * 0.8, (before[-1], after[-1])
    assert after.mean() < before.mean(), (before.mean(), after.mean())


@pytest.mark.e2e
def test_system_with_vocabulary_matches_jax():
    """Both Systems as they are built by default (loop closing and global BA
    on) with one small vocabulary trained on the first frame's descriptors,
    12 corridor frames on features extracted once by the JAX package: the
    keyframe databases equal (words, weights within 1e-6, active rows), the
    same keyframes, no loop in either."""
    import jax.numpy as jnp
    from multiagent_orb_slam2_tpu.ops import frame as jframe
    from multiagent_orb_slam2_tpu.runtime import system as jsys
    from multiagent_orb_slam2_tpu.vocab import bow as jbow
    from multiagent_orb_slam2_tpu_torch.runtime import system as tsys
    from multiagent_orb_slam2_tpu_torch.runtime import tracker as ttr
    from torch_parity import CFG, TCFG, sequence, torch_feats_from_jax

    frames, _ = sequence(12)
    feats = [jframe.extract_frame(jnp.asarray(left), CFG,
                                  right_img=jnp.asarray(right))
             for left, right in frames]
    f0 = feats[0]
    corpus = np.asarray(f0.desc)[np.asarray(f0.valid)]
    jv = jbow.train_vocabulary(corpus, k=6, depth=3)
    tv = tbow.train_vocabulary(corpus, k=6, depth=3, device="cpu")
    js = jsys.System(CFG, jv)
    ts = tsys.System(TCFG, tv, device="cpu")
    for i, f in enumerate(feats):
        js._track(f, i)
        ts._track(torch_feats_from_jax(f), i)
        assert ts.tracker.state == js.tracker.state == ttr.TrackerState.OK
    assert ts.shared.n_created == js.shared.n_created >= 2
    jdb, tdb = js.loop_closer.db, convert.kfdb_to_numpy(ts.loop_closer.db)
    np.testing.assert_array_equal(tdb["active"], np.asarray(jdb.active))
    assert tdb["active"].sum() == len(ts.shared.uid_slot)   # live ones
    np.testing.assert_array_equal(tdb["words"], np.asarray(jdb.words))
    np.testing.assert_allclose(tdb["wts"], np.asarray(jdb.wts), atol=1e-6)
    assert ts.loop_closer.loop_edges == js.loop_closer.loop_edges == []
