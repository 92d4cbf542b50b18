"""Host-side behaviour of the port: System facade, the paths later slices
ported (each checked in place of the NotImplementedError it raised), slot
bookkeeping, point compaction, reset, the small tensor helpers, and the
tracker with local bundle adjustment against the JAX tracker."""
import dataclasses
import inspect

import numpy as np
import pytest
import torch

from multiagent_orb_slam2_tpu_torch import config as tconfig
from multiagent_orb_slam2_tpu_torch import convert
from multiagent_orb_slam2_tpu_torch.io import trajectory as ttraj
from multiagent_orb_slam2_tpu_torch.runtime import system as tsys
from multiagent_orb_slam2_tpu_torch.runtime import tracker as ttr
from multiagent_orb_slam2_tpu_torch.utils import torch_ops as ops
from multiagent_orb_slam2_tpu_torch.vocab import bow as tbow

from torch_parity import CFG, TCFG, sequence


def test_config_from_dict_equals_jax_config():
    assert dataclasses.asdict(TCFG) == dataclasses.asdict(CFG)
    assert tuple(TCFG.camera) == tuple(CFG.camera)
    assert TCFG.orb.level_budgets == CFG.orb.level_budgets
    d = dataclasses.asdict(CFG)       # the camera NamedTuple survives asdict
    assert convert.config_from_dict(d).camera == TCFG.camera
    y = tconfig.from_yaml_dict({"Camera.fx": 1, "Camera.fy": 2, "Camera.cx": 3,
                                "Camera.cy": 4, "Camera.bf": 5})
    assert y.camera.bf == 5.0 and y.orb.n_features == 1000


@pytest.mark.parametrize("what", ["local_ba", "loop_closing", "vocab",
                                  "localization", "mono_sensor", "rgbd",
                                  "track_mono", "save_map"])
def test_unported_paths_raise(what, tmp_path):
    """Every path that once raised NotImplementedError for a later slice,
    now ported: each case checks the ported behaviour."""
    shared = ttr.SharedMap(TCFG, device="cpu")
    if what == "save_map":
        # ported: a checkpoint of a map (two keyframes, points) restores
        # every field and the slot counters
        system = tsys.System(TCFG, None, enable_loop_closing=False,
                             device="cpu")
        frames, _ = sequence(12)
        for i, (left, right) in enumerate(frames[:2]):
            system.track_stereo(left, right, frame_id=i)
        system.save_map(str(tmp_path / "map.npz"))
        restored = tsys.System(TCFG, None, enable_loop_closing=False,
                               device="cpu")
        restored.load_map(str(tmp_path / "map.npz"))
        for name, a in system.shared.state._asdict().items():
            assert torch.equal(getattr(restored.shared.state, name), a), name
        assert (restored.shared.n_kf, restored.shared.n_mp,
                restored.shared.n_created) == (system.shared.n_kf,
                                               system.shared.n_mp,
                                               system.shared.n_created)
        return
    if what == "local_ba":
        # ported: local BA is the default of Tracker and System, as in the
        # JAX package, and System has no argument to turn it off
        assert ttr.Tracker(TCFG, shared, device="cpu").run_local_ba is True
        system = tsys.System(TCFG, None, enable_loop_closing=False,
                             device="cpu")
        assert system.tracker.run_local_ba is True
        assert "run_local_ba" not in inspect.signature(
            tsys.System.__init__).parameters
        return
    if what in ("loop_closing", "vocab"):
        # ported: loop closing with global BA is the System default, as in
        # the JAX package; a vocabulary fills the keyframe database
        vocab = tbow.train_vocabulary(
            np.random.default_rng(0).integers(0, 2**32, (500, 8),
                                              dtype=np.uint32),
            k=4, depth=2, device="cpu")
        params = inspect.signature(tsys.System.__init__).parameters
        assert params["enable_loop_closing"].default is True
        assert params["run_gba"].default is True
        if what == "loop_closing":
            system = tsys.System(TCFG, vocab, device="cpu")
            assert system.enable_loop_closing and system.run_gba
            assert system.loop_closer.vocab is vocab
            with pytest.raises(ValueError, match="vocabulary"):
                tsys.System(TCFG, None, device="cpu")
            return
        # loop closing off: new keyframes are registered all the same,
        # culled ones erased before their slots are reused
        system = tsys.System(TCFG, vocab, enable_loop_closing=False,
                             device="cpu")
        slot = system.shared.alloc_kf()
        system.tracker.new_kf_slots.append(slot)
        system._process_keyframes()
        assert bool(system.loop_closer.db.active[slot])
        system.shared.note_culled(slot, None, None, None)
        system.tracker.culled_kf_slots.append(slot)
        system._process_keyframes()
        assert not bool(system.loop_closer.db.active[slot])
        assert system.shared.free_kf == [slot]
        return
    frames, (q_wc, t_wc) = sequence(12)
    if what == "localization":
        # ported: a map of two frames stays as it is while a third frame is
        # tracked in localization mode; leaving the mode drops the VO state
        tracker = ttr.Tracker(TCFG, shared, device="cpu")
        for i, (left, right) in enumerate(frames[:2]):
            tracker.track_stereo(left, right, frame_id=i)
        before = shared.state
        tracker.set_localization_mode(True)
        assert tracker.track_stereo(*frames[2], frame_id=2) is not None
        assert tracker.last_vo_mask is not None
        for name, a in before._asdict().items():
            if name not in ("mp_visible", "mp_found"):
                assert torch.equal(getattr(shared.state, name), a), name
        tracker.set_localization_mode(False)
        assert tracker.last_vo_pw is None and not tracker.only_tracking
    elif what == "mono_sensor":
        # ported: a monocular tracker keeps its first frame as the two-view
        # reference and makes no keyframe from it
        mcfg = TCFG.replace(sensor=tconfig.Sensor.MONOCULAR)
        tracker = ttr.Tracker(mcfg, shared, run_local_ba=False, device="cpu")
        assert tracker.track_mono(frames[0][0], frame_id=0) is None
        assert tracker.state == ttr.TrackerState.NOT_INITIALIZED
        assert tracker.mono_init_ref[1] == 0 and shared.n_kf == 0
    elif what == "rgbd":
        # ported: the first RGB-D frame makes the first keyframe, a map
        # point for every feature with depth
        from multiagent_orb_slam2_tpu_torch.io.synthetic import BoxScene
        depth = BoxScene(seed=7, z_far=40.0).render_stereo(
            TCFG.camera, q_wc[0], t_wc[0])[2]
        system = tsys.System(TCFG.replace(sensor=tconfig.Sensor.RGBD), None,
                             enable_loop_closing=False, device="cpu")
        assert system.track_rgbd(frames[0][0], depth, frame_id=0) is not None
        st = system.shared.state
        assert system.shared.n_kf == 1 and bool(st.kf_valid[0])
        assert system.shared.n_mp == int((st.kf_depth[0] > 0).sum()) > 100
    else:
        # ported: System.track_mono stores the reference frame, then
        # initializes from two views or keeps waiting, never raising
        system = tsys.System(TCFG.replace(sensor=tconfig.Sensor.MONOCULAR),
                             None, enable_loop_closing=False, device="cpu")
        assert system.track_mono(frames[0][0], frame_id=0) is None
        out = system.track_mono(frames[3][0], frame_id=3)
        if out is None:
            assert system.tracker.mono_init_ref is not None
        else:
            assert system.shared.n_kf == 2


def test_default_device_is_cuda_and_never_falls_back():
    """Entry points default to the card; without one they fail."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises((RuntimeError, AssertionError)):
        ttr.SharedMap(TCFG)


@pytest.mark.e2e
def test_system_tracks_and_exports(tmp_path):
    frames, (q_gt, t_gt) = sequence(12)
    system = tsys.System(TCFG, None, enable_loop_closing=False, device="cpu")
    ops.reset_host_fetch_count()
    for i, (left, right) in enumerate(frames[:5]):
        assert system.track_stereo(left, right, frame_id=i) is not None
    # a fixed, small number of host reads per frame (two in the cascade, one
    # pose snapshot; a keyframe adds its neighbour list and point count)
    assert ops.host_fetch_count() <= 5 * 5 + 2
    assert system.tracker.new_kf_slots == []
    system.shutdown()
    tum, kitti, kf = (tmp_path / n for n in ("t.txt", "k.txt", "kf.txt"))
    system.save_trajectory_tum(tum)
    system.save_trajectory_kitti(kitti)
    system.save_keyframe_trajectory_tum(kf)
    rows = ttraj.read_tum(tum)
    assert rows.shape == (5, 8)
    mats = ttraj.read_kitti(kitti)
    np.testing.assert_allclose(mats[:, :, 3], rows[:, 1:4], atol=1e-6)
    assert ttraj.read_tum(kf).shape[0] == system.shared.n_kf
    err = ttraj.ate(rows[:, 1:4], t_gt[:5], with_scale=False)
    assert err["rmse"] < 0.05


@pytest.mark.e2e
def test_compact_points_and_reset():
    frames, _ = sequence(12)
    shared = ttr.SharedMap(TCFG, device="cpu")
    tr = ttr.Tracker(TCFG, shared, run_local_ba=False, device="cpu")
    for i, (left, right) in enumerate(frames[:4]):
        tr.track_stereo(left, right, frame_id=i)
    s0 = shared.state
    n_valid = int(s0.mp_valid.sum())
    assert n_valid < shared.n_mp           # fusion / culling left holes
    pos_before = s0.mp_pos[s0.mp_valid].clone()
    live = tr.last_frame_mp.clone()
    pts_before = s0.mp_pos[live[live >= 0].long()].clone()
    shared.compact_points()
    s1 = shared.state
    assert shared.n_mp == n_valid == int(s1.mp_valid[:n_valid].sum())
    assert not s1.mp_valid[n_valid:].any() and shared.n_compactions == 1
    assert torch.equal(s1.mp_pos[:n_valid], pos_before)
    now = tr.last_frame_mp
    assert torch.equal(s1.mp_pos[now[now >= 0].long()], pts_before)
    p, o = np.nonzero(s1.mp_obs_kf.numpy() >= 0)
    assert np.all(s1.kf_mp.numpy()[s1.mp_obs_kf.numpy()[p, o],
                                   s1.mp_obs_feat.numpy()[p, o]] == p)
    # tracking goes on after the permutation
    assert tr.track_stereo(*frames[4], frame_id=4) is not None
    # reset: the agent's map content goes and the tracker restarts from
    # NOT_INITIALIZED, as the reference's Tracking::Reset does (the JAX
    # package leaves the state as it was)
    tr.reset()
    assert tr.state == ttr.TrackerState.NOT_INITIALIZED and tr.ref_kf == -1
    assert not shared.state.kf_valid.any() and not shared.state.mp_valid.any()
    assert all(r.lost for r in tr.trajectory)
    assert int(shared.state.covis.sum()) == 0


def test_alloc_kf_recycles_slots():
    shared = ttr.SharedMap(TCFG, device="cpu")
    a, b = shared.alloc_kf(), shared.alloc_kf()
    assert (a, b) == (0, 1) and shared.state.kf_seq[1] == 1
    shared.note_culled(a, b, np.ones(4), np.zeros(3))
    assert shared.cull_info[0][0] == 1 and 0 not in shared.uid_slot
    shared.reclaim_slots()
    c = shared.alloc_kf()
    assert c == a and shared.kf_uid[c] == 2 and shared.state.kf_seq[c] == 2


def test_torch_ops_helpers():
    rng = np.random.default_rng(0)
    mask = torch.from_numpy(rng.random(200) < 0.3)
    want = np.nonzero(mask.numpy())[0]
    got = ops.first_true_indices(mask, 20, 200).numpy()
    np.testing.assert_array_equal(got, want[:20])
    got = ops.first_true_indices(mask, 150, 200).numpy()
    np.testing.assert_array_equal(got[:len(want)], want)
    assert (got[len(want):] == 200).all()
    x = torch.tensor([3.0, 5.0, 5.0, 1.0, 5.0])
    v, i = ops.top_k_stable(x, 3)
    assert i.tolist() == [1, 2, 4] and v.tolist() == [5.0, 5.0, 5.0]
    dst = torch.zeros(4, 2)
    out = ops.set_drop(dst, torch.tensor([1, 4, 3]), torch.ones(3, 2))
    assert out[:, 0].tolist() == [0, 1, 0, 1] and dst.sum() == 0
    out = ops.add_drop(torch.zeros(3), torch.tensor([0, 0, 3, 2]), 1.0)
    assert out.tolist() == [2.0, 0.0, 1.0]
    out = ops.set_drop2(torch.zeros(2, 3, dtype=torch.int32),
                        torch.tensor([0, 2, 1]), torch.tensor([1, 0, 3]), 7)
    assert out.tolist() == [[0, 7, 0], [0, 0, 0]]
    assert ops.mask_from_ids(torch.tensor([[2, -1], [0, 2]]), 4).tolist() == \
        [True, False, True, False]


def test_synthetic_and_trajectory_copies_match_jax_package():
    """The port keeps its own numpy copies of io/synthetic.py and
    io/trajectory.py; they render and evaluate like the originals."""
    from multiagent_orb_slam2_tpu.io import synthetic as jsyn
    from multiagent_orb_slam2_tpu.io import trajectory as jtraj
    from multiagent_orb_slam2_tpu_torch.io import synthetic as tsyn
    qj, tj = jsyn.corridor_trajectory(4, step=0.15, seed=1)
    qt, tt = tsyn.corridor_trajectory(4, step=0.15, seed=1)
    np.testing.assert_allclose(qt, qj, atol=1e-6)
    np.testing.assert_allclose(tt, tj, atol=1e-9)
    frames, _ = sequence(12)
    scene = tsyn.BoxScene(seed=7, z_far=40.0)
    left, right, depth = scene.render_stereo(TCFG.camera, qt[2], tt[2])
    # grey levels 0..255; the pose quaternion differs in the last float32 bit
    np.testing.assert_allclose(left, frames[2][0], atol=5e-3)
    np.testing.assert_allclose(right, frames[2][1], atol=5e-3)
    assert depth.shape == (240, 320) and depth.min() > 0
    rng = np.random.default_rng(2)
    est, gt = rng.normal(size=(30, 3)), rng.normal(size=(30, 3))
    assert ttraj.ate(est, gt) == jtraj.ate(est, gt)
    np.testing.assert_allclose(ttraj.poses_to_matrices(qt, tt),
                               jtraj.poses_to_matrices(qj, tj), atol=1e-6)


@pytest.mark.e2e
def test_tracker_with_local_ba_matches_jax():
    """Trackers of both packages with local BA on (the default), 8 corridor
    frames on features extracted once by the JAX package: four keyframes are
    spawned with three or more in the map, so four local BAs and cullings
    run. A 70 % redundancy rule (the default 90 % culls nothing on so short
    a run) makes both cull keyframes, so the export re-chains through
    cull_info. Per frame the camera centre within 2 mm (found 7e-5 m), the
    same keyframe frames, n_kf and n_mp, the same culled slots, exported
    poses within 1e-3 (found 2e-5)."""
    import jax.numpy as jnp
    from multiagent_orb_slam2_tpu.config import MappingConfig
    from multiagent_orb_slam2_tpu.ops import frame as jframe
    from multiagent_orb_slam2_tpu.runtime import tracker as jtr
    from torch_parity import CAM, torch_feats_from_jax

    cfg = CFG.replace(mapping=MappingConfig(kf_cull_redundancy=0.7))
    tcfg = convert.config_from_dict({**dataclasses.asdict(cfg), "camera": CAM})
    frames, _ = sequence(12)
    sj = jtr.SharedMap(cfg)
    tj = jtr.Tracker(cfg, sj)
    st = ttr.SharedMap(tcfg, device="cpu")
    tt = ttr.Tracker(tcfg, st, device="cpu")
    assert tj.run_local_ba and tt.run_local_ba
    kf_frames_j, kf_frames_t, n_ba = [], [], 0
    for i, (left, right) in enumerate(frames[:8]):
        f = jframe.extract_frame(jnp.asarray(left), cfg,
                                 right_img=jnp.asarray(right))
        nj, nt = sj.n_created, st.n_created
        tj.track_features(f, i)
        tt.track_features(torch_feats_from_jax(f), i)
        if sj.n_created > nj:
            kf_frames_j.append(i)
        if st.n_created > nt:
            kf_frames_t.append(i)
            n_ba += st.n_kf >= 3 and i > 0
        rj, rt = tj.trajectory[-1], tt.trajectory[-1]
        assert rj.lost == rt.lost is False, i
        cj = ttr._np_inverse(rj.q.astype(np.float64), rj.t.astype(np.float64))
        ct = ttr._np_inverse(rt.q.astype(np.float64), rt.t.astype(np.float64))
        assert np.linalg.norm(cj[1] - ct[1]) <= 2e-3, i
        assert rj.ref_kf == rt.ref_kf and rj.ref_uid == rt.ref_uid
    assert kf_frames_j == kf_frames_t and n_ba >= 2
    assert (sj.n_kf, sj.n_mp) == (st.n_kf, st.n_mp)
    assert tt.culled_kf_slots == tj.culled_kf_slots != []
    assert sorted(st.cull_info) == sorted(sj.cull_info) != []
    assert st.pending_release == sj.pending_release
    for uid, (parent, rel_q, rel_t) in st.cull_info.items():
        assert parent == sj.cull_info[uid][0]
        np.testing.assert_allclose(rel_q, sj.cull_info[uid][1], atol=1e-4)
        np.testing.assert_allclose(rel_t, sj.cull_info[uid][2], atol=1e-4)
    ej, et = tj.export_poses(), tt.export_poses()
    assert tt.export_fallbacks == tj.export_fallbacks == 0
    culled_uids = set(st.cull_info)
    assert any(r.ref_uid in culled_uids for r in tt.trajectory)
    for (fj, lj, qj, tj_), (ft, lt, qt, tt_) in zip(ej, et):
        assert (fj, lj) == (ft, lt)
        np.testing.assert_allclose(qt, qj, atol=1e-3)
        np.testing.assert_allclose(tt_, tj_, atol=1e-3)

