"""Host-side behaviour of the port: System facade, what raises
NotImplementedError, slot bookkeeping, point compaction, reset, and the small
tensor helpers."""
import dataclasses

import numpy as np
import pytest
import torch

from multiagent_orb_slam2_tpu_torch import config as tconfig
from multiagent_orb_slam2_tpu_torch import convert
from multiagent_orb_slam2_tpu_torch.io import trajectory as ttraj
from multiagent_orb_slam2_tpu_torch.runtime import system as tsys
from multiagent_orb_slam2_tpu_torch.runtime import tracker as ttr
from multiagent_orb_slam2_tpu_torch.utils import torch_ops as ops

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
def test_unported_paths_raise(what):
    """Nothing that waits for a later slice degrades silently."""
    shared = ttr.SharedMap(TCFG, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        if what == "local_ba":
            ttr.Tracker(TCFG, shared, device="cpu")       # default is BA on
        elif what == "loop_closing":
            tsys.System(TCFG, None, device="cpu")         # default is on
        elif what == "vocab":
            tsys.System(TCFG, object(), enable_loop_closing=False,
                        device="cpu")
        elif what == "localization":
            ttr.Tracker(TCFG, shared, run_local_ba=False,
                        device="cpu").set_localization_mode(True)
        elif what == "mono_sensor":
            ttr.Tracker(TCFG.replace(sensor=tconfig.Sensor.MONOCULAR), shared,
                        run_local_ba=False, device="cpu")
        elif what == "rgbd":
            tsys.System(TCFG, None, enable_loop_closing=False,
                        device="cpu").track_rgbd(None, None)
        elif what == "track_mono":
            tsys.System(TCFG, None, enable_loop_closing=False,
                        device="cpu").track_mono(None)
        else:
            tsys.System(TCFG, None, enable_loop_closing=False,
                        device="cpu").save_map("x")


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
    # reset: the agent's map content goes, the state flag stays (as in the
    # JAX package; the caller re-initialises)
    state_before = tr.state
    tr.reset()
    assert tr.state == state_before and tr.ref_kf == -1
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
