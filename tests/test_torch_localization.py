"""Localization-only mode in the port against the JAX package, on the
seed-7 stereo corridor of tests/test_tracking.py.

One JAX run (module fixture): the JAX tracker maps frames 0-9, tracks
frames 10-19 in localization mode, then leaves it for frames 20-29; the
inputs of its frame 10 are kept. In the mode the JAX tracker's reference
keyframe follows the frame as the port's does (jax_views.
best_covisible_reference: the keyframe observing most of the frame's map
points, the reference's UpdateLocalKeyFrames); the JAX package keeps the
last keyframe made, which on this clip differs on frames 16, 17 and 19.

- make_vo_points on frame 9's features, none of them on a map point, with
  tied depths beyond the close band (so the 100-closest rank decides, and
  ties go in index order as jnp.argsort's stable sort puts them): the same
  mask, positions within 1e-5.
- track_motion_model_vo_step on frame 10 with the JAX run's map, frame 9
  and its VO points, at both window radii: pose within 1e-4 (the standing
  tolerance of the tracking steps; measured 1.4e-5), the same frame_mp,
  the same inlier counts (all and map-only).
- The port of test_localization_only_mode: the port's tracker over the
  same frames, mapping 0-9 and localizing 10-19: no keyframe or point
  created, every MapState field bit-equal to the mapped state except
  mp_visible and mp_found (track_local_map_step still counts those, as the
  reference does), no frame lost, the ATE under the JAX test's 0.08 m; on
  every frame of 0-19 the JAX run's reference keyframe, and the camera
  centre within 2 mm of the JAX run's; leaving the mode clears the VO state.
- Fault 13 (ROADMAP.md queue 3), the deviation asserted: leaving the mode,
  the port makes the last frame it tracked in the mode a keyframe (frame
  19, on the same map; NeedNewKeyFrame asks for one there), the JAX package
  makes none; out of the mode the port then maps on without a reset, every
  frame of 20-29 tracked, camera centres within the same 0.08 m of the
  truth.
- That keyframe is NeedNewKeyFrame's to make, and never on a VO-tracked
  frame: the port's tracker maps 0-9 (a keyframe at 9), tracks frame 10 in
  the mode and leaves: labelled max_frames_between_kf frames after the last
  keyframe, a keyframe at it; the same with the tracker in VO state
  (set by hand), none; labelled 10, none.
"""
import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multiagent_orb_slam2_tpu.ops import frame as jframe
from multiagent_orb_slam2_tpu.runtime import steps as jsteps
from multiagent_orb_slam2_tpu.runtime import tracker as jtr
from multiagent_orb_slam2_tpu_torch.runtime import steps as tsteps
from multiagent_orb_slam2_tpu_torch.runtime import tracker as ttr
from multiagent_orb_slam2_tpu_torch.runtime.tracker import _np_inverse

from jax_views import best_covisible_reference
from torch_parity import (CFG, TCFG, sequence, threads, torch_feats_from_jax,
                          torch_state_from_jax)

N_FRAMES, N_MAP, N_END = 30, 10, 20


def _centres(trajectory):
    return np.stack([_np_inverse(r.q.astype(np.float64),
                                 r.t.astype(np.float64))[1]
                     for r in trajectory])


@pytest.fixture(scope="module")
def jax_run():
    frames, (q_wc, t_wc) = sequence(N_FRAMES)
    tracker = jtr.Tracker(CFG, jtr.SharedMap(CFG))
    for i, (left, right) in enumerate(frames[:N_MAP]):
        tracker.track_stereo(left, right, frame_id=i)
    kept = dict(state=tracker.shared.state, prev=tracker.last_feats,
                prev_mp=tracker.last_frame_mp, q=tracker.last_q,
                t=tracker.last_t)
    tracker.set_localization_mode(True)
    with best_covisible_reference(tracker, jsteps):
        for i, (left, right) in enumerate(frames[N_MAP:N_END], start=N_MAP):
            tracker.track_stereo(left, right, frame_id=i)
    kept["vo"] = tracker.vo
    kept["created"] = tracker.shared.n_created
    tracker.set_localization_mode(False)
    kept["created_on_leaving"] = tracker.shared.n_created - kept["created"]
    for i, (left, right) in enumerate(frames[N_END:], start=N_END):
        tracker.track_stereo(left, right, frame_id=i)
    return tracker, kept, frames, t_wc


def _to_t(x):
    return torch.from_numpy(np.array(x))


def test_make_vo_points_tied_depths(jax_run):
    _, kept, _, _ = jax_run
    prev = kept["prev"]
    n = prev.depth.shape[0]
    close_th = CFG.tracking.th_depth * CFG.camera.baseline
    depth = np.asarray(prev.depth)
    # every stereo feature beyond the close band, on 13 depths only
    tied = np.where(depth > 0, close_th + 1.0
                    + 0.5 * (np.arange(n) % 13), depth).astype(np.float32)
    feats = prev._replace(depth=jnp.asarray(tied))
    no_mp = np.full(n, -1, np.int32)
    want_pw, want_keep = jsteps.make_vo_points(
        kept["state"], feats, jnp.asarray(no_mp), kept["q"], kept["t"], CFG)
    got_pw, got_keep = tsteps.make_vo_points(
        torch_state_from_jax(kept["state"]), torch_feats_from_jax(feats),
        _to_t(no_mp), _to_t(kept["q"]), _to_t(kept["t"]), TCFG)
    keep = np.asarray(want_keep)
    cand = (tied > 0) & np.asarray(prev.valid)
    assert keep.sum() == 100 < cand.sum()
    np.testing.assert_array_equal(got_keep.numpy(), keep)
    np.testing.assert_allclose(got_pw.numpy()[keep], np.asarray(want_pw)[keep],
                               atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("radius_mult", [1.0, 2.0])
def test_track_motion_model_vo_step_matches_jax(jax_run, radius_mult):
    _, kept, frames, _ = jax_run
    left, right = frames[N_MAP]
    feats = jframe.extract_frame(jnp.asarray(left), CFG,
                                 right_img=jnp.asarray(right))
    vo_pw, vo_mask = jsteps.make_vo_points(
        kept["state"], kept["prev"], kept["prev_mp"], kept["q"], kept["t"],
        CFG)
    want = jsteps.track_motion_model_vo_step(
        kept["state"], feats, kept["prev"], kept["prev_mp"], vo_pw, vo_mask,
        kept["q"], kept["t"], CFG, radius_mult=radius_mult)
    got = tsteps.track_motion_model_vo_step(
        torch_state_from_jax(kept["state"]), torch_feats_from_jax(feats),
        torch_feats_from_jax(kept["prev"]), _to_t(kept["prev_mp"]),
        _to_t(vo_pw), _to_t(vo_mask), _to_t(kept["q"]), _to_t(kept["t"]),
        TCFG, radius_mult=radius_mult)
    assert int(np.asarray(vo_mask).sum()) > 0
    np.testing.assert_allclose(got.q.numpy(), np.asarray(want.q), atol=1e-4)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), atol=1e-4)
    np.testing.assert_array_equal(got.frame_mp.numpy(),
                                  np.asarray(want.frame_mp))
    assert int(got.n_inliers) == int(want.n_inliers) > 20
    assert int(got.n_map_inliers) == int(want.n_map_inliers)


@pytest.mark.e2e
def test_localization_only_mode(jax_run):
    jt, kept, frames, t_wc = jax_run
    shared = ttr.SharedMap(TCFG, device="cpu")
    tracker = ttr.Tracker(TCFG, shared, device="cpu")
    with threads(2):
        for i, (left, right) in enumerate(frames[:N_MAP]):
            tracker.track_stereo(left, right, frame_id=i)
        n_kf, n_mp, n_created = shared.n_kf, shared.n_mp, shared.n_created
        before = shared.state
        tracker.set_localization_mode(True)
        for i, (left, right) in enumerate(frames[N_MAP:N_END],
                                          start=N_MAP):
            tracker.track_stereo(left, right, frame_id=i)

    # the map did not grow, nor change
    assert (shared.n_kf, shared.n_mp, shared.n_created) == \
        (n_kf, n_mp, n_created)
    for name, a in before._asdict().items():
        if name in ("mp_visible", "mp_found"):
            continue
        assert torch.equal(getattr(shared.state, name), a), name
    assert bool((shared.state.mp_visible >= before.mp_visible).all())
    assert not any(r.lost for r in tracker.trajectory), \
        [i for i, r in enumerate(tracker.trajectory) if r.lost]
    est = _centres(tracker.trajectory)
    ate = np.sqrt(np.mean(np.sum((est - t_wc[:N_END]) ** 2, axis=-1)))
    assert ate < 0.08, f"localization-mode ATE {ate:.4f} m"
    assert [r.ref_kf for r in tracker.trajectory] == \
        [r.ref_kf for r in jt.trajectory[:N_END]]
    assert np.abs(est - _centres(jt.trajectory[:N_END])).max() < 2e-3
    assert tracker.vo == kept["vo"]

    # leaving localization mode: the last frame of the mode becomes a
    # keyframe of the same map (the JAX tracker makes none), the VO state
    # is cleared, and mapping goes on from it without a reset
    tracker.set_localization_mode(False)
    assert not tracker.only_tracking
    assert tracker.last_vo_pw is None and not tracker.vo
    assert kept["created_on_leaving"] == 0
    assert shared.n_created == n_created + 1
    kf = tracker.ref_kf
    assert int(shared.state.kf_frame_id[kf]) == N_END - 1
    assert int(shared.state.kf_map[kf]) == tracker.map_id
    with threads(2):
        for i, (left, right) in enumerate(frames[N_END:], start=N_END):
            tracker.track_stereo(left, right, frame_id=i)
    assert tracker.n_resets == 0
    assert not any(r.lost for r in tracker.trajectory[N_END:])
    est = _centres(tracker.trajectory)
    assert np.sqrt(np.mean(np.sum((est[N_END:] - t_wc[N_END:]) ** 2,
                                  axis=-1))) < 0.08


@pytest.fixture(scope="module")
def port_mapped():
    """The port's SharedMap and tracker (CPU) after mapping frames 0-9,
    and the frames."""
    frames, _ = sequence(N_FRAMES)
    shared = ttr.SharedMap(TCFG, device="cpu")
    tracker = ttr.Tracker(TCFG, shared, device="cpu")
    with threads(2):
        for i, (left, right) in enumerate(frames[:N_MAP]):
            tracker.track_stereo(left, right, frame_id=i)
    return shared, frames


@pytest.mark.parametrize("case", ["after_max_frames", "vo", "next_frame"])
def test_leaving_the_mode_keyframe_follows_need_new_keyframe(port_mapped,
                                                             case):
    """Fault 13's keyframe on leaving the mode is NeedNewKeyFrame's to make,
    on the last frame of the mode, and never on a VO-tracked frame: one
    frame in the mode, frame 10, labelled max_frames_between_kf frames
    after the last keyframe (c1a holds): a keyframe at it; the same with
    the tracker in VO state (mbVO): none; labelled as the next frame, with
    a keyframe at frame 9 (NeedNewKeyFrame declines): none."""
    shared0, frames = port_mapped
    shared = copy.deepcopy(shared0)
    tracker = shared.trackers[0]
    assert tracker.last_kf_frame == N_MAP - 1
    frame_id = N_MAP if case == "next_frame" else \
        tracker.last_kf_frame + TCFG.tracking.max_frames_between_kf
    created = shared.n_created
    tracker.set_localization_mode(True)
    with threads(2):
        tracker.track_stereo(*frames[N_MAP], frame_id=frame_id)
    assert tracker.state == ttr.TrackerState.OK and not tracker.vo
    assert int(tracker._last_decision[1]) >= \
        TCFG.tracking.min_inliers_track_local_map
    if case == "vo":
        tracker.vo = True
    tracker.set_localization_mode(False)
    made = shared.n_created - created
    assert made == (case == "after_max_frames"), made
    if made:
        assert int(shared.state.kf_frame_id[tracker.ref_kf]) == frame_id
        assert tracker.last_kf_frame == frame_id
