"""The ported slice as a whole: single-agent stereo tracking + mapping
without local bundle adjustment, Tracker level, on the synthetic corridor."""
import numpy as np
import jax.numpy as jnp
import pytest

pytestmark = pytest.mark.e2e

from multiagent_orb_slam2_tpu.ops import frame as jframe
from multiagent_orb_slam2_tpu.runtime import tracker as jtr
from multiagent_orb_slam2_tpu_torch.runtime import tracker as ttr

from torch_parity import CFG, TCFG, sequence, torch_feats_from_jax


def _rot_angle(qa, qb):
    d = abs(float(np.dot(qa / np.linalg.norm(qa), qb / np.linalg.norm(qb))))
    return 2.0 * np.arccos(min(d, 1.0))


def _centre(q, t):
    return ttr._np_inverse(np.asarray(q, np.float64),
                           np.asarray(t, np.float64))[1]


def test_slice_parity_on_shared_features():
    """12 corridor frames, features extracted ONCE by the JAX package and fed
    to Tracker.track_features of both packages (run_local_ba=False): per
    frame the camera centre within 2 mm and the rotation within 1e-3 rad
    (found: 5e-6 m), the same frames spawn keyframes, n_kf equal, n_mp
    within 1 % (found: equal)."""
    frames, _ = sequence(12)
    sj = jtr.SharedMap(CFG)
    tj = jtr.Tracker(CFG, sj, run_local_ba=False)
    st = ttr.SharedMap(TCFG, device="cpu")
    tt = ttr.Tracker(TCFG, st, run_local_ba=False, device="cpu")
    kf_frames_j, kf_frames_t = [], []
    for i, (left, right) in enumerate(frames):
        f = jframe.extract_frame(jnp.asarray(left), CFG,
                                 right_img=jnp.asarray(right))
        nj, nt = sj.n_kf, st.n_kf
        tj.track_features(f, i)
        tt.track_features(torch_feats_from_jax(f), i)
        if sj.n_kf > nj:
            kf_frames_j.append(i)
        if st.n_kf > nt:
            kf_frames_t.append(i)
        rj, rt = tj.trajectory[-1], tt.trajectory[-1]
        assert rj.lost == rt.lost is False, i
        dc = np.linalg.norm(_centre(rj.q, rj.t) - _centre(rt.q, rt.t))
        assert dc <= 2e-3, (i, dc)
        assert _rot_angle(rj.q, rt.q) <= 1e-3, i
        assert rj.ref_kf == rt.ref_kf and rj.ref_uid == rt.ref_uid
    assert kf_frames_j == kf_frames_t and len(kf_frames_t) >= 3
    assert sj.n_kf == st.n_kf
    assert abs(sj.n_mp - st.n_mp) <= 0.01 * sj.n_mp
    for k, v in tt.shared.state._asdict().items():
        assert v.device.type == "cpu", k


def test_slice_from_images_ate():
    """The port alone, from the images (its own extract_frame), 20 frames:
    no frame lost, n_kf >= 3, ATE against ground truth under 0.08 m.
    Measured on this sequence with run_local_ba=False: JAX package 0.03975 m
    (14 keyframes, 1925 points), port 0.03976 m (14 keyframes, 1925
    points)."""
    frames, (q_gt, t_gt) = sequence(20)
    shared = ttr.SharedMap(TCFG, device="cpu")
    tracker = ttr.Tracker(TCFG, shared, run_local_ba=False, device="cpu")
    for i, (left, right) in enumerate(frames):
        out = tracker.track_stereo(left, right, frame_id=i)
        assert out is not None, i
    assert not any(r.lost for r in tracker.trajectory)
    assert shared.n_kf >= 3
    est = np.stack([_centre(r.q, r.t) for r in tracker.trajectory])
    ate = float(np.sqrt(np.mean(np.sum((est - t_gt) ** 2, axis=-1))))
    assert ate < 0.08, ate
    # forward / inverse observation maps agree and covisibility is symmetric
    s = shared.state
    covis = s.covis.numpy()[:shared.n_kf, :shared.n_kf]
    np.testing.assert_array_equal(covis, covis.T)
    assert np.all(np.diag(covis) == 0)
    obs_kf, obs_ft = s.mp_obs_kf.numpy(), s.mp_obs_feat.numpy()
    kf_mp = s.kf_mp.numpy()
    p, o = np.nonzero(obs_kf >= 0)
    assert len(p) > 1000
    assert np.all(kf_mp[obs_kf[p, o], obs_ft[p, o]] == p)
    rows = tracker.trajectory_tum()
    assert len(rows) == 20 and len(rows[0]) == 8
