"""The port's ops/matchers.py against the JAX one on the same converted
features and map: integer outputs exact, floats 1e-5."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from multiagent_orb_slam2_tpu.ops import matchers as jm
from multiagent_orb_slam2_tpu_torch.ops import matchers as tm

from torch_parity import (CFG, TCFG, jax_feats_from_torch,
                          jax_state_from_torch, port_tracker_after, t2j)


@pytest.fixture(scope="module")
def world():
    tr, shared, feats = port_tracker_after(4)
    return shared.state, jax_state_from_torch(shared.state), feats, tr


def _same_result(rj, rt):
    np.testing.assert_array_equal(rt.ok.numpy(), np.asarray(rj.ok))
    np.testing.assert_array_equal(rt.best_feat.numpy(), np.asarray(rj.best_feat))
    np.testing.assert_array_equal(rt.best_dist.numpy(), np.asarray(rj.best_dist))


def _window_inputs(world):
    tstate, jstate, feats, tr = world
    prev, cur = feats[3], feats[4]
    P = CFG.caps.max_points
    mp = tr.last_frame_mp.long().clamp(0, P - 1)
    qmask = (tr.last_frame_mp >= 0) & prev.valid
    pw = tstate.mp_pos[mp]
    return prev, cur, qmask, pw, tr.last_q, tr.last_t


def test_project_points(world):
    prev, cur, qmask, pw, q, t = _window_inputs(world)
    oj = jm.project_points(CFG.camera, t2j(q), t2j(t), t2j(pw))
    ot = tm.project_points(TCFG.camera, q, t, pw)
    for a, b in zip(oj, ot):
        a = np.asarray(a)
        if a.dtype == bool:
            np.testing.assert_array_equal(b.numpy(), a)
        else:
            np.testing.assert_allclose(b.numpy(), a, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("nn_ratio,with_level", [(1.0, True), (0.9, False)])
def test_match_window_rotation_resolve(world, nn_ratio, with_level):
    prev, cur, qmask, pw, q, t = _window_inputs(world)
    uv, ur, _, vis = tm.project_points(TCFG.camera, q, t, pw)
    radius = 7.0 * torch.tensor(TCFG.orb.scale_factors)[prev.level.long()]
    jprev, jcur = jax_feats_from_torch(prev), jax_feats_from_torch(cur)
    kw = dict(th=100, nn_ratio=nn_ratio)
    rj = jm.match_window(jcur, jprev.desc, t2j(qmask & vis), t2j(uv),
                         t2j(radius), pred_ur=t2j(ur),
                         pred_level=jprev.level if with_level else None, **kw)
    rt = tm.match_window(cur, prev.desc, qmask & vis, uv, radius, pred_ur=ur,
                         pred_level=prev.level if with_level else None, **kw)
    _same_result(rj, rt)
    assert int(rt.ok.sum()) > 50
    rj = jm.rotation_consistency(jprev.angle, jcur.angle, rj, 30)
    rt = tm.rotation_consistency(prev.angle, cur.angle, rt, 30)
    _same_result(rj, rt)
    F = CFG.caps.max_features
    aj, rj = jm.resolve_conflicts(rj, F)
    at, rt = tm.resolve_conflicts(rt, F)
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    _same_result(rj, rt)
    taken = at.numpy()[at.numpy() >= 0]
    assert len(taken) == len(set(taken.tolist())) == int(rt.ok.sum())


def test_match_brute(world):
    tstate, jstate, feats, tr = world
    cur, jcur = feats[4], jax_feats_from_torch(feats[4])
    kf = tr.ref_kf
    qmask = (tstate.kf_mp[kf] >= 0) & tstate.kf_feat_valid[kf]
    rj = jm.match_brute(jstate.kf_desc[kf], t2j(qmask), jcur.desc, jcur.valid)
    rt = tm.match_brute(tstate.kf_desc[kf], qmask, cur.desc, cur.valid)
    _same_result(rj, rt)
    assert int(rt.ok.sum()) > 20


def test_resolve_conflicts_dense_and_scatter_agree():
    """Duplicate claims with equal distances: the lowest claimant wins, in
    the dense path, the scatter path and the JAX package alike."""
    rng = np.random.default_rng(8)
    Q, F = 300, 40
    feat = rng.integers(-1, F, Q)
    dist = rng.integers(0, 6, Q).astype(np.int32)
    ok = feat >= 0
    rj = jm.MatchResult(jnp.asarray(feat.astype(np.int32)), jnp.asarray(dist),
                        jnp.asarray(ok))
    rt = tm.MatchResult(torch.from_numpy(feat), torch.from_numpy(dist),
                        torch.from_numpy(ok))
    aj, rj2 = jm.resolve_conflicts(rj, F)
    at, rt2 = tm.resolve_conflicts(rt, F)
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    _same_result(rj2, rt2)
    # force the scatter-min branch of the port
    at2, rt3 = _scatter_branch(rt, F)
    np.testing.assert_array_equal(at2.numpy(), at.numpy())
    _same_result(rj2, rt3)


def _scatter_branch(res, n_feats):
    """resolve_conflicts with a query set padded past the dense limit, so
    the scatter-min branch runs; padding queries claim nothing."""
    Q = res.best_feat.shape[0]
    pad = 6 * 1024 * 1024 // n_feats + 1 - Q
    padded = tm.MatchResult(
        torch.cat([res.best_feat, torch.full((pad,), -1, dtype=torch.int64)]),
        torch.cat([res.best_dist, torch.zeros(pad, dtype=torch.int32)]),
        torch.cat([res.ok, torch.zeros(pad, dtype=torch.bool)]))
    assign, out = tm.resolve_conflicts(padded, n_feats)
    return assign, tm.MatchResult(out.best_feat[:Q], out.best_dist[:Q],
                                  out.ok[:Q])


def test_search_epipolar(world):
    tstate, jstate, feats, tr = world
    from multiagent_orb_slam2_tpu_torch.geometry import se3 as tse3
    k1, k2 = 2, 1
    q12, t12 = tse3.relative(tstate.kf_q[k2], tstate.kf_t[k2],
                             tstate.kf_q[k1], tstate.kf_t[k1])
    Kinv = torch.linalg.inv(TCFG.camera.K)
    F12 = Kinv.T @ (tse3.hat(t12) @ tse3.quat_to_matrix(q12)) @ Kinv
    free1 = tstate.kf_feat_valid[k1] & (tstate.kf_mp[k1] < 0)
    free2 = tstate.kf_feat_valid[k2] & (tstate.kf_mp[k2] < 0)
    rj = jm.search_epipolar(
        jstate.kf_desc[k1], jstate.kf_xy[k1], jstate.kf_level[k1], t2j(free1),
        jstate.kf_desc[k2], jstate.kf_xy[k2], jstate.kf_level[k2], t2j(free2),
        t2j(F12), CFG.orb.scale_factors, th=50)
    rt = tm.search_epipolar(
        tstate.kf_desc[k1], tstate.kf_xy[k1], tstate.kf_level[k1], free1,
        tstate.kf_desc[k2], tstate.kf_xy[k2], tstate.kf_level[k2], free2,
        F12, TCFG.orb.scale_factors, th=50)
    # a candidate exactly on the 3.84 sigma^2 gate may flip with float
    # rounding of the line distance; none does on this input
    _same_result(rj, rt)
    assert int(rt.ok.sum()) > 5
