"""The port's two-view initializer (geometry/twoview.py) against the JAX
package's, on the scenes of tests/test_twoview.py (general motion -> F,
planar -> H, pure rotation rejected, and the outlier-free scene), with the
JAX package's own RANSAC samples injected (jax.random.choice with p, keyed
as the JAX test keys it).

Tolerances (CPU, float32; measured in brackets):
- _normalize: 1e-6 [equal to rounding].
- _dlt_h / _eight_point_f: each null vector up to its sign, 2e-4 of its
  norm [1.0e-4 on F, general scene], where it is well defined: H's two
  smallest singular values 5 % apart, F's 8 x 9 system's smallest singular
  value above 1e-4 of its largest (a planar scene makes most 8-point F
  samples nearly degenerate; the error grows as that ratio falls).
- _score_h / _score_f on the JAX hypotheses: scores 1e-4 relative, inlier
  masks equal.
- _decompose_h / _decompose_e on a model near the scene's own (the JAX
  result's E and a homography of a plane 6 units ahead, each perturbed by
  1e-3): the same hypotheses, each within 1e-4 (SVD signs may order them
  otherwise, so they are matched as sets).
- _check_rt on the same hypotheses: good counts and masks equal, parallax
  within 1e-3 degrees.
- initialize_two_view: ok and the model choice equal, q 1e-5 [5e-7], t 1e-4
  [4e-6] where accepted, inlier masks equal, the inliers' points within 2e-3
  [7e-4].
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multiagent_orb_slam2_tpu.geometry import twoview as jtv
from multiagent_orb_slam2_tpu_torch.geometry import twoview as ttv
from multiagent_orb_slam2_tpu_torch.geometry.camera import Intrinsics

from test_twoview import CAM, make_pair

TCAM = Intrinsics(*tuple(CAM))

SCENES = {
    "general": dict(kw=dict(planar=False, seed=1), key=0),
    "planar": dict(kw=dict(planar=True, seed=2), key=1),
    "no_outliers": dict(kw=dict(planar=False, seed=3, outlier_frac=0.0),
                        key=2),
    "pure_rotation": dict(kw=dict(planar=False, seed=4,
                                  baseline=(0.0, 0.0, 0.0), rot=0.05,
                                  outlier_frac=0.0), key=3),
}


def jax_samples(mask: np.ndarray, n_iters: int, seed: int) -> np.ndarray:
    """The samples of the JAX initialize_two_view for this mask and key."""
    N = mask.shape[0]
    keys = jax.random.split(jax.random.PRNGKey(seed), n_iters)
    probs = jnp.asarray(mask, jnp.float32) / max(int(mask.sum()), 1)
    return np.asarray(jax.vmap(lambda k: jax.random.choice(
        k, N, shape=(8,), replace=False, p=probs))(keys))


def _t(x, dtype=None):
    return torch.from_numpy(np.array(x, dtype=dtype))


@pytest.fixture(scope="module")
def scenes():
    out = {}
    for name, sc in SCENES.items():
        x1, x2, mask, gt = make_pair(**sc["kw"])
        m = np.asarray(mask)
        res = jtv.initialize_two_view(x1, x2, mask, CAM,
                                      jax.random.PRNGKey(sc["key"]))
        out[name] = dict(x1=np.asarray(x1), x2=np.asarray(x2), mask=m,
                         samples=jax_samples(m, 200, sc["key"]), jres=res)
    return out


def _null_vec_close(got, want, keep):
    """Rows of got / want [B, 9] equal up to sign: the worst difference of
    the unit vectors over the rows in `keep`."""
    g = got / np.linalg.norm(got, axis=-1, keepdims=True)
    w = want / np.linalg.norm(want, axis=-1, keepdims=True)
    sign = np.sign(np.sum(g * w, axis=-1, keepdims=True))
    return np.abs(g * sign - w).max(axis=-1)[keep].max()


def _singular_values(A):
    return np.linalg.svd(np.asarray(A, np.float64), compute_uv=False)


def test_normalize_matches(scenes):
    c = scenes["general"]
    xj, Tj = jtv._normalize(jnp.asarray(c["x1"]), jnp.asarray(c["mask"]))
    xt, Tt = ttv._normalize(_t(c["x1"]), _t(c["mask"]))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("name", ["general", "planar"])
def test_eight_point_models_match(scenes, name):
    c = scenes[name]
    xn1, _ = jtv._normalize(jnp.asarray(c["x1"]), jnp.asarray(c["mask"]))
    xn2, _ = jtv._normalize(jnp.asarray(c["x2"]), jnp.asarray(c["mask"]))
    s1 = np.asarray(xn1)[c["samples"]]
    s2 = np.asarray(xn2)[c["samples"]]
    Hj = np.asarray(jtv._dlt_h(jnp.asarray(s1), jnp.asarray(s2)))
    Ht = ttv._dlt_h(_t(s1), _t(s2)).numpy()
    x1, y1, x2, y2 = s1[..., 0], s1[..., 1], s2[..., 0], s2[..., 1]
    z, o = np.zeros_like(x1), np.ones_like(x1)
    A_h = np.concatenate([
        np.stack([z, z, z, -x1, -y1, -o, y2 * x1, y2 * y1, y2], -1),
        np.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2], -1)], 1)
    sv = _singular_values(A_h)
    keep = (sv[:, -2] - sv[:, -1]) > 0.05 * sv[:, -2]
    err = _null_vec_close(Ht.reshape(-1, 9), Hj.reshape(-1, 9), keep)
    assert keep.sum() >= 150 and err < 2e-4, (err, keep.sum())
    # F: rank 2, and the same null vector of the 8 x 9 system where that
    # system is not nearly rank-deficient
    Fj = np.asarray(jtv._eight_point_f(jnp.asarray(s1), jnp.asarray(s2)))
    Ft = ttv._eight_point_f(_t(s1), _t(s2)).numpy()
    assert np.abs(np.linalg.det(Ft.astype(np.float64))).max() < 1e-5
    sv = _singular_values(np.stack(
        [x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, o], -1))
    keep = sv[:, -1] > 1e-4 * sv[:, 0]
    err = _null_vec_close(Ft.reshape(-1, 9), Fj.reshape(-1, 9), keep)
    assert keep.sum() >= 40 and err < 2e-4, (err, keep.sum())


@pytest.mark.parametrize("name", ["general", "planar"])
def test_scores_match(scenes, name):
    c = scenes[name]
    x1, x2, m = c["x1"], c["x2"], c["mask"]
    xn1, T1 = jtv._normalize(jnp.asarray(x1), jnp.asarray(m))
    xn2, T2 = jtv._normalize(jnp.asarray(x2), jnp.asarray(m))
    s1, s2 = xn1[c["samples"]], xn2[c["samples"]]
    H = jnp.linalg.inv(T2) @ jtv._dlt_h(s1, s2) @ T1
    H = H / H[:, 2:3, 2:3]
    Hi = jnp.linalg.inv(H)
    F = T2.T @ jtv._eight_point_f(s1, s2) @ T1
    for fj, ft, args in (
            (jtv._score_h, ttv._score_h, (H, Hi)),
            (jtv._score_f, ttv._score_f, (F,))):
        sj, okj = fj(*args, jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(m))
        st, okt = ft(*[_t(a) for a in args], _t(x1), _t(x2), _t(m))
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-4,
                                   atol=1e-3)
        np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))


def _match_sets(Rt, tt, Rj, tj, tol):
    """Every torch hypothesis equals one JAX hypothesis and vice versa."""
    used = set()
    for R, t in zip(Rt, tt):
        d = [max(np.abs(R - Rj[k]).max(), np.abs(t - tj[k]).max())
             for k in range(len(Rj))]
        k = int(np.argmin(d))
        assert d[k] < tol, (d[k], k)
        used.add(k)
    assert len(used) == len(Rj)


@pytest.mark.parametrize("name", ["general", "planar"])
def test_decompositions_and_check_rt_match(scenes, name):
    c = scenes[name]
    Kinv = np.linalg.inv(np.asarray(CAM.K, np.float32)).astype(np.float32)
    rng = np.random.default_rng(5)
    # models near the scene's own: E of the JAX result's motion and the
    # homography of a plane 6 units ahead, each perturbed
    res = scenes[name]["jres"]
    R = np.asarray(jtv.se3.quat_to_matrix(res.q))
    t = np.asarray(res.t)
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    E = (tx @ R + rng.normal(0, 1e-3, (3, 3))).astype(np.float32)
    He = (R + np.outer(t, [0.0, 0.0, 1.0 / 6.0])
          + rng.normal(0, 1e-3, (3, 3))).astype(np.float32)
    Rej, tej = (np.asarray(a) for a in jtv._decompose_e(jnp.asarray(E)))
    Ret, tet = (a.numpy() for a in ttv._decompose_e(_t(E)))
    _match_sets(Ret, tet, Rej, tej, 1e-4)
    Rhj, thj = (np.asarray(a) for a in jtv._decompose_h(jnp.asarray(He)))
    Rht, tht = (a.numpy() for a in ttv._decompose_h(_t(He)))
    _match_sets(Rht, tht, Rhj, thj, 1e-4)

    # CheckRT on the JAX hypotheses
    Rs = np.concatenate([Rhj, Rej]).astype(np.float32)
    ts = np.concatenate([thj, tej]).astype(np.float32)

    def to_norm(x):
        return (np.concatenate([x, np.ones_like(x[:, :1])], -1) @ Kinv.T
                )[:, :2].astype(np.float32)
    c1, c2 = to_norm(c["x1"]), to_norm(c["x2"])
    nj, pj, gj, _ = jtv._check_rt(jnp.asarray(Rs), jnp.asarray(ts),
                                  jnp.asarray(c1), jnp.asarray(c2),
                                  jnp.asarray(c["mask"]), CAM)
    nt, pt, gt, _ = ttv._check_rt(_t(Rs), _t(ts), _t(c1), _t(c2),
                                  _t(c["mask"]), TCAM)
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-3)


@pytest.mark.parametrize("name", list(SCENES))
def test_initialize_two_view_matches_jax(scenes, name):
    c = scenes[name]
    rj = c["jres"]
    rt = ttv.initialize_two_view(_t(c["x1"]), _t(c["x2"]), _t(c["mask"]),
                                 TCAM, _t(c["samples"]))
    assert bool(rt.ok) == bool(rj.ok)
    assert bool(rt.used_homography) == bool(rj.used_homography)
    assert bool(rt.used_homography) == (name == "planar") or \
        name == "pure_rotation"
    inl = np.asarray(rj.inliers)
    np.testing.assert_array_equal(rt.inliers.numpy(), inl)
    if name == "pure_rotation":
        assert not bool(rt.ok)     # no parallax: must not initialize
        return
    np.testing.assert_allclose(rt.q.numpy(), np.asarray(rj.q), atol=1e-5)
    np.testing.assert_allclose(rt.t.numpy(), np.asarray(rj.t), atol=1e-4)
    assert inl.sum() > 100
    np.testing.assert_allclose(rt.points.numpy()[inl],
                               np.asarray(rj.points)[inl], atol=2e-3)


def test_draw_samples_masked_distinct_and_seeded():
    mask = torch.zeros(300, dtype=torch.bool)
    mask[::3] = True
    s = ttv.draw_samples(mask, 200, seed=7)
    assert s.shape == (200, 8)
    assert bool(mask[s].all())
    assert all(len(set(row.tolist())) == 8 for row in s)
    assert torch.equal(s, ttv.draw_samples(mask, 200, seed=7))
    assert not torch.equal(s, ttv.draw_samples(mask, 200, seed=8))
