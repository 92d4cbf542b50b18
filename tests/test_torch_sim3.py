"""The port's Sim3 geometry, Horn / RANSAC, Sim3 refinement and essential
graph against the JAX package's, on the same seeded inputs:

- geometry/sim3 on 64 transforms, a quarter of them with theta < 1e-6 and a
  quarter with |sigma| < 1e-6 (the small-angle branches): 1e-6 absolute plus
  1e-6 relative;
- horn_sim3 on exact and noisy clouds: 1e-5;
- RANSAC: the port scores the JAX package's own [B, 3] samples (this port
  cannot reproduce jax.random): the same hypothesis, inlier mask and count;
- optimize_sim3 on tests/test_sim3.py's problems: s, q, t within 1e-4, the
  inlier masks equal;
- optimize_pose_graph on test_sim3.py's drifted 10-vertex loop: 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd

torch.set_num_threads(1)   # several test workers share few cores

from multiagent_orb_slam2_tpu.geometry import horn as jhorn
from multiagent_orb_slam2_tpu.geometry import se3 as jse3
from multiagent_orb_slam2_tpu.geometry import sim3 as jsim3
from multiagent_orb_slam2_tpu.optim import pose_graph as jpg
from multiagent_orb_slam2_tpu.optim import sim3_opt as jso
from multiagent_orb_slam2_tpu_torch import convert
from multiagent_orb_slam2_tpu_torch.geometry import horn as thorn
from multiagent_orb_slam2_tpu_torch.geometry import sim3 as tsim3
from multiagent_orb_slam2_tpu_torch.geometry.camera import Intrinsics
from multiagent_orb_slam2_tpu_torch.optim import pose_graph as tpg
from multiagent_orb_slam2_tpu_torch.optim import sim3_opt as tso
from multiagent_orb_slam2_tpu_torch.utils.torch_ops import blockwise_jacfwd

from test_sim3 import CAM, make_sim3_problem, project

TCAM = Intrinsics(*CAM)
N = 64


def _t(a):
    return torch.from_numpy(np.array(np.asarray(a)))


def _close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=rtol)


def _sim3_inputs(rng):
    """(s [N], q [N, 4], t [N, 3], xi [N, 7]) with small-angle rows: rows
    0-15 theta < 1e-6, rows 16-31 |sigma| < 1e-6, rows 32-39 both."""
    xi = rng.normal(size=(N, 7)) * np.array([1, 1, 1, 0.5, 0.5, 0.5, 0.3])
    xi[:16, 3:6] *= 1e-7 / np.linalg.norm(xi[:16, 3:6], axis=1,
                                          keepdims=True)
    xi[16:32, 6] = rng.uniform(-9e-7, 9e-7, 16)
    xi[32:40, 3:6] *= 1e-8
    xi[32:40, 6] = rng.uniform(-9e-7, 9e-7, 8)
    xi = xi.astype(np.float32)
    s, q, t = (np.asarray(a) for a in jsim3.exp(jnp.asarray(xi)))
    return s, q, t, xi


SIM3_CASES = {
    "apply": lambda s, q, t, xi, p: (s, q, t, p),
    "compose": lambda s, q, t, xi, p: (s, q, t, s[::-1].copy(),
                                       q[::-1].copy(), t[::-1].copy()),
    "inverse": lambda s, q, t, xi, p: (s, q, t),
    "from_se3": lambda s, q, t, xi, p: (q, t),
    "to_se3": lambda s, q, t, xi, p: (s, q, t),
    "log": lambda s, q, t, xi, p: (s, q, t),
    "exp": lambda s, q, t, xi, p: (xi,),
    "_W_matrix": lambda s, q, t, xi, p: (xi[:, 3:6], xi[:, 6]),
}


@pytest.mark.parametrize("name", sorted(SIM3_CASES))
def test_sim3_ops_match_jax(name):
    rng = np.random.default_rng(3)
    s, q, t, xi = _sim3_inputs(rng)
    p = (rng.normal(size=(N, 3)) * 5).astype(np.float32)
    args = SIM3_CASES[name](s, q, t, xi, p)
    jo = getattr(jsim3, name)(*[jnp.asarray(a) for a in args])
    to = getattr(tsim3, name)(*[torch.from_numpy(a) for a in args])
    jo, to = (jo, to) if isinstance(jo, tuple) else ((jo,), (to,))
    for a, b in zip(jo, to):
        assert b.dtype == torch.float32
        _close(b, a, atol=1e-6, rtol=1e-6)


def test_sim3_log_inverts_exp_near_identity():
    rng = np.random.default_rng(4)
    s, q, t, xi = _sim3_inputs(rng)
    back = tsim3.log(*tsim3.exp(torch.from_numpy(xi)))
    _close(back, xi, atol=2e-6, rtol=1e-5)


@pytest.mark.parametrize("case", ["exact", "noisy", "noisy_fix_scale"])
def test_horn_sim3_matches_jax(case):
    scale = 1.0 if case == "noisy_fix_scale" else 1.4
    p1, p2, _ = make_sim3_problem(n=100, scale=scale,
                                  noise=0.0 if case == "exact" else 0.02,
                                  seed=7)
    fix = case == "noisy_fix_scale"
    jo = jhorn.horn_sim3(p1, p2, fix)
    to = thorn.horn_sim3(_t(p1), _t(p2), fix)
    for a, b in zip(jo, to):
        _close(b, a, atol=1e-5, rtol=1e-5)


def test_top_eigenvector_against_numpy():
    rng = np.random.default_rng(5)
    A = rng.normal(size=(200, 4, 4))
    A = A + A.transpose(0, 2, 1)
    w, v = np.linalg.eigh(A)
    got = thorn.top_eigenvector(torch.from_numpy(A)).numpy()
    want = v[:, :, -1] * np.sign(np.sum(v[:, :, -1] * got, -1))[:, None]
    np.testing.assert_allclose(got, want, atol=1e-9)


def _ransac_problem():
    p1, p2, gt = make_sim3_problem(n=120, noise=0.01, outlier_frac=0.3,
                                   seed=3)
    return (p1, p2, project(p1), project(p2), jnp.ones(120), jnp.ones(120),
            jnp.ones(120, bool)), gt


def test_ransac_scoring_of_jax_samples_matches_jax():
    """The JAX package's 200 hypotheses, drawn by jax.random, scored by the
    port: the same best hypothesis (first of equals), inliers and count."""
    args, _ = _ransac_problem()
    key, n_iters = jax.random.PRNGKey(0), 200
    mask = args[-1]
    probs = mask.astype(jnp.float32) / jnp.maximum(jnp.sum(mask), 1)
    samples = jax.vmap(lambda k: jax.random.choice(
        k, 120, shape=(3,), replace=False, p=probs))(
            jax.random.split(key, n_iters))
    jres = jhorn.sim3_ransac(*args, CAM, key, n_iters=n_iters)
    tres = thorn.score_samples(*[_t(a) for a in args], TCAM, _t(samples))
    assert bool(tres.ok) == bool(jres.ok) is True
    assert int(tres.n_inliers) == int(jres.n_inliers)
    np.testing.assert_array_equal(tres.inliers.numpy(),
                                  np.asarray(jres.inliers))
    for name in ("s", "q", "t"):
        _close(getattr(tres, name), getattr(jres, name), atol=1e-5)


def test_ransac_with_the_ports_own_samples():
    """The port's sampler: distinct indices inside the mask, reproducible
    from the seed; its RANSAC meets tests/test_sim3.py's bounds."""
    args, (s_gt, _, _) = _ransac_problem()
    targs = [_t(a) for a in args]
    mask = torch.rand(120, generator=torch.Generator().manual_seed(1)) < 0.7
    smp = thorn.draw_samples(mask, 300, seed=5)
    assert smp.shape == (300, 3) and bool(mask[smp].all())
    assert bool((smp[:, 0] != smp[:, 1]).all()
                & (smp[:, 1] != smp[:, 2]).all()
                & (smp[:, 0] != smp[:, 2]).all())
    assert torch.equal(smp, thorn.draw_samples(mask, 300, seed=5))
    assert not torch.equal(smp, thorn.draw_samples(mask, 300, seed=6))
    res = thorn.sim3_ransac(*targs, TCAM, seed=0, n_iters=200)
    assert bool(res.ok) and int(res.n_inliers) > 70
    np.testing.assert_allclose(float(res.s), s_gt, rtol=0.02)
    assert int(res.inliers[:30].sum()) < 5


@pytest.mark.parametrize("case", ["free_scale", "fix_scale", "outliers"])
def test_optimize_sim3_matches_jax(case):
    p1, p2, (s_gt, q_gt, t_gt) = make_sim3_problem(
        n=150, noise=0.005, seed=4,
        outlier_frac=0.1 if case == "outliers" else 0.0)
    si, qi, ti = jsim3.inverse(jnp.asarray(s_gt), q_gt, t_gt)
    rng = np.random.default_rng(5)
    ds, dq, dt = jsim3.exp(jnp.asarray(
        np.concatenate([rng.normal(0, 0.015, 6), [0.03]])))
    s0, q0, t0 = jsim3.compose(ds, dq, dt, si, qi, ti)
    args = (s0, q0, t0, p1, p2, project(p1), project(p2), jnp.ones(150),
            jnp.ones(150), jnp.ones(150, bool))
    fix = case == "fix_scale"
    jres = jso.optimize_sim3(*args, CAM, fix_scale=fix)
    tres = tso.optimize_sim3(*[_t(a) for a in args], TCAM, fix_scale=fix)
    for name in ("s", "q", "t"):
        _close(getattr(tres, name), getattr(jres, name), atol=1e-4)
    np.testing.assert_array_equal(tres.inliers.numpy(),
                                  np.asarray(jres.inliers))
    assert int(tres.n_inliers) == int(jres.n_inliers) > 130


def test_blockwise_jacfwd_matches_jacfwd_per_row():
    """The helper behind both LMs: each row's Jacobian equals jacfwd of that
    row alone, in float32."""
    rng = np.random.default_rng(8)
    xi = torch.from_numpy((rng.normal(size=(5, 7)) * 0.1).astype(np.float32))
    p = torch.from_numpy(rng.normal(size=(5, 3)).astype(np.float32))

    def f(x):
        return tsim3.apply(*tsim3.exp(x), p)

    J = blockwise_jacfwd(f, xi)
    assert J.shape == (5, 3, 7) and J.dtype == torch.float32
    for e in range(5):
        want = jacfwd(lambda x: tsim3.apply(*tsim3.exp(x[None]),
                                            p[e:e + 1])[0])(xi[e])
        torch.testing.assert_close(J[e], want, atol=1e-6, rtol=1e-6)


def _drift_loop_graph():
    """tests/test_sim3.py::test_loop_closure_distributes_drift's graph:
    a drifting 10-vertex chain and one true loop edge 9 -> 0."""
    K = 10
    rng = np.random.default_rng(6)
    q_gt, t_gt = [], []
    for k in range(K):
        q_gt.append(np.asarray(jse3.so3_exp_quat(
            jnp.asarray([0.0, 0.25 * k, 0.0]))))
        t_gt.append(np.array([np.sin(0.25 * k), 0.0, np.cos(0.25 * k)],
                             np.float32) * 3)
    q_gt, t_gt = jnp.asarray(np.stack(q_gt)), jnp.asarray(np.stack(t_gt))
    q0, t0 = [q_gt[0]], [t_gt[0]]
    ei, ej, meas = [], [], []
    for k in range(1, K):
        m = jpg.make_edge_measurements(jnp.ones(()), q_gt[k - 1],
                                       t_gt[k - 1], jnp.ones(()), q_gt[k],
                                       t_gt[k])
        ei.append(k - 1)
        ej.append(k)
        meas.append(m)
        dq, dt = jse3.se3_exp(jnp.asarray(rng.normal(size=6) * 0.04))
        qn, tn = jse3.compose(dq, dt, *jse3.compose(m[1], m[2], q0[-1],
                                                    t0[-1]))
        q0.append(qn)
        t0.append(tn)
    meas.append(jpg.make_edge_measurements(jnp.ones(()), q_gt[9], t_gt[9],
                                           jnp.ones(()), q_gt[0], t_gt[0]))
    ei.append(9)
    ej.append(0)
    edges = jpg.PoseGraphEdges(
        i=jnp.asarray(ei, jnp.int32), j=jnp.asarray(ej, jnp.int32),
        s=jnp.asarray([float(m[0]) for m in meas]),
        q=jnp.stack([m[1] for m in meas]), t=jnp.stack([m[2] for m in meas]),
        valid=jnp.ones(len(ei), bool))
    return (jnp.ones(K), jnp.stack(q0), jnp.stack(t0), jnp.ones(K, bool),
            jnp.zeros(K, bool).at[0].set(True)), edges, t_gt


@pytest.mark.parametrize("fix_scale", [True, False])
def test_optimize_pose_graph_matches_jax(fix_scale):
    verts, edges, t_gt = _drift_loop_graph()
    jres = jpg.optimize_pose_graph(*verts, edges, fix_scale=fix_scale,
                                   n_iters=30)
    tedges = convert.pose_graph_edges_from_numpy(
        {k: np.asarray(v) for k, v in edges._asdict().items()}, "cpu")
    tres = tpg.optimize_pose_graph(*[_t(a) for a in verts], tedges,
                                   fix_scale=fix_scale, n_iters=30)
    back = convert.pose_graph_result_to_numpy(tres)
    for name in ("s", "q", "t"):
        np.testing.assert_allclose(back[name], np.asarray(getattr(jres, name)),
                                   atol=1e-4)
    carried = convert.pose_graph_result_from_numpy(
        {k: np.asarray(v) for k, v in jres._asdict().items()}, "cpu")
    np.testing.assert_allclose(carried.final_chi2.numpy(),
                               back["final_chi2"], atol=1e-6)
    assert float(tres.final_chi2) < 1e-3
    err0 = np.linalg.norm(np.asarray(verts[2]) - np.asarray(t_gt), axis=-1)
    err1 = np.linalg.norm(back["t"] - np.asarray(t_gt), axis=-1)
    assert err1.mean() < 0.5 * err0.mean()


def test_pose_graph_ignores_padding_edges():
    """Invalid (padding) edges, even with garbage endpoints and
    measurements, change nothing."""
    verts, edges, _ = _drift_loop_graph()
    f = {k: np.asarray(v) for k, v in edges._asdict().items()}
    pad = {"i": np.array([3, 0, 9], np.int32), "j": np.array([3, 7, 0],
                                                             np.int32),
           "s": np.full(3, 2.0, np.float32), "q": np.tile(
               np.array([0.0, 1.0, 0.0, 0.0], np.float32), (3, 1)),
           "t": np.full((3, 3), 5.0, np.float32), "valid": np.zeros(3, bool)}
    padded = {k: np.concatenate([f[k], pad[k]]) for k in f}
    args = [_t(a) for a in verts]
    a = tpg.optimize_pose_graph(
        *args, convert.pose_graph_edges_from_numpy(f, "cpu"), n_iters=5)
    b = tpg.optimize_pose_graph(
        *args, convert.pose_graph_edges_from_numpy(padded, "cpu"), n_iters=5)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, atol=1e-6, rtol=1e-6)
