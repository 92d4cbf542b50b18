"""The port's EPnP + RANSAC (geometry/epnp.py) against the JAX package's.

- epnp_solve on test_epnp.py's make_pnp inputs, one problem and a batch:
  the pose within 1e-4 of the JAX pose (found 7e-5 in t, 2.4e-6 in q), and
  within test_epnp's 1e-3 of the truth.
- RANSAC on the JAX package's own samples (jax.random.choice with p, keyed
  by PRNGKey(0)). The two score functions are held exactly: the JAX
  package's hypotheses, scored by score_hypotheses, give the same best
  hypothesis, the same inliers and the same pose. The hypotheses themselves
  are float32 EPnP solves on 6 noisy points; on ill-conditioned samples the
  smallest eigenvector of the 12x12 system is chaotic in float32 (on this
  case a tenth of the JAX package's hypotheses lie metres from a float64
  solve of the same samples), so score_samples is held by
  outcome: both accept, inlier counts within 2, inlier sets differing in at
  most 2 correspondences, poses within 0.01 of each other and within
  test_epnp's 0.05 of the truth.
- draw_samples draws only masked indices, distinct within a row.
- The outlier case of test_epnp.py on the port with its own sampling.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

torch.set_num_threads(1)   # several test workers share few cores

from multiagent_orb_slam2_tpu.geometry import epnp as jepnp
from multiagent_orb_slam2_tpu.geometry import se3 as jse3
from multiagent_orb_slam2_tpu_torch.geometry import epnp as tepnp
from multiagent_orb_slam2_tpu_torch.geometry import se3 as tse3
from multiagent_orb_slam2_tpu_torch.geometry.camera import Intrinsics

from test_epnp import CAM, make_pnp, pose_err

TCAM = Intrinsics(*CAM)


def _t(a, dtype=None):
    return torch.from_numpy(np.array(a)).to(dtype or torch.float32)


def jax_samples(mask: np.ndarray, n_iters: int, sample: int, seed: int):
    """The samples of the JAX package's epnp_ransac for this mask and key."""
    m = jnp.asarray(mask)
    keys = jax.random.split(jax.random.PRNGKey(seed), n_iters)
    probs = m.astype(jnp.float32) / jnp.maximum(jnp.sum(m), 1)
    return np.asarray(jax.vmap(lambda k: jax.random.choice(
        k, m.shape[0], shape=(sample,), replace=False, p=probs))(keys))


def _pose_err_t(q, t, q_ref, t_ref):
    dq, dt = tse3.relative(q, t, q_ref, t_ref)
    return float(torch.linalg.norm(tse3.se3_log(dq, dt)))


@pytest.mark.parametrize("batched", [False, True])
def test_epnp_solve_matches_jax(batched):
    seeds = (0, 1, 2) if batched else (0,)
    cases = [make_pnp(noise=0.0, seed=s) for s in seeds]
    n = min(len(c[0]) for c in cases)
    pw = np.stack([np.asarray(c[0])[:n] for c in cases])
    uv = np.stack([np.asarray(c[1])[:n] for c in cases])
    if not batched:
        pw, uv = pw[0], uv[0]
    qj, tj = jepnp.epnp_solve(jnp.asarray(pw), jnp.asarray(uv), CAM)
    qt, tt = tepnp.epnp_solve(_t(pw), _t(uv), TCAM)
    assert qt.shape == qj.shape and tt.shape == tj.shape
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-4)
    for k, (_, _, (q, t), _) in enumerate(cases):
        qk = qt[k] if batched else qt
        tk = tt[k] if batched else tt
        assert pose_err(jnp.asarray(qk.numpy()), jnp.asarray(tk.numpy()),
                        q, t) < 1e-3


@pytest.fixture(scope="module")
def outlier_case():
    pw, uv, (q, t), n_out = make_pnp(n=150, noise=0.5, outlier_frac=0.3,
                                     seed=2)
    N = len(pw)
    mask = np.ones(N, bool)
    mask[::7] = False            # a partial mask, as relocalization's matches
    return dict(pw=np.asarray(pw), uv=np.asarray(uv), q=q, t=t, n_out=n_out,
                mask=mask, samples=jax_samples(mask, 300, 6, 0))


def test_score_hypotheses_matches_jax_exactly(outlier_case):
    """The JAX hypotheses scored by the port: same winner, inliers, pose."""
    c = outlier_case
    S = c["samples"]
    qj, tj = jepnp.epnp_solve(jnp.asarray(c["pw"][S]),
                              jnp.asarray(c["uv"][S]), CAM)
    N = len(c["pw"])
    # the JAX package's scoring of the same hypotheses (epnp_ransac's body)
    pc = np.asarray(jse3.apply(qj[:, None, :], tj[:, None, :],
                               jnp.asarray(c["pw"])[None]))
    z = np.maximum(pc[..., 2], 1e-6)
    u = CAM.fx * pc[..., 0] / z + CAM.cx
    v = CAM.fy * pc[..., 1] / z + CAM.cy
    err2 = (u - c["uv"][None, :, 0]) ** 2 + (v - c["uv"][None, :, 1]) ** 2
    inl = (err2 < 5.991) & (pc[..., 2] > 0.05) & c["mask"][None]
    best = int(np.argmax(inl.sum(-1)))
    rt = tepnp.score_hypotheses(_t(qj), _t(tj), _t(c["pw"]), _t(c["uv"]),
                                torch.ones(N), _t(c["mask"], torch.bool),
                                TCAM)
    assert bool(rt.ok) and int(rt.n_inliers) == int(inl[best].sum())
    np.testing.assert_array_equal(rt.inliers.numpy(), inl[best])
    np.testing.assert_array_equal(rt.q.numpy(), np.asarray(qj)[best])
    np.testing.assert_array_equal(rt.t.numpy(), np.asarray(tj)[best])


def test_score_samples_on_jax_samples(outlier_case):
    """RANSAC of both packages on the JAX samples, held by outcome."""
    c = outlier_case
    N = len(c["pw"])
    mask_j = jnp.asarray(c["mask"])
    rj = jepnp.epnp_ransac(jnp.asarray(c["pw"]), jnp.asarray(c["uv"]),
                           jnp.ones(N), mask_j, CAM, jax.random.PRNGKey(0),
                           n_iters=300)
    rt = tepnp.score_samples(_t(c["pw"]), _t(c["uv"]), torch.ones(N),
                             _t(c["mask"], torch.bool), TCAM,
                             _t(c["samples"], torch.int64))
    assert bool(rj.ok) and bool(rt.ok)
    assert abs(int(rt.n_inliers) - int(rj.n_inliers)) <= 2
    assert int(np.sum(rt.inliers.numpy() != np.asarray(rj.inliers))) <= 2
    assert _pose_err_t(rt.q, rt.t, _t(rj.q), _t(rj.t)) < 0.01
    q, t = c["q"], c["t"]
    assert pose_err(jnp.asarray(rt.q.numpy()), jnp.asarray(rt.t.numpy()),
                    q, t) < 0.05
    assert pose_err(rj.q, rj.t, q, t) < 0.05


def test_draw_samples_masked_and_distinct():
    mask = torch.zeros(50, dtype=torch.bool)
    mask[[1, 3, 4, 8, 9, 20, 31, 32, 40, 49]] = True
    s = tepnp.draw_samples(mask, 200, 6, seed=7)
    assert s.shape == (200, 6)
    assert bool(mask[s].all())
    srt = torch.sort(s, dim=-1).values
    assert bool((srt[:, 1:] != srt[:, :-1]).all())
    # the seed decides the draw
    assert torch.equal(s, tepnp.draw_samples(mask, 200, 6, seed=7))
    assert not torch.equal(s, tepnp.draw_samples(mask, 200, 6, seed=8))


def test_ransac_with_outliers():
    """test_epnp.py's outlier case, on the port's own sampling."""
    pw, uv, (q, t), n_out = make_pnp(n=150, noise=0.5, outlier_frac=0.3,
                                     seed=2)
    N = len(pw)
    res = tepnp.epnp_ransac(_t(pw), _t(uv), torch.ones(N),
                            torch.ones(N, dtype=torch.bool), TCAM, seed=0,
                            n_iters=300)
    assert bool(res.ok)
    assert pose_err(jnp.asarray(res.q.numpy()), jnp.asarray(res.t.numpy()),
                    q, t) < 0.05
    inl = res.inliers.numpy()
    assert inl[:n_out].mean() < 0.2       # outliers rejected
    assert inl[n_out:].mean() > 0.7       # inliers kept
