"""The port's pose-only optimizer (optim/pose_opt.py, the module that holds
the CUDA kernel): its plain PyTorch version against (a) the JAX package's XLA
twin and (b) the Pallas kernel body itself run in interpret mode; and the
schedule the CUDA kernel runs (one pass per LM iteration over the compacted
valid observations), transcribed in PyTorch, against both."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(1)   # several test workers share few cores

from multiagent_orb_slam2_tpu.config import OptimizerConfig as JOptCfg
from multiagent_orb_slam2_tpu.geometry.camera import Intrinsics as JIntr
from multiagent_orb_slam2_tpu.optim import pose_opt as jpo
from multiagent_orb_slam2_tpu_torch import convert
from multiagent_orb_slam2_tpu_torch.config import OptimizerConfig as TOptCfg
from multiagent_orb_slam2_tpu_torch.geometry.camera import Intrinsics as TIntr
from multiagent_orb_slam2_tpu_torch.optim import pose_opt as tpo

from torch_parity import interpreted_pallas_call

JCAM = JIntr(fx=450.0, fy=450.0, cx=320.0, cy=240.0, bf=45.0)
TCAM = TIntr(*JCAM)
N = 256


def _quat_mul(a, b):
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                     w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                     w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                     w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2])


def _small_quat(rng, scale):
    w = rng.normal(size=3) * scale
    q = np.concatenate([[1.0], 0.5 * w])
    return q / np.linalg.norm(q)


def _rot(q, v):
    u = np.cross(q[1:], v)
    return v + 2.0 * (q[0] * u + np.cross(q[1:], u))


def make_problem(seed, stereo_frac=1.0, n_outliers=20, n_masked=0,
                 n_behind=0):
    """Seeded pose problem of N observations as numpy arrays."""
    rng = np.random.default_rng(seed)
    pw = np.stack([rng.uniform(-3, 3, N), rng.uniform(-2, 2, N),
                   rng.uniform(4, 15, N)], axis=-1)
    q_true = _small_quat(rng, 0.1)
    t_true = rng.normal(size=3) * 0.1
    if n_behind:
        pw[-n_behind:, 2] = rng.uniform(-6, -2, n_behind)
    pc = _rot(q_true, pw) + t_true
    z = np.where(np.abs(pc[:, 2]) < 0.1, 0.1, pc[:, 2])
    u = JCAM.fx * pc[:, 0] / z + JCAM.cx
    v = JCAM.fy * pc[:, 1] / z + JCAM.cy
    obs = np.stack([u, v, u - JCAM.bf / z], -1) + rng.normal(0, 0.4, (N, 3))
    obs[:n_outliers, :2] += rng.uniform(20, 80, (n_outliers, 2)) \
        * rng.choice([-1, 1], (n_outliers, 2))
    is_stereo = rng.random(N) < stereo_frac
    obs[~is_stereo, 2] = -1.0
    mask = np.ones(N, bool)
    if n_masked:
        obs[40:40 + n_masked] += 500.0
        mask[40:40 + n_masked] = False
    level = rng.integers(0, 4, N)
    q0 = _quat_mul(_small_quat(rng, 0.04), q_true)
    t0 = t_true + rng.normal(size=3) * 0.05
    f32 = np.float32
    return dict(q0=q0.astype(f32), t0=t0.astype(f32),
                obs=dict(pw=pw.astype(f32), obs=obs.astype(f32),
                         inv_sigma2=(1.0 / 1.2 ** (2 * level)).astype(f32),
                         is_stereo=is_stereo, mask=mask))


CASES = {
    "stereo": dict(seed=1),
    "mixed_stereo_mono": dict(seed=2, stereo_frac=0.6),
    "mono": dict(seed=3, stereo_frac=0.0),
    "masked_out": dict(seed=4, n_masked=80),
    "behind_camera": dict(seed=5, n_behind=30),
}


def _run_torch(p):
    obs = convert.pose_obs_from_numpy(p["obs"], "cpu")
    return tpo.pose_optimize(torch.from_numpy(p["q0"]),
                             torch.from_numpy(p["t0"]), obs, TCAM, TOptCfg())


def _jax_obs(p):
    return jpo.PoseObs(**{k: jnp.asarray(v) for k, v in p["obs"].items()})


def _compare(jout, tout, n_valid):
    """1e-5 in q and t, inlier masks equal on >= 99 %, n_inliers within 2."""
    q, t, inl, n = (np.asarray(a) for a in jout)
    q2, t2, inl2, n2 = (a.numpy() for a in tout)
    np.testing.assert_allclose(q2, q, atol=1e-5, rtol=0)
    np.testing.assert_allclose(t2, t, atol=1e-5, rtol=0)
    assert np.mean(inl == inl2) >= 0.99
    assert abs(int(n) - int(n2)) <= 2
    assert int(n2) == int(inl2.sum()) <= n_valid


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_xla_twin(case):
    p = make_problem(**CASES[case])
    jout = jpo._pose_optimize_xla(jnp.asarray(p["q0"]), jnp.asarray(p["t0"]),
                                  _jax_obs(p), JCAM, JOptCfg())
    tout = _run_torch(p)
    _compare(jout, tout, int(p["obs"]["mask"].sum()))
    if case == "masked_out":
        assert not tout[2].numpy()[40:120].any()
    if case == "behind_camera":
        assert not tout[2].numpy()[-30:].any()
    # the optimizer moved towards the data: most clean observations inliers
    assert int(tout[3]) >= 0.6 * int(p["obs"]["mask"].sum()) - 30


@pytest.fixture(scope="module")
def interpreted_pallas():
    """pose_optimize_pallas with the kernel body run by the Pallas
    interpreter (torch_parity.interpreted_pallas_call)."""
    from multiagent_orb_slam2_tpu.optim import pose_opt_pallas as jpp
    with interpreted_pallas_call():
        yield jpp.pose_optimize_pallas


@pytest.mark.parametrize("case", ["stereo", "mixed_stereo_mono",
                                  "behind_camera"])
def test_plain_matches_interpreted_pallas_body(case, interpreted_pallas):
    p = make_problem(**CASES[case])
    jout = interpreted_pallas(jnp.asarray(p["q0"]), jnp.asarray(p["t0"]),
                              _jax_obs(p), JCAM, JOptCfg())
    _compare(jout, _run_torch(p), int(p["obs"]["mask"].sum()))


def test_batched_equals_single_calls():
    """B = 3 problems in one call against three single calls: identical
    schedule per problem, so 1e-6 in q and t and equal inlier masks."""
    ps = [make_problem(**CASES[c]) for c in ("stereo", "mixed_stereo_mono",
                                             "masked_out")]
    singles = [_run_torch(p) for p in ps]
    obs = convert.pose_obs_from_numpy(
        {k: np.stack([p["obs"][k] for p in ps]) for k in ps[0]["obs"]}, "cpu")
    q, t, inl, n = tpo.pose_optimize(
        torch.from_numpy(np.stack([p["q0"] for p in ps])),
        torch.from_numpy(np.stack([p["t0"] for p in ps])), obs, TCAM)
    assert q.shape == (3, 4) and inl.shape == (3, N) and n.shape == (3,)
    for b, (qs, ts, inls, ns) in enumerate(singles):
        np.testing.assert_allclose(q[b].numpy(), qs.numpy(), atol=1e-6)
        np.testing.assert_allclose(t[b].numpy(), ts.numpy(), atol=1e-6)
        assert torch.equal(inl[b], inls) and int(n[b]) == int(ns)


def test_dispatch_is_on_device_only():
    """A CPU tensor takes the plain version and launches nothing."""
    before = tpo.pose_optimize.launches
    _run_torch(make_problem(seed=7))
    assert tpo.pose_optimize.launches == before


def test_residuals_module_matches_jax():
    """optim/residuals.py function by function: 1e-5 relative (pixel-scaled
    Jacobians reach 1e3)."""
    from multiagent_orb_slam2_tpu.optim import residuals as jres
    from multiagent_orb_slam2_tpu_torch.optim import residuals as tres
    p = make_problem(seed=9, stereo_frac=0.5)
    o = p["obs"]
    ja = [jnp.asarray(a) for a in (p["q0"], p["t0"], o["pw"])]
    ta = [torch.from_numpy(a) for a in (p["q0"], p["t0"], o["pw"])]
    st_j, st_t = jnp.asarray(o["is_stereo"]), torch.from_numpy(o["is_stereo"])
    rj, pcj = jres.project_residual(JCAM, *ja, jnp.asarray(o["obs"]), st_j)
    rt, pct = tres.project_residual(TCAM, *ta, torch.from_numpy(o["obs"]), st_t)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(pct.numpy(), np.asarray(pcj), atol=1e-5)
    for a, b in zip(jres.jacobians(JCAM, *ja, st_j),
                    tres.jacobians(TCAM, *ta, st_t)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-4)
    chi2 = np.abs(np.asarray(rj)).sum(-1).astype(np.float32)
    np.testing.assert_allclose(
        tres.huber_weight(torch.from_numpy(chi2), 5.991).numpy(),
        np.asarray(jres.huber_weight(jnp.asarray(chi2), 5.991)), rtol=1e-6)


def one_pass_schedule(p, cfg=TOptCfg(), accepts=None):
    """The CUDA kernel's schedule in plain PyTorch, for one pose: the valid
    observations compacted in slot order; ONE pass per LM iteration, at the
    candidate pose; on accept its H, b and cost become the next iteration's,
    on reject the stored ones stay and only lambda changes; a fresh pass
    (which after the first round also relabels) where a round starts; one
    last relabelling pass counts the inliers. `accepts` collects the accept
    decisions. Returns what pose_optimize returns."""
    o = p["obs"]
    keep = np.flatnonzero(o["mask"])                  # stable compaction
    f32 = torch.float32
    pw, ob, isig = (torch.from_numpy(o[k][keep])[None].to(f32)
                    for k in ("pw", "obs", "inv_sigma2"))
    stf = torch.from_numpy(o["is_stereo"][keep])[None].to(f32)
    d2 = cfg.chi2_stereo * stf + cfg.chi2_mono * (1.0 - stf)
    eye = torch.eye(6)
    pose = torch.cat([torch.from_numpy(p["q0"]), torch.from_numpy(p["t0"])])[None]
    inl = torch.ones_like(isig)
    per_round = cfg.pose_opt_iters + 1
    n_steps = cfg.pose_opt_rounds * per_round
    cand, cur, lam = pose, None, 1e-3
    for step in range(n_steps + 1):
        rnd, it = divmod(step, per_round)
        fresh = it == 0
        huber = rnd < cfg.pose_opt_rounds - 1
        at = pose if fresh else cand
        if fresh and step > 0:
            *_, chi2, zok = tpo._residual(at, pw, ob, isig, stf, TCAM)
            inl = (chi2 <= d2).to(f32) * zok
        if step == n_steps:
            break
        nxt = tpo._normal_equations(at, pw, ob, isig, stf, d2, inl, TCAM,
                                    huber)
        accept = fresh or bool(nxt[2] < cur[2])
        if accept:
            pose, cur = at, nxt
        if fresh:
            lam = 1e-3
        else:
            accepts.append(accept) if accepts is not None else None
            lam = min(max(lam * 0.5 if accept else lam * 4.0, 1e-8), 1e6)
        if it < cfg.pose_opt_iters:
            H, b, _ = cur
            diag = torch.diagonal(H, dim1=-2, dim2=-1)
            Hd = H + eye * (diag * np.float32(lam) + 1e-9)[:, None, :]
            cand = tpo._se3_update(tpo._chol_solve6(Hd, b), pose)
    inlier = torch.zeros(N, dtype=torch.bool)
    inlier[torch.from_numpy(keep)] = inl[0] > 0.5
    return pose[0, :4], pose[0, 4:], inlier, inlier.sum().to(torch.int32)


SCHEDULE_CASES = {
    "stereo_20_outliers": dict(seed=1),
    "mixed_stereo_mono": dict(seed=2, stereo_frac=0.6),
    "behind_camera": dict(seed=5, n_behind=30),
    "masked_80_percent": dict(seed=6, n_masked=205),
}


@pytest.mark.parametrize("case", sorted(SCHEDULE_CASES))
def test_one_pass_schedule_matches_plain_and_xla(case):
    """The kernel's schedule against the plain version and the XLA twin on
    the 256-observation problem with 20 gross outliers: q, t within 1e-5,
    inlier labels equal. At least one step is rejected on every problem (so
    the kept H, b, cost path is taken), and with 80 % of the slots masked the
    masked ones stay outliers."""
    p = make_problem(**SCHEDULE_CASES[case])
    if case == "masked_80_percent":
        assert p["obs"]["mask"].sum() == N - 205
    accepts = []
    got = one_pass_schedule(p, accepts=accepts)
    assert len(accepts) == 40 and not all(accepts) and any(accepts)
    plain = _run_torch(p)
    xla = jpo._pose_optimize_xla(jnp.asarray(p["q0"]), jnp.asarray(p["t0"]),
                                 _jax_obs(p), JCAM, JOptCfg())
    for want in (tuple(a.numpy() for a in plain),
                 tuple(np.asarray(a) for a in xla)):
        np.testing.assert_allclose(got[0].numpy(), want[0], atol=1e-5, rtol=0)
        np.testing.assert_allclose(got[1].numpy(), want[1], atol=1e-5, rtol=0)
        assert np.array_equal(got[2].numpy(), want[2])
        assert int(got[3]) == int(want[3])
    assert not got[2].numpy()[~p["obs"]["mask"]].any()


def test_one_pass_schedule_without_valid_observation():
    """No valid observation: the initial pose and 0 inliers, as the plain
    version returns."""
    p = make_problem(seed=8)
    p["obs"]["mask"][:] = False
    got = one_pass_schedule(p)
    plain = _run_torch(p)
    for out in (got, plain):
        assert np.array_equal(out[0].numpy(), p["q0"])
        assert np.array_equal(out[1].numpy(), p["t0"])
        assert not out[2].any() and int(out[3]) == 0


def test_normal_equations_are_symmetric_and_weighted():
    """H is symmetric, and a masked-out observation adds nothing to H, b or
    the cost (what lets the kernel drop it from the loop)."""
    p = make_problem(seed=3, stereo_frac=0.5, n_masked=60)
    o = p["obs"]
    f32 = torch.float32
    qt = torch.cat([torch.from_numpy(p["q0"]), torch.from_numpy(p["t0"])])[None]
    stf = torch.from_numpy(o["is_stereo"])[None].to(f32)
    d2 = 7.815 * stf + 5.991 * (1.0 - stf)
    args = [torch.from_numpy(o[k])[None].to(f32)
            for k in ("pw", "obs", "inv_sigma2")]
    mask = torch.from_numpy(o["mask"])[None].to(f32)
    H, b, cost = tpo._normal_equations(qt, *args, stf, d2, mask, TCAM, True)
    assert torch.allclose(H, H.transpose(1, 2), rtol=1e-6, atol=1e-3)
    keep = o["mask"]
    args_c = [a[:, keep] for a in args]
    Hc, bc, cc = tpo._normal_equations(qt, *args_c, stf[:, keep], d2[:, keep],
                                       mask[:, keep], TCAM, True)
    scale = float(H.abs().max())
    assert float((H - Hc).abs().max()) <= 1e-5 * scale
    assert float((b - bc).abs().max()) <= 1e-5 * float(b.abs().max())
    assert abs(float(cost - cc)) <= 1e-5 * float(cost)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the pose kernel has no CPU mode; "
                    "chip_smoke.py holds it against the plain version")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_matches_plain_on_the_card(cuda_device):
    """On the card: kernel against the plain version on the same CUDA
    tensors, 1e-5 in q and t, inlier masks equal on >= 99 %."""
    p = make_problem(seed=1)
    obs = convert.pose_obs_from_numpy(p["obs"], cuda_device)
    q0 = torch.from_numpy(p["q0"]).to(cuda_device)
    t0 = torch.from_numpy(p["t0"]).to(cuda_device)
    before = tpo.pose_optimize.launches
    k = tpo.pose_optimize(q0, t0, obs, TCAM)
    assert tpo.pose_optimize.launches == before + 1
    pl_ = tpo._pose_optimize_plain(q0[None], t0[None],
                                   tpo.PoseObs(*[a[None] for a in obs]), TCAM)
    assert (k[0] - pl_[0][0]).abs().max() <= 1e-5
    assert (k[1] - pl_[1][0]).abs().max() <= 1e-5
    assert (k[2] == pl_[2][0]).float().mean() >= 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("valid", [0.2, 1.0])
def test_kernel_matches_plain_in_both_mask_regimes(cuda_device, valid):
    """On the card, N = 2048: a fifth of the slots valid (what tracking
    gives the kernel) and all of them; 1e-5 in q and t, inlier labels equal
    on >= 99 %, two launches bit-identical."""
    rng = np.random.default_rng(11)
    big = 2048
    pw = np.stack([rng.uniform(-10, 10, big), rng.uniform(-3, 3, big),
                   rng.uniform(4, 40, big)], -1)
    q = _small_quat(rng, 0.05)
    t = rng.normal(size=3) * 0.05
    pc = _rot(q, pw) + t
    u = TCAM.fx * pc[:, 0] / pc[:, 2] + TCAM.cx
    v = TCAM.fy * pc[:, 1] / pc[:, 2] + TCAM.cy
    obs = np.stack([u, v, u - TCAM.bf / pc[:, 2]], -1) \
        + rng.normal(0, 0.5, (big, 3))
    obs[:200, :2] += 50.0
    f32 = np.float32
    fields = dict(pw=pw.astype(f32), obs=obs.astype(f32),
                  inv_sigma2=(1.0 / 1.2 ** (2 * rng.integers(0, 8, big))
                              ).astype(f32),
                  is_stereo=rng.random(big) < 0.8,
                  mask=rng.random(big) < valid)
    o = convert.pose_obs_from_numpy(fields, cuda_device)
    q0 = torch.tensor(_quat_mul(_small_quat(rng, 0.02), q), dtype=torch.float32,
                      device=cuda_device)
    t0 = torch.tensor(t + rng.normal(size=3) * 0.05, dtype=torch.float32,
                      device=cuda_device)
    k = tpo.pose_optimize(q0, t0, o, TCAM)
    again = tpo.pose_optimize(q0, t0, o, TCAM)
    assert all(torch.equal(a, b) for a, b in zip(k, again))
    pl_ = tpo._pose_optimize_plain(q0[None], t0[None],
                                   tpo.PoseObs(*[a[None] for a in o]), TCAM)
    assert (k[0] - pl_[0][0]).abs().max() <= 1e-5
    assert (k[1] - pl_[1][0]).abs().max() <= 1e-5
    assert (k[2] == pl_[2][0]).float().mean() >= 0.99
    assert not k[2][~o.mask].any()
