"""Each cell driven end to end on the CPU through the port's plain paths
at a small size, and the checks that decide ``correct`` seen to fail: with
the timed path broken underneath (a solve that returns its state
unchanged, half of the problem left out, an answer altered where it is
produced) and with the control, the plain reference computed with TF32
operands, in the program's place."""
import pytest
import torch

from slambench import manifest, run
from slambench.drivers import gba_replay
from slambench.reference import ba as ref_ba
from slambench.tests.sizes import small_gba, small_stream

GBA = ["kitti00_split2.gba", "euroc_mh01_split2.gba"]


def _gba(name):
    return small_gba(manifest.cell(name))


@pytest.mark.parametrize("name", GBA)
def test_gba_cell_runs_and_is_correct(name):
    cell = _gba(name)
    out = run.execute(cell, 2 ** 31 + 3, 2.0, False, "cpu")
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    line = run.result_line(cell, out, False, {"platform": "cpu"})
    assert set(line["metrics"]) == {"gba_ms", "setup_s"}
    assert list(line)[-1] == "checks"
    assert set(line["checks"]) == set(cell.params["limits"])


class _Unchanged(gba_replay.Solver):
    def __call__(self, prob):
        return prob.q, prob.t, prob.pw, super().__call__(prob)[3]


class _HalfLeftOut(gba_replay.Solver):
    def __call__(self, prob):
        P = prob.obs_kf.shape[0]
        keep = torch.arange(P) < P // 2
        half = prob._replace(obs_mask=prob.obs_mask & keep[:, None])
        return super().__call__(half)


class _Altered(gba_replay.Solver):
    def __call__(self, prob):
        q, t, pw, cost = super().__call__(prob)
        t = t.clone()
        t[prob.pose_valid.nonzero()[-1, 0]] += 0.3
        return q, t, pw, cost


@pytest.mark.parametrize("name", GBA)
@pytest.mark.parametrize("fault", [_Unchanged, _HalfLeftOut, _Altered])
def test_gba_faults_read_not_correct(name, fault, monkeypatch):
    monkeypatch.setattr(gba_replay, "Solver", fault)
    out = run.execute(_gba(name), 17, 2.0, False, "cpu")
    assert not out["correct"], out["checks"]


class _Control(gba_replay.Solver):
    """The plain reference with TF32 operands in the program's place."""

    def __call__(self, prob):
        f = {k: getattr(prob, k) for k in prob._fields}
        R, t, pw, c = ref_ba.solve(f, self.cam._asdict(), self.n_iters,
                                   self.gba["chi2_mono"],
                                   self.gba["chi2_stereo"], precision="tf32")
        return R, t, pw, c


@pytest.mark.parametrize("name", GBA)
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_gba_control_reads_not_correct(name, seed, monkeypatch):
    monkeypatch.setattr(gba_replay, "Solver", _Control)
    out = run.execute(_gba(name), seed, 3.0, False, "cpu")
    assert not out["correct"], out["checks"]
    assert out["checks"]["cost_gap"]["value"] > \
        out["checks"]["cost_gap"]["limit"]


def test_stream_cell_runs_and_is_correct():
    cell = small_stream(manifest.cell("kitti00_split2.stream"))
    out = run.execute(cell, 2 ** 32 + 1, 10.0, False, "cpu")
    assert out["correct"], out["checks"]
    assert set(run.result_line(cell, out, False, {})["metrics"]) == {
        "local_ba_ms", "setup_s"}


def _unchanged(solve):
    def f(prob, *a, **k):
        res = solve(prob, *a, **k)
        return res._replace(q=prob.q, t=prob.t, pw=prob.pw)
    return f


def _half_left_out(solve):
    def f(prob, *a, **k):
        P = prob.obs_kf.shape[0]
        keep = torch.arange(P, device=prob.obs_kf.device) % 2 == 0
        return solve(prob._replace(obs_mask=prob.obs_mask & keep[:, None]),
                     *a, **k)
    return f


def _cost_altered(solve):
    def f(prob, *a, **k):
        res = solve(prob, *a, **k)
        return res._replace(cost=res.cost * 1.1)
    return f


@pytest.mark.parametrize("fault", [_unchanged, _half_left_out, _cost_altered])
def test_stream_faulty_local_ba_reads_not_correct(fault, monkeypatch):
    from multiagent_orb_slam2_tpu_torch.optim import ba
    monkeypatch.setattr(ba, "ba_solve_fast", fault(ba.ba_solve_fast))
    cell = small_stream(manifest.cell("kitti00_split2.stream"))
    out = run.execute(cell, 5, 10.0, False, "cpu")
    assert not out["correct"], out["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", GBA)
def test_gba_cell_on_the_card(name, cuda):
    out = run.execute(manifest.cell(name), 2 ** 31 + 99, 2.0, True, cuda)
    assert out["correct"], out["checks"]
    assert 0 < out["busy_s"] <= out["window_s"]


def _k1_unchanged(pose):
    def f(q0, t0, obs, *a, **k):
        q, t, inl, n = pose(q0, t0, obs, *a, **k)
        return q0.clone(), t0.clone(), inl, n
    return f


def _k1_half_left_out(pose):
    def f(q0, t0, obs, *a, **k):
        keep = torch.arange(obs.mask.shape[-1], device=obs.mask.device) % 2
        return pose(q0, t0, obs._replace(mask=obs.mask & (keep == 0)),
                    *a, **k)
    return f


def _k1_altered(pose):
    def f(q0, t0, obs, *a, **k):
        q, t, inl, n = pose(q0, t0, obs, *a, **k)
        return q, t + 0.01, inl, n
    return f


@pytest.mark.parametrize("fault", [_k1_unchanged, _k1_half_left_out,
                                   _k1_altered])
def test_stream_faulty_pose_optimization_reads_not_correct(fault,
                                                           monkeypatch):
    from multiagent_orb_slam2_tpu_torch.optim import pose_opt
    monkeypatch.setattr(pose_opt, "pose_optimize",
                        fault(pose_opt.pose_optimize))
    cell = small_stream(manifest.cell("kitti00_split2.stream"))
    out = run.execute(cell, 5, 10.0, False, "cpu")
    assert not out["correct"], out["checks"]
    assert out["checks"]["k1_centre_gap_m"]["value"] > \
        out["checks"]["k1_centre_gap_m"]["limit"]


def test_stream_control_reads_not_correct():
    """The plain pose optimization with TF32 operands in K1's place."""
    cell = small_stream(manifest.cell("kitti00_split2.stream"))
    out = run.execute(cell, 5, 10.0, False, "cpu", control=True)
    assert not out["correct"], out["checks"]
