"""The port's point-sharded bundle adjustment (parallel/dist_ba.py) against
the JAX package's, on the CPU over gloo process groups.

World size 1 runs in this process (a gloo group over a HashStore); world
sizes 2 and 4 are spawned ranks (``parallel.multihost.run_ranks``, a
FileStore, one thread a rank, a timeout). The JAX side runs
``distributed_ba_solve`` on ``make_mesh(1 / 2 / 4)`` of the conftest's
virtual devices. Both start PCG from zero in every iteration.

Tolerances (the standing ``ba_solve(_fast)`` row): q and t 1e-4, the
gathered points 1e-3 m (found: q 2.1e-7, t 1.2e-6, points 6.2e-5 m over
every pair of world sizes). Replicated outputs are bit-equal across ranks.
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist

pytestmark = pytest.mark.e2e

from multiagent_orb_slam2_tpu.parallel import dist_ba as jdist
from multiagent_orb_slam2_tpu.optim.ba import ba_solve
from multiagent_orb_slam2_tpu_torch.parallel import dist_ba, multihost

import torch_dist_cases as cases
import torch_parity  # noqa: F401  (one torch thread per test worker)
from test_ba import CAM, make_ba_problem, pose_rmse

WORLDS = (1, 2, 4)
KW = {"n_iters": 10}
Q_TOL, T_TOL, PW_TOL = 1e-4, 1e-4, 1e-3


def solve_in_process(fields, **kw):
    """World size 1 in this process: a gloo group over a HashStore."""
    dist.init_process_group("gloo", store=dist.HashStore(), world_size=1,
                            rank=0)
    try:
        return [cases.dist_ba_rank(0, 1, torch.device("cpu"), fields, kw)]
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs():
    prob, gt = make_ba_problem(K=8, P=400, M=8)
    fields = {k: np.asarray(v) for k, v in prob._asdict().items()}
    jax_out = {n: [np.asarray(a) for a in jdist.distributed_ba_solve(
        prob, CAM, jdist.make_mesh(n), **KW)] for n in WORLDS}
    port = {1: solve_in_process(fields, **KW)}
    for w in (2, 4):
        port[w] = multihost.run_ranks(cases.dist_ba_rank, w, (fields, KW),
                                      backend="gloo", device="cpu",
                                      timeout=120)
    return dict(prob=prob, gt=gt, jax=jax_out, port=port)


@pytest.mark.parametrize("world", WORLDS)
def test_matches_jax_distributed_solve(runs, world):
    r = runs["port"][world][0]
    jq, jt, jpw = runs["jax"][world]
    assert np.abs(r["q"] - jq).max() <= Q_TOL
    assert np.abs(r["t"] - jt).max() <= T_TOL
    assert r["pw"].shape == jpw.shape
    assert np.abs(r["pw"] - jpw).max() <= PW_TOL


@pytest.mark.parametrize("world", (2, 4))
def test_replicated_outputs_bit_equal_across_ranks(runs, world):
    ranks = runs["port"][world]
    assert len(ranks) == world
    for r in ranks[1:]:
        for k in ("q", "t", "pw"):
            assert np.array_equal(r[k], ranks[0][k]), k


@pytest.mark.parametrize("world", (2, 4))
def test_world_sizes_agree(runs, world):
    # the same solve at another sharding: only the order of the sums moves
    a, b = runs["port"][1][0], runs["port"][world][0]
    assert np.abs(a["q"] - b["q"]).max() <= Q_TOL
    assert np.abs(a["t"] - b["t"]).max() <= T_TOL
    assert np.abs(a["pw"] - b["pw"]).max() <= PW_TOL


def test_reaches_the_single_solver_floor(runs):
    # tests/test_dist_ba.py's criterion, on the 4-rank solve
    import jax.numpy as jnp
    q_gt, t_gt, _ = runs["gt"]
    r = runs["port"][4][0]
    err = pose_rmse(jnp.asarray(r["q"]), jnp.asarray(r["t"]), q_gt, t_gt)
    ref = ba_solve(runs["prob"], CAM, n_iters=10, chunk=100)
    err_ref = pose_rmse(ref.q, ref.t, q_gt, t_gt)
    assert err < max(1.5 * err_ref, 1.2e-2), (err, err_ref)


def test_shard_and_gather_round_trip():
    fields = {k: np.asarray(v) for k, v in
              make_ba_problem(K=4, P=40, M=4, seed=2)[0]._asdict().items()}
    from multiagent_orb_slam2_tpu_torch import convert
    prob = convert.ba_problem_from_numpy(fields, "cpu")
    shards = [dist_ba.shard_problem(prob, r, 4) for r in range(4)]
    assert all(s.pw.shape == (10, 3) and s.obs_kf.shape == (10, 4)
               and torch.equal(s.q, prob.q) for s in shards)
    assert torch.equal(torch.cat([s.obs_uvr for s in shards]), prob.obs_uvr)
    with pytest.raises(ValueError):
        dist_ba.shard_problem(prob, 0, 3)
