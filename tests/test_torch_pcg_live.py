"""The live poses of PCG (optim/pcg.live_poses, the test csrc/pcg.cu applies
on the card before it solves) against the JAX package's ba_kernels.pcg_solve
on the whole system, on the CPU.

A pose is inert where its six rows of S are exactly zero outside its own
6x6 block and its block of r0 = rhs - S x0 is exactly zero: CG leaves such a
pose at x0 bit for bit, so CG on the live rows and columns alone is the same
function. Held here:

- on the reduced camera systems of a port local BA (the world of
  tests/test_torch_local_ba.py: 6 keyframes in 32 slots, the origin fixed,
  26 slots invalid), cold (the first LM build, x0 = 0) and warm (the second,
  x0 the first step), the live list is exactly the window's free poses; the
  JAX solve of the whole system leaves the inert rows at x0 bit for bit and
  agrees with the port's plain solve of S[live, live] (x0 put back on the
  inert rows) within 1e-5 of x's scale after 2 iterations (found 1.7e-6
  cold, 7.3e-6 warm; the port's plain solve of the whole system is 1.7e-5
  from JAX's there) and, after 32, the live solve's error in the energy norm
  against a float64 solve is no worse than 1.1 x JAX's + 1e-6 (both stand
  at float32's floor there, 5e-5 warm, where the iterates of any two
  summation orders part by as much: the port's whole-system solve is 6.6e-5
  from JAX's in that norm);
- edge cases: an identity row with a nonzero warm start is live, one nonzero
  entry off the diagonal block makes its pose live, a seeded system with
  every pose coupled lists every pose, an all-inert system lists none and
  both packages return x0; a system past D = 924, whose r0 rows the kernel
  sums in float64, lists its scattered live poses.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from multiagent_orb_slam2_tpu.optim import ba_kernels as jbk
from multiagent_orb_slam2_tpu_torch.optim import ba_kernels as tbk
from multiagent_orb_slam2_tpu_torch.optim import pcg
from multiagent_orb_slam2_tpu_torch.runtime import steps as tsteps

from torch_parity import TCFG, port_tracker_after


class _Captured(Exception):
    pass


@pytest.fixture(scope="module")
def lba_systems():
    """The reduced camera systems (S, rhs, Dinv, x0) of the first two LM
    builds of a port local BA around the newest keyframe, and the problem's
    free poses (valid and not fixed)."""
    _, shared, _ = port_tracker_after(8)
    calls, free = [], {}
    real_solve, real_fast = pcg.pcg_solve, tsteps.ba_mod.ba_solve_fast

    def keep_problem(prob, *a, **kw):
        free["mask"] = (prob.pose_valid & ~prob.pose_fixed).clone()
        return real_fast(prob, *a, **kw)

    def keep_system(S, rhs, Dinv, n_iters=48, x0=None):
        calls.append((S.clone(), rhs.clone(), Dinv.clone(), x0.clone()))
        if len(calls) == 2:
            raise _Captured
        return real_solve(S, rhs, Dinv, n_iters, x0)

    pcg.pcg_solve, tsteps.ba_mod.ba_solve_fast = keep_system, keep_problem
    try:
        tsteps.local_ba_step(shared.state, shared.n_kf - 1, TCFG)
    except _Captured:
        pass
    finally:
        pcg.pcg_solve, tsteps.ba_mod.ba_solve_fast = real_solve, real_fast
    assert len(calls) == 2
    return {"cold": calls[0], "warm": calls[1]}, free["mask"]


def _rows(poses):
    return (6 * poses[:, None] + torch.arange(6)[None]).reshape(-1)


def _solve_live(S, rhs, Dinv, n_iters, x0):
    """The port's plain pcg_solve of S[live, live] from x0[live], x0 put back
    on the inert rows (on these systems S[live, inert] x0[inert] is zero, so
    the live rows' r0 is the whole rows' r0 that the kernel forms)."""
    poses, n = pcg.live_poses(S, rhs, Dinv, x0)
    poses = poses[:int(n)].long()
    idx = _rows(poses)
    x = x0.clone()
    x[idx] = tbk.pcg_solve(S[idx][:, idx].contiguous(), rhs[idx],
                           Dinv[poses], n_iters, x0[idx])
    return x


def _jax_solve(S, rhs, Dinv, n_iters, x0):
    return torch.from_numpy(np.asarray(jbk.pcg_solve(
        jnp.asarray(S.numpy()), jnp.asarray(rhs.numpy()),
        jnp.asarray(Dinv.numpy()), n_iters, jnp.asarray(x0.numpy()))).copy())


def _scale_err(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def test_lba_live_list_is_the_window_free_poses(lba_systems):
    systems, free = lba_systems
    want = torch.nonzero(free).flatten().to(torch.int32)
    assert 0 < want.numel() < free.numel()
    assert not bool(free[0])                   # the origin is fixed
    for S, rhs, Dinv, x0 in systems.values():
        poses, n = pcg.live_poses(S, rhs, Dinv, x0)
        assert int(n) == want.numel()
        assert torch.equal(poses[:int(n)], want)
        assert not bool(poses[int(n):].any())


@pytest.mark.parametrize("start", ["cold", "warm"])
def test_lba_live_solve_matches_jax_whole_system(lba_systems, start):
    systems, free = lba_systems
    S, rhs, Dinv, x0 = systems[start]
    assert bool((x0 != 0).any()) == (start == "warm")
    inert = _rows(torch.nonzero(~free).flatten())
    S64 = S.double()
    exact = torch.linalg.solve(S64, rhs.double())
    norm = float(torch.sqrt(exact @ (S64 @ exact)))

    def energy(d):
        d = d.double()
        return float(torch.sqrt((d @ (S64 @ d)).clamp_min(0.0))) / norm

    j2 = _jax_solve(S, rhs, Dinv, 2, x0)
    p2 = _solve_live(S, rhs, Dinv, 2, x0)
    assert torch.equal(j2[inert], x0[inert])
    assert torch.equal(p2[inert], x0[inert])
    assert _scale_err(p2, j2) <= 1e-5
    j32 = _jax_solve(S, rhs, Dinv, 32, x0)
    p32 = _solve_live(S, rhs, Dinv, 32, x0)
    assert torch.equal(j32[inert], x0[inert])
    assert torch.equal(p32[inert], x0[inert])
    assert energy(p32 - exact) <= 1.1 * energy(j32 - exact) + 1e-6


def _seeded(K, live, seed):
    """A dense SPD system on the poses `live` (strong 6x6 diagonal blocks),
    identity blocks, zero coupling and rhs 0 on the others: (S, rhs, Dinv)
    float32."""
    rng = np.random.default_rng(seed)
    idx = _rows(torch.as_tensor(live, dtype=torch.int64)).numpy()
    n = idx.size
    A = rng.normal(size=(n, n))
    S = np.eye(6 * K)
    S[np.ix_(idx, idx)] = A @ A.T / n + np.diag(rng.uniform(1.0, 50.0, n))
    rhs = np.zeros(6 * K)
    rhs[idx] = rng.normal(size=n)
    blocks = np.stack([S[6 * k:6 * k + 6, 6 * k:6 * k + 6] for k in range(K)])
    f32 = np.float32
    return (torch.from_numpy(S.astype(f32)), torch.from_numpy(rhs.astype(f32)),
            torch.from_numpy(np.linalg.inv(blocks).astype(f32)))


def test_identity_row_with_warm_start_is_live():
    S, rhs, Dinv = _seeded(8, [1, 4], seed=1)
    x0 = torch.zeros(48)
    assert pcg.live_poses(S, rhs, Dinv, x0)[0][:2].tolist() == [1, 4]
    x0[6 * 6 + 2] = 0.5                       # pose 6: identity, rhs 0
    poses, n = pcg.live_poses(S, rhs, Dinv, x0)
    assert int(n) == 3 and poses[:3].tolist() == [1, 4, 6]
    # CG moves it: r0 = -x0 there
    x = tbk.pcg_solve(S, rhs, Dinv, 32, x0)
    assert abs(float(x[6 * 6 + 2])) < 1e-6
    assert torch.equal(pcg.live_poses(S, rhs, Dinv, None)[1],
                       torch.tensor([2], dtype=torch.int32))


def test_one_coupling_entry_makes_a_pose_live():
    S, rhs, Dinv = _seeded(8, [2, 5], seed=2)
    S[6 * 7 + 3, 6 * 0 + 1] = 1e-6            # row of pose 7, column of pose 0
    poses, n = pcg.live_poses(S, rhs, Dinv, None)
    assert int(n) == 3 and poses[:3].tolist() == [2, 5, 7]
    # an entry inside the own diagonal block couples nothing
    S, rhs, Dinv = _seeded(8, [2, 5], seed=2)
    S[6 * 7 + 3, 6 * 7 + 1] = 0.25
    assert int(pcg.live_poses(S, rhs, Dinv, None)[1]) == 2


def test_all_live_system_lists_every_pose():
    K = 16
    S, rhs, Dinv = _seeded(K, list(range(K)), seed=3)
    for x0 in (None, torch.zeros(6 * K)):
        poses, n = pcg.live_poses(S, rhs, Dinv, x0)
        assert int(n) == K and poses.tolist() == list(range(K))


def test_all_inert_system_lists_none_and_returns_x0():
    K = 8
    S, rhs, Dinv = _seeded(K, [], seed=4)
    x0 = torch.zeros(6 * K)
    poses, n = pcg.live_poses(S, rhs, Dinv, x0)
    assert int(n) == 0 and not bool(poses.any())
    for start in (None, x0):
        x = tbk.pcg_solve(S, rhs, Dinv, 32, start)
        assert bool(torch.isfinite(x).all()) and torch.equal(x, x0)
    assert torch.equal(_jax_solve(S, rhs, Dinv, 32, x0), x0)
    assert torch.equal(pcg.pcg_solve(S, rhs, Dinv, 32, x0), x0)


def test_scattered_live_poses_past_the_float64_rows():
    """K = 160 (D = 960 > 924: the kernel sums r0's rows in float64) with a
    scattered eighth of the poses live and a warm start on them."""
    K = 160
    live = np.sort(np.random.default_rng(5).choice(K, K // 8, replace=False))
    S, rhs, Dinv = _seeded(K, live.tolist(), seed=5)
    idx = _rows(torch.as_tensor(live))
    x0 = torch.zeros(6 * K)
    x0[idx] = torch.from_numpy(
        np.random.default_rng(6).normal(size=idx.numel()).astype(np.float32))
    poses, n = pcg.live_poses(S, rhs, Dinv, x0)
    assert int(n) == live.size and poses[:int(n)].tolist() == live.tolist()
    x = _solve_live(S, rhs, Dinv, 2, x0)
    want = _jax_solve(S, rhs, Dinv, 2, x0)
    inert = torch.ones(6 * K, dtype=torch.bool)
    inert[idx] = False
    assert torch.equal(want[inert], x0[inert])
    assert _scale_err(x, want) <= 1e-5
