"""The port's multi-rank step (parallel/multichip.py) against the JAX
package's, on a (2, 2) mesh: four spawned gloo ranks on the CPU against
``multichip`` on ``make_2d_mesh(4)`` of the conftest's virtual devices.

Inputs: the JAX dry run's pose problems
(``__graft_entry__._tiny_pose_problem``, 4 agents of 64 observations; the
port's copy, ``parallel/dryrun``, is held to it), ``make_ba_problem(K=8, P=400, M=8)`` point-sharded over the
points axis, and four frames of the seed-7 corridor through the front end,
matched against the descriptors of each agent's previous frame.

Tolerances: valid flags exact, descriptors the ``ops/orb`` row's (within 2
bits, here at most 1 % of rows differing; found: 1 row of 800, 1 bit),
n_matches equal; q and t of
the agents 1e-5 (the ``pose_opt`` row), inlier counts equal; the BA's q
and t 1e-4, its points 1e-3 m (test_torch_dist_ba.py's). Every output is
gathered onto every rank, and the four ranks' are bit-equal.
"""
import os
import sys

import numpy as np
import jax.numpy as jnp
import pytest

pytestmark = pytest.mark.e2e

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import __graft_entry__ as graft  # noqa: E402
from multiagent_orb_slam2_tpu.config import OrbConfig  # noqa: E402
from multiagent_orb_slam2_tpu.ops import orb as jorb  # noqa: E402
from multiagent_orb_slam2_tpu.parallel import multichip as jmc  # noqa: E402
from multiagent_orb_slam2_tpu_torch.parallel import (  # noqa: E402
    dryrun, multihost)

import torch_dist_cases as cases  # noqa: E402
import torch_parity  # noqa: E402
from test_ba import CAM, make_ba_problem  # noqa: E402

OCFG = dict(n_features=200, n_levels=2)


@pytest.fixture(scope="module")
def runs():
    _, (q, t, obs) = graft._tiny_pose_problem(n_agents=4, n_obs=64)
    prob, _ = make_ba_problem(K=8, P=400, M=8, seed=4)
    frames, _ = torch_parity.sequence(5)
    ocfg = OrbConfig(**OCFG)
    imgs = np.stack([np.asarray(frames[i][0], np.float32)
                     for i in range(1, 5)])
    prev = [jorb.extract(jnp.asarray(frames[i][0]), ocfg) for i in range(4)]
    pd = np.stack([np.asarray(k.desc) for k in prev])
    pv = np.stack([np.asarray(k.valid) for k in prev])

    mesh = jmc.make_2d_mesh(4)
    step = [np.asarray(a) for a in jmc.multichip_step(q, t, obs, prob, CAM,
                                                      mesh)]
    front = [np.asarray(a) for a in jmc.multichip_frontend(
        jnp.asarray(imgs), jnp.asarray(pd), jnp.asarray(pv), ocfg, mesh)]

    pose = (np.asarray(q), np.asarray(t),
            {k: np.asarray(v) for k, v in obs._asdict().items()})
    fields = {k: np.asarray(v) for k, v in prob._asdict().items()}
    port = multihost.run_ranks(cases.multichip_rank, 4,
                               (pose, fields, (imgs, pd, pv, OCFG)),
                               backend="gloo", device="cpu", timeout=120)
    return dict(step=step, front=front, port=port, pose=pose)


def test_frontend_matches_jax(runs):
    desc, valid, n_matches = runs["front"]
    r = runs["port"][0]
    assert np.array_equal(r["valid"], valid)
    # the ORB row: a descriptor bit can flip on a bilinear sample that
    # rounds differently (found: 1 of 800 rows, 1 bit)
    bits = np.unpackbits((r["desc"].view(np.uint32) ^ desc).view(np.uint8),
                         axis=-1).sum(-1)
    assert bits.max() <= 2, bits.max()
    assert (bits > 0).mean() <= 0.01, (bits > 0).sum()
    assert np.array_equal(r["n_matches"], n_matches)
    assert n_matches.min() > 0


def test_step_matches_jax(runs):
    q, t, n_inl, ba_q, ba_t, ba_pw = runs["step"]
    r = runs["port"][0]
    assert np.abs(r["q"] - q).max() <= 1e-5
    assert np.abs(r["t"] - t).max() <= 1e-5
    assert np.array_equal(r["n_inl"], n_inl)
    assert np.abs(r["ba_q"] - ba_q).max() <= 1e-4
    assert np.abs(r["ba_t"] - ba_t).max() <= 1e-4
    assert np.abs(r["ba_pw"] - ba_pw).max() <= 1e-3


def test_ranks_cover_the_mesh_and_agree_bit_for_bit(runs):
    ranks = runs["port"]
    assert [r["coords"] for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in ranks[1:]:
        for k, v in ranks[0].items():
            if k != "coords":
                assert np.array_equal(r[k], v), k


def test_dryrun_pose_problem_is_the_jax_one(runs):
    _, (q, t, obs) = dryrun._tiny_pose_problem(n_agents=4, n_obs=64)
    jq, jt, jobs = runs["pose"]
    assert np.abs(q.numpy() - jq).max() <= 1e-6
    assert np.abs(t.numpy() - jt).max() <= 1e-6
    assert np.abs(obs.obs.numpy() - jobs["obs"]).max() <= 1e-3


def test_dryrun_multichip_runs_on_four_cpu_ranks():
    out = dryrun.dryrun_multichip(4, "gloo", "cpu", timeout=120)
    assert out["mesh"] == (2, 2) and out["finite"]
