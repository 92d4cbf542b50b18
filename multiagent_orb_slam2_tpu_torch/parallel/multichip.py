"""Multi-rank scale-out steps on an (agents, points) mesh: the per-frame
front end (ORB extraction and matching) and per-agent pose optimization
data-parallel over the `agents` axis, plus distributed global BA with the
map points sharded over the `points` axis.

Counterpart of the JAX package's ``parallel/multichip.py``: the engine's
scale-out unit of work, the analogue of one scheduler tick of the
reference's thread farm. Every agent extracts and matches its frame and
advances one pose optimization, then the shared map runs one distributed
BA round. The agent arrays are whole on every rank; each rank computes the
agents of its block of the `agents` axis (the ranks of one `points` line
compute the same agents), and the results are gathered over the `agents`
axis, so every rank returns whole arrays, as the JAX step returns global
arrays.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..config import OptimizerConfig, OrbConfig
from ..geometry.camera import Intrinsics
from ..ops import matchers, orb
from ..optim import ba as ba_mod
from ..optim import pose_opt
from . import dist_ba
from .mesh import Mesh


def make_2d_mesh(n_ranks: int = None, n_agents_axis: int = None) -> Mesh:
    """(agents, points) mesh over the default group's ranks (n_ranks, if
    given, must be its world size): 2 on the agents axis when the count is
    even, else 1, as in the JAX package."""
    world = dist.get_world_size()
    if n_ranks not in (None, world):
        raise ValueError(f"a mesh spans the process group: {n_ranks} ranks "
                         f"asked, the group has {world}")
    a = n_agents_axis or (2 if world % 2 == 0 and world >= 2 else 1)
    return Mesh((a, world // a), ("agents", "points"))


@torch.no_grad()
def multichip_frontend(imgs, prev_desc, prev_valid, ocfg: OrbConfig,
                       mesh: Mesh):
    """Per-agent front end over the mesh: ORB extraction, then descriptor
    matching against the agent's previous frame (th 64, ratio 0.9),
    data-parallel over the agents axis (the reference runs one
    ORBextractor + ORBmatcher per agent thread).

    imgs [A, H, W] float32; prev_desc / prev_valid [A, N, 8] int32 / [A, N]
    bool, A divisible by the agents axis. Returns (desc [A, N, 8], valid
    [A, N], n_matches [A] int32)."""
    sl = mesh.block("agents", imgs.shape[0])
    desc, valid, n_matches = [], [], []
    for im, pd, pv in zip(imgs[sl], prev_desc[sl], prev_valid[sl]):
        kp = orb.extract(im, ocfg)
        res = matchers.match_brute(kp.desc, kp.valid, pd, pv, th=64,
                                   nn_ratio=0.9)
        desc.append(kp.desc)
        valid.append(kp.valid)
        n_matches.append(torch.sum(res.ok.to(torch.int32)))
    return (mesh.all_gather(torch.stack(desc), "agents"),
            mesh.all_gather(torch.stack(valid), "agents"),
            mesh.all_gather(torch.stack(n_matches), "agents"))


@torch.no_grad()
def multichip_step(agent_q, agent_t, agent_obs: pose_opt.PoseObs,
                   ba_prob_local: ba_mod.BAProblem, cam: Intrinsics,
                   mesh: Mesh, cfg: OptimizerConfig = OptimizerConfig(),
                   ba_iters: int = 2):
    """One full step: the pose optimization of every agent (the rank's
    agents in one batched launch of the pose kernel) and one distributed BA
    over the points axis. agent_q [A, 4], agent_t [A, 3] and agent_obs
    fields [A, N, ...] whole, A divisible by the agents axis; ba_prob_local
    the rank's block of the BA problem's points (its `points` coordinate).
    Returns (q [A, 4], t [A, 3], n_inliers [A], BA q, BA t, BA pw_local)."""
    sl = mesh.block("agents", agent_q.shape[0])
    obs = pose_opt.PoseObs(*[a[sl] for a in agent_obs])
    q, t, _, n_inl = pose_opt.pose_optimize(agent_q[sl], agent_t[sl], obs,
                                            cam, cfg)
    q_new = mesh.all_gather(q, "agents")
    t_new = mesh.all_gather(t, "agents")
    n_inl = mesh.all_gather(n_inl, "agents")
    qb, tb, pw = dist_ba.distributed_ba_solve(ba_prob_local, cam, mesh,
                                              n_iters=ba_iters,
                                              axis="points")
    return q_new, t_new, n_inl, qb, tb, pw
