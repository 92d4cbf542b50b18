"""Rank functions of the distributed tests of the PyTorch port
(test_torch_dist_ba.py, test_torch_multichip.py).

``parallel.multihost.run_ranks`` spawns the ranks, and a spawned process
imports the module of its target anew; a test module imports jax, so the
rank functions live here and import only numpy, torch and the port. Every
rank gets whole problems as numpy fields and returns numpy arrays.
"""
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from multiagent_orb_slam2_tpu_torch import convert  # noqa: E402
from multiagent_orb_slam2_tpu_torch.config import OrbConfig  # noqa: E402
from multiagent_orb_slam2_tpu_torch.geometry import camera  # noqa: E402
from multiagent_orb_slam2_tpu_torch.parallel import (  # noqa: E402
    dist_ba, multichip)

# tests/test_ba.CAM
CAM = camera.Intrinsics(fx=450.0, fy=450.0, cx=320.0, cy=240.0, bf=45.0)


def solve_sharded(fields, rank, world, device, cam=CAM, **kw):
    """This rank's distributed_ba_solve of the whole problem `fields` on a
    one-axis mesh of the default group: (q, t, whole pw) as numpy."""
    prob = convert.ba_problem_from_numpy(fields, device)
    mesh = dist_ba.make_mesh(world)
    q, t, pw_local = dist_ba.distributed_ba_solve(
        dist_ba.shard_problem(prob, rank, world), cam, mesh, **kw)
    pw = dist_ba.gather_points(pw_local, mesh.groups["points"])
    return q.cpu().numpy(), t.cpu().numpy(), pw.cpu().numpy()


def dist_ba_rank(rank, world, device, fields, kw):
    q, t, pw = solve_sharded(fields, rank, world, device, **kw)
    return {"q": q, "t": t, "pw": pw}


def multichip_rank(rank, world, device, pose, ba_fields, front):
    """One multichip_step and one multichip_frontend on the (agents, points)
    mesh of the group: pose = (q [A, 4], t [A, 3], PoseObs fields), front =
    (imgs [A, H, W], prev_desc, prev_valid, OrbConfig kwargs)."""
    mesh = multichip.make_2d_mesh(world)
    q, t, obs = pose
    obs = convert.pose_obs_from_numpy(obs, device)
    prob = convert.ba_problem_from_numpy(ba_fields, device)
    prob_local = dist_ba.shard_problem(prob, mesh.coords["points"],
                                       mesh.shape["points"])
    out = multichip.multichip_step(torch.tensor(q, device=device),
                                   torch.tensor(t, device=device), obs,
                                   prob_local, CAM, mesh)
    pw = dist_ba.gather_points(out[5], mesh.groups["points"])
    imgs, pd, pv, ocfg = front
    desc, valid, n_matches = multichip.multichip_frontend(
        torch.tensor(imgs, device=device),
        torch.tensor(pd.view(np.int32), device=device),
        torch.tensor(pv, device=device), OrbConfig(**ocfg), mesh)
    names = ("q", "t", "n_inl", "ba_q", "ba_t")
    res = {n: a.cpu().numpy() for n, a in zip(names, out[:5])}
    res.update(ba_pw=pw.cpu().numpy(), desc=desc.cpu().numpy(),
               valid=valid.cpu().numpy(), n_matches=n_matches.cpu().numpy(),
               coords=(mesh.coords["agents"], mesh.coords["points"]))
    return res
