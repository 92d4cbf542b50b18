"""Multi-rank dry run: one full multi-agent step on tiny shapes.

Counterpart of the JAX package's ``__graft_entry__.dryrun_multichip``:
spawns n_ranks processes joined into one process group, builds the
(agents, points) mesh over them, and runs one ``multichip_step``
(data-parallel per-agent tracking plus point-sharded distributed global BA
with the all-reduced camera system) and one ``multichip_frontend``.

    python -m multiagent_orb_slam2_tpu_torch.parallel.dryrun 4 \\
        [--backend gloo] [--device cuda]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..config import OrbConfig
from ..geometry import se3
from ..geometry.camera import Intrinsics
from ..optim.ba import BAProblem
from ..optim.pose_opt import PoseObs
from . import multichip, multihost

CAM = Intrinsics(fx=450.0, fy=450.0, cx=320.0, cy=240.0, bf=45.0)


def _tiny_pose_problem(n_agents=None, n_obs=64, seed=0, device="cpu"):
    """(cam, (q, t, PoseObs)) of one seeded pose problem, or of n_agents
    stacked ([A, ...]); the JAX entry point's ``_tiny_pose_problem``."""
    def one(s):
        r = np.random.default_rng(s)
        pw = np.stack([r.uniform(-3, 3, n_obs), r.uniform(-2, 2, n_obs),
                       r.uniform(4, 15, n_obs)], -1).astype(np.float32)
        q, t = se3.se3_exp(torch.tensor(r.normal(size=6) * 0.1,
                                        dtype=torch.float32))
        pc = se3.apply(q, t, torch.from_numpy(pw)).numpy()
        u = CAM.fx * pc[:, 0] / pc[:, 2] + CAM.cx
        v = CAM.fy * pc[:, 1] / pc[:, 2] + CAM.cy
        ur = u - CAM.bf / pc[:, 2]
        obs = np.stack([u, v, ur], -1) + r.normal(0, 0.3, (n_obs, 3))
        return q, t, PoseObs(
            pw=torch.from_numpy(pw),
            obs=torch.tensor(obs, dtype=torch.float32),
            inv_sigma2=torch.ones(n_obs),
            is_stereo=torch.ones(n_obs, dtype=torch.bool),
            mask=torch.ones(n_obs, dtype=torch.bool))

    def to(a):
        return a.to(device)

    if n_agents is None:
        q, t, obs = one(0)
        return CAM, (to(q), to(t), PoseObs(*map(to, obs)))
    qs, ts, obs = zip(*[one(i) for i in range(n_agents)])
    return CAM, (to(torch.stack(qs)), to(torch.stack(ts)),
                 PoseObs(*[to(torch.stack(f)) for f in zip(*obs)]))


def _tiny_ba_shard(p_dim: int, p_coord: int, device):
    """The dry run's BA problem (K, P, M) = (4, 16 p_dim, 4), block p_coord
    of its points."""
    rng = np.random.default_rng(0)
    K, P, M = 4, 16 * p_dim, 4
    pw = np.stack([rng.uniform(-3, 3, P), rng.uniform(-2, 2, P),
                   rng.uniform(5, 12, P)], -1).astype(np.float32)
    qs = np.tile(np.array([1.0, 0, 0, 0], np.float32), (K, 1))
    ts = np.stack([np.linspace(0, 1, K), np.zeros(K), np.zeros(K)],
                  -1).astype(np.float32)
    obs_kf = rng.integers(0, K, size=(P, M)).astype(np.int32)
    u = 450.0 * pw[:, None, 0] / pw[:, None, 2] + 320.0
    v = 450.0 * pw[:, None, 1] / pw[:, None, 2] + 240.0
    obs_uvr = np.stack([np.broadcast_to(u, (P, M)), np.broadcast_to(v, (P, M)),
                        np.broadcast_to(u - 5.0, (P, M))], -1)
    sl = slice(p_coord * 16, (p_coord + 1) * 16)

    def dev(a, dtype=torch.float32):
        return torch.tensor(np.ascontiguousarray(a), dtype=dtype,
                            device=device)

    fixed = np.zeros(K, bool)
    fixed[0] = True
    return BAProblem(
        q=dev(qs), t=dev(ts), pose_valid=dev(np.ones(K, bool), torch.bool),
        pose_fixed=dev(fixed, torch.bool), pw=dev(pw[sl]),
        point_valid=dev(np.ones(16, bool), torch.bool),
        obs_kf=dev(obs_kf[sl], torch.int32), obs_uvr=dev(obs_uvr[sl]),
        obs_inv_sigma2=dev(np.ones((16, M))),
        obs_stereo=dev(np.ones((16, M), bool), torch.bool),
        obs_mask=dev(np.ones((16, M), bool), torch.bool))


def _dryrun_rank(rank, world, device):
    mesh = multichip.make_2d_mesh(world)
    a_dim, p_dim = mesh.shape["agents"], mesh.shape["points"]
    n_agents = 2 * a_dim
    cam, (q, t, obs) = _tiny_pose_problem(n_agents=n_agents, n_obs=64,
                                          device=device)
    prob = _tiny_ba_shard(p_dim, mesh.coords["points"], device)
    step = multichip.multichip_step(q, t, obs, prob, cam, mesh)

    # the front end over the mesh: extraction and matching, tiny images
    ocfg = OrbConfig(n_features=64, n_levels=2)
    rng = np.random.default_rng(0)
    imgs = torch.tensor(rng.uniform(0, 255, (n_agents, 64, 96)),
                        dtype=torch.float32, device=device)
    n_slots = sum(ocfg.level_budgets)
    pd = torch.tensor(rng.integers(0, 2 ** 32, (n_agents, n_slots, 8),
                                   dtype=np.uint32).view(np.int32),
                      device=device)
    pv = torch.ones((n_agents, n_slots), dtype=torch.bool, device=device)
    front = multichip.multichip_frontend(imgs, pd, pv, ocfg, mesh)
    finite = all(bool(torch.isfinite(a.float()).all()) for a in step + front)
    return {"mesh": (a_dim, p_dim), "agents": n_agents, "points": 16 * p_dim,
            "frontend_feats": n_slots, "finite": finite}


def dryrun_multichip(n_ranks: int, backend: str = "gloo", device="cuda",
                     timeout: float = 300.0) -> dict:
    """Run one multichip_step and one multichip_frontend over an n_ranks
    mesh of spawned processes (gloo: the ranks may share `device`; nccl: one
    card per rank). Returns rank 0's summary; raises if a rank fails, a
    result is not finite, or the ranks outlast `timeout` seconds."""
    out = multihost.run_ranks(_dryrun_rank, n_ranks, backend=backend,
                              device=device, timeout=timeout)
    if not all(o["finite"] for o in out):
        raise RuntimeError(f"dryrun_multichip: a result is not finite: {out}")
    s = out[0]
    print(f"dryrun_multichip OK: mesh={s['mesh']} agents={s['agents']} "
          f"points={s['points']} frontend_feats={s['frontend_feats']}")
    return s


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("n_ranks", type=int)
    ap.add_argument("--backend", default="gloo")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n_ranks, args.backend, args.device)


if __name__ == "__main__":
    main()
