"""Worker process of tests/test_torch_multihost.py: one rank of a 2-process
torch.distributed group over TCP on localhost.

    python tests/torch_multihost_worker.py ADDR RANK WORLD PROBLEM.npz OUT.npz

Joins the group through ``parallel.multihost.init_distributed`` (gloo),
forms the global one-axis mesh, runs the point-sharded distributed BA on
the problem in PROBLEM.npz (the whole problem's fields; each rank takes its
block of the points) and writes q, t and the gathered points to OUT.npz,
rank by rank (OUT.npz's name gets the rank). Imports numpy, torch and the
port only.
"""
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_dist_cases as cases  # noqa: E402
from multiagent_orb_slam2_tpu_torch.parallel import multihost  # noqa: E402


def main():
    addr, rank, world, problem, out = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    multihost.init_distributed(addr, world, rank, backend="gloo")
    import torch.distributed as dist
    assert dist.get_world_size() == world
    mesh = multihost.global_mesh(axis_names=("points",), agents_dim=1)
    assert mesh.shape == {"points": world}
    # the JAX rule: the agents axis takes the process count
    assert multihost.global_mesh().shape == {"agents": world, "points": 1}
    assert multihost.agents_for_this_host(4) == list(range(rank, 4, world))
    fields = dict(np.load(problem))
    q, t, pw = cases.solve_sharded(fields, rank, world, torch.device("cpu"),
                                   n_iters=6, chunk=64, pcg_iters=48)
    np.savez(out.replace(".npz", f"_{rank}.npz"), q=q, t=t, pw=pw)
    dist.destroy_process_group()
    print(f"rank {rank}: done", flush=True)


if __name__ == "__main__":
    main()
