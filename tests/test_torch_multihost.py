"""Two OS processes form one torch.distributed group over TCP on localhost
(``parallel.multihost.init_distributed``, gloo) and run the port's
point-sharded distributed BA, its all-reduce crossing the process boundary
(tests/torch_multihost_worker.py). The counterpart of
tests/test_multihost.py, with its bound: q and t within 5e-3 of the
single-process ``ba_solve_fast`` (which warm-starts PCG, the distributed
solve does not). Against the port's own distributed solve at world size 1
on the same problem: q and t within 1e-4, the points within 1e-3 m (the
tolerances of test_torch_dist_ba.py). The two ranks' outputs are
bit-equal.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

pytestmark = pytest.mark.e2e

from multiagent_orb_slam2_tpu_torch import convert
from multiagent_orb_slam2_tpu_torch.optim import ba as tba
from multiagent_orb_slam2_tpu_torch.parallel import multihost

import torch_dist_cases as cases
import torch_parity  # noqa: F401  (one torch thread per test worker)
from test_ba import make_ba_problem

HERE = os.path.dirname(__file__)
KW = dict(n_iters=6, chunk=64, pcg_iters=48)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_distributed_ba(tmp_path):
    prob, _ = make_ba_problem(K=8, P=256, M=6, seed=5)
    fields = {k: np.asarray(v) for k, v in prob._asdict().items()}
    np.savez(tmp_path / "problem.npz", **fields)
    addr = f"tcp://127.0.0.1:{_free_port()}"
    out = str(tmp_path / "result.npz")
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_multihost_worker.py"),
         addr, str(rank), "2", str(tmp_path / "problem.npz"), out],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
        for rank in range(2)]
    outs = []
    for p in procs:
        try:
            o, _ = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            o, _ = p.communicate()
        outs.append(o.decode(errors="replace"))
    for rank, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{o[-3000:]}"
    r0, r1 = (np.load(str(tmp_path / f"result_{r}.npz")) for r in range(2))
    for k in ("q", "t", "pw"):
        assert np.array_equal(r0[k], r1[k]), k

    tprob = convert.ba_problem_from_numpy(fields, "cpu")
    ref = tba.ba_solve_fast(tprob, cases.CAM, n_iters=6, chunk=64,
                            pcg_iters=48)
    assert np.abs(r0["q"] - ref.q.numpy()).max() < 5e-3
    assert np.abs(r0["t"] - ref.t.numpy()).max() < 5e-3

    dist.init_process_group("gloo", store=dist.HashStore(), world_size=1,
                            rank=0)
    try:
        assert multihost.agents_for_this_host(3) == [0, 1, 2]
        q1, t1, pw1 = cases.solve_sharded(fields, 0, 1,
                                          torch.device("cpu"), **KW)
    finally:
        dist.destroy_process_group()
    assert np.abs(r0["q"] - q1).max() <= 1e-4
    assert np.abs(r0["t"] - t1).max() <= 1e-4
    assert np.abs(r0["pw"] - pw1).max() <= 1e-3


def test_init_distributed_is_idempotent_and_meshes_follow_the_jax_rule():
    dist.init_process_group("gloo", store=dist.HashStore(), world_size=1,
                            rank=0)
    try:
        group = dist.group.WORLD
        multihost.init_distributed("tcp://127.0.0.1:1", 1, 0, backend="gloo")
        assert dist.group.WORLD is group
        mesh = multihost.global_mesh()
        assert mesh.shape == {"agents": 1, "points": 1}
        assert mesh.coords == {"agents": 0, "points": 0}
        assert multihost.global_mesh(axis_names=("points",)).shape == {
            "points": 1}
        x = torch.arange(6.0).reshape(2, 3)
        assert torch.equal(mesh.all_gather(x, "agents"), x)
        assert torch.equal(mesh.all_reduce(x.clone(), "points"), x)
        assert mesh.block("agents", 4) == slice(0, 4)
    finally:
        dist.destroy_process_group()
    assert multihost.agents_for_this_host(3) == [0, 1, 2]
