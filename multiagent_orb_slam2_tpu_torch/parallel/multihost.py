"""Multi-process execution: process groups, the global mesh, agent
assignment, and a launcher of spawned ranks.

Counterpart of the JAX package's ``parallel/multihost.py``. The reference
has no network layer (its distributed system is threads in one process);
here every process runs the same driver as one rank of a
``torch.distributed`` process group, agents are assigned to ranks round
robin, and the point-sharded bundle adjustment all-reduces its reduced
camera system over the group: NCCL between cards, gloo on the CPU or where
several ranks share one card. Nothing in this module starts a process group
when it is imported.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import queue
import tempfile
import time

import torch
import torch.distributed as dist

from .mesh import Mesh


def init_distributed(init_method: str = None, world_size: int = None,
                     rank: int = None, *, backend: str):
    """Join the default process group (idempotent: a process already in one
    keeps it). init_method None reads the ``env://`` variables
    (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK); else e.g.
    ``tcp://127.0.0.1:<port>`` or ``file://<path>`` with the world size and
    this process's rank. backend: ``"nccl"`` for one rank per card,
    ``"gloo"`` for the CPU or for ranks that share a card."""
    if dist.is_initialized():
        return
    dist.init_process_group(
        backend, init_method=init_method or "env://",
        world_size=-1 if world_size is None else world_size,
        rank=-1 if rank is None else rank)


def global_mesh(axis_names=("agents", "points"),
                agents_dim: int = None) -> Mesh:
    """Mesh over every rank of the default group. The JAX package's rule:
    agents_dim defaults to the process count, so each process's agents stay
    local and only BA collectives cross processes; with one rank per
    process that count is the world size. agents_dim is lowered until it
    divides the world size."""
    world = dist.get_world_size()
    if len(axis_names) == 1:
        return Mesh((world,), axis_names)
    a = agents_dim or world
    while world % a:
        a -= 1
    return Mesh((a, world // a), axis_names)


def agents_for_this_host(n_agents: int):
    """Round-robin agent assignment: agent a is tracked by rank a mod the
    world size (rank 0 of 1 outside a process group)."""
    if dist.is_initialized():
        pid, n = dist.get_rank(), dist.get_world_size()
    else:
        pid, n = 0, 1
    return [a for a in range(n_agents) if a % n == pid]


def _rank_main(fn, rank, world_size, init_method, backend, device, args,
               results):
    torch.set_num_threads(1)
    dev = torch.device(device)
    if dev.type == "cuda":
        if backend == "nccl":        # one card per rank
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        elif dev.index is None:
            dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
    init_distributed(init_method, world_size, rank, backend=backend)
    try:
        results.put((rank, fn(rank, world_size, dev, *args)))
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world_size: int, args=(), *, backend: str,
              device="cuda", timeout: float = 120.0):
    """Run fn(rank, world_size, device, *args) in world_size spawned
    processes joined into one process group (a FileStore in a temporary
    directory) and return their results in rank order.

    fn must be importable by name and return picklable host values (numpy
    arrays, numbers). Each rank runs one intra-op thread; on ``cuda`` the
    gloo ranks share `device` and the nccl ranks take card rank mod the
    card count. Raises when a rank fails or the ranks do not all finish
    within `timeout` seconds; every process has ended when it returns or
    raises."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        init_method = "file://" + os.path.join(tmp, "store")
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, world_size, init_method, backend,
                                   str(device), tuple(args), results))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            out = {}
            # drain the queue before joining: a child that has put a large
            # result exits only once it has been read
            while len(out) < world_size:
                try:
                    rank, value = results.get(timeout=0.2)
                    out[rank] = value
                    continue
                except queue.Empty:
                    pass
                for r, p in enumerate(procs):
                    if p.exitcode not in (None, 0):
                        raise RuntimeError(f"rank {r} of {world_size} exited "
                                           f"with code {p.exitcode}")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world_size} ranks did not finish "
                                       f"in {timeout} s")
            for r, p in enumerate(procs):
                p.join(max(deadline - time.monotonic(), 1.0))
                if p.exitcode != 0:
                    raise RuntimeError(f"rank {r} of {world_size} ended with "
                                       f"code {p.exitcode}")
            return [out[r] for r in range(world_size)]
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
