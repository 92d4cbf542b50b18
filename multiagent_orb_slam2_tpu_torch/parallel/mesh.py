"""Ranks of a torch.distributed process group laid out on named axes.

The port's counterpart of ``jax.sharding.Mesh``: one rank stands where the
JAX package has one device. The ranks of the default group fill the grid in
row-major order, and along each axis a rank shares a process group with the
ranks of its line. A collective over an axis is a collective over that
group: ``all_reduce`` is the JAX ``psum``, ``all_gather`` collects the
blocks that a ``P(axis)`` sharding spreads over the line.

Every rank must build the same meshes in the same order (``new_group`` is
itself a collective). Ranks that share one card join on ``gloo``, which
carries CUDA tensors through the host; NCCL refuses two ranks on one device.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist


def gather_blocks(x: torch.Tensor, group=None) -> torch.Tensor:
    """The blocks x [n, ...] of the group's ranks, concatenated in group-rank
    order along dim 0. Each rank writes its block into a zero buffer and one
    all-reduce sums them: exact for every dtype, and it uses only
    ``all_reduce``, which gloo also supports on CUDA tensors."""
    n = dist.get_world_size(group)
    dtype = torch.uint8 if x.dtype == torch.bool else x.dtype
    out = torch.zeros((n,) + tuple(x.shape), dtype=dtype, device=x.device)
    out[dist.get_rank(group)] = x
    dist.all_reduce(out, group=group)
    out = out.reshape((n * x.shape[0],) + tuple(x.shape[1:]))
    return out.bool() if x.dtype == torch.bool else out


class Mesh:
    """A grid of every rank of the default process group.

    shape: sizes of the axes, whose product is the world size;
    axis_names: one name per axis. ``shape`` / ``coords`` map each axis
    name to its size / this rank's place on it, ``groups`` to this rank's
    process group along it (the default group's backend; an axis that spans
    every rank is the default group itself)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        world, me = dist.get_world_size(), dist.get_rank()
        shape = tuple(int(s) for s in shape)
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} has {len(shape)} axes, "
                             f"names {tuple(axis_names)}")
        if int(np.prod(shape)) != world:
            raise ValueError(f"mesh shape {shape} does not hold the "
                             f"{world} ranks of the process group")
        self.axis_names = tuple(axis_names)
        self.ranks = np.arange(world).reshape(shape)
        self.shape = dict(zip(self.axis_names, shape))
        self.coords = dict(zip(self.axis_names,
                               (int(c) for c in np.unravel_index(me, shape))))
        self.groups = {}
        for i, axis in enumerate(self.axis_names):
            # every line along the axis, ascending: group rank == coordinate
            for line in np.moveaxis(self.ranks, i, -1).reshape(-1, shape[i]):
                members = line.tolist()
                group = (dist.group.WORLD if len(members) == world
                         else dist.new_group(members))
                if me in members:
                    self.groups[axis] = group

    def block(self, axis: str, n: int) -> slice:
        """This rank's contiguous block of n items split evenly over axis
        (the block a ``P(axis)`` sharding gives it)."""
        size = self.shape[axis]
        if n % size:
            raise ValueError(f"{n} items do not split over the {size} ranks "
                             f"of axis {axis!r}")
        per = n // size
        return slice(self.coords[axis] * per, (self.coords[axis] + 1) * per)

    def all_reduce(self, buf: torch.Tensor, axis: str) -> torch.Tensor:
        """buf summed over the ranks along axis, in place; returns buf."""
        dist.all_reduce(buf, group=self.groups[axis])
        return buf

    def all_gather(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """The blocks of the ranks along axis concatenated along dim 0."""
        return gather_blocks(x, self.groups[axis])
