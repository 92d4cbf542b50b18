"""Distributed bundle adjustment: points sharded over the ranks of a mesh
axis, the reduced camera system all-reduced.

Counterpart of the JAX package's ``parallel/dist_ba.py``. The Schur trick
makes BA shardable along the point axis: every observation couples one pose
and one point, so with the points (and their observation rows) split into
contiguous blocks, one a rank,

  - point blocks, back-substitution, residuals and Jacobians are local (the
    Schur preparation, K2, runs on the rank's shard);
  - the cross blocks, the pose blocks, the right-hand side and the robust
    cost are local sums, all-reduced in one collective per LM iteration
    (``optim/ba._build_and_solve_fast``'s `reduce`, the JAX ``psum``);
  - the reduced camera solve (PCG, K3) is replicated on every rank, started
    from zero as the JAX distributed solve starts it.

Each rank sorts and bands its own shard as ``ba_solve_fast`` does a whole
problem (``optim/ba._prepare_solve``) and sizes its own overflow pass; the
all-reduced buffer is [6 (K + 1)]^2 whatever each rank's assembly, so no
rank takes a different branch around a collective.

The poses are replicated and take the same steps on every rank, bit for
bit: every rank solves the same all-reduced system.
"""
from __future__ import annotations

import functools

import torch
import torch.distributed as dist

from ..geometry.camera import Intrinsics
from ..optim import ba as ba_mod
from .mesh import Mesh, gather_blocks


def make_mesh(n_ranks: int = None, axis: str = "points") -> Mesh:
    """One-axis mesh over the default process group's ranks (n_ranks, if
    given, must be its world size)."""
    world = dist.get_world_size()
    if n_ranks not in (None, world):
        raise ValueError(f"a mesh spans the process group: {n_ranks} ranks "
                         f"asked, the group has {world}")
    return Mesh((world,), (axis,))


def shard_problem(prob: ba_mod.BAProblem, rank: int,
                  world: int) -> ba_mod.BAProblem:
    """Shard `rank` of `world` of a whole problem: the rank's contiguous
    block of the point axis (P must divide by world), the poses whole."""
    P = prob.pw.shape[0]
    if P % world:
        raise ValueError(f"{P} points do not split over {world} ranks")
    sl = slice(rank * (P // world), (rank + 1) * (P // world))
    return prob._replace(**{f: getattr(prob, f)[sl]
                            for f in ba_mod.POINT_FIELDS})


def gather_points(pw_local: torch.Tensor, group=None) -> torch.Tensor:
    """The whole point array from every rank's block, in rank order."""
    return gather_blocks(pw_local, group)


@torch.no_grad()
def distributed_ba_solve(prob_local: ba_mod.BAProblem, cam: Intrinsics,
                         mesh: Mesh, n_iters: int = 10,
                         use_huber: bool = True, chi2_mono: float = 5.991,
                         chi2_stereo: float = 7.815, axis: str = None,
                         chunk: int = 2048, pcg_iters: int = 48,
                         band="auto", cross_bf16=None):
    """``ba_solve_fast`` over the points of `axis` of `mesh` (default: its
    last axis): prob_local holds this rank's block of the point axis and
    the whole pose tables. Returns (q, t, pw_local): q and t replicated, the
    rank's block of the points in its own order.

    The signature is the JAX package's. `band` takes ``ba_solve_fast``'s
    forms with the shard's P_local: "auto" is (128, max(256, P_local // 16),
    64) where K >= 192 and P_local >= 8192. Each rank reads its own
    out-of-band count once and its overflow pass holds every such point
    (the JAX package's traced shards keep the static capacity and drop the
    excess from the assembly). `cross_bf16` selects a layout of the TPU
    program and is ignored. Each rank's assembly takes max(min(chunk,
    P_local // 4), 1) points a product. PCG starts from zero in every
    iteration (the JAX distributed solve passes no warm start), so at one
    rank this is not bit-equal to ``ba_solve_fast``, which warm-starts."""
    axis = axis or mesh.axis_names[-1]
    P_local = prob_local.pw.shape[0]
    local_chunk = max(min(chunk, P_local // 4), 1)
    band = ba_mod._resolve_band(band, prob_local.q.shape[0], P_local,
                                auto_oc_div=16)
    sc = ba_mod._prepare_solve(prob_local, local_chunk, band)
    q, t, pw = ba_mod._lm_solve(sc, prob_local.q, prob_local.t, cam, n_iters,
                                use_huber, chi2_mono, chi2_stereo, pcg_iters,
                                warm_start=False,
                                reduce=functools.partial(mesh.all_reduce,
                                                         axis=axis))
    return q, t, ba_mod._caller_order(pw, sc)
