"""Sim3 pose-graph optimization (the essential graph).

Counterpart of the JAX package's ``optim/pose_graph.py`` (the reference's
Optimizer::OptimizeEssentialGraph): every keyframe a Sim3 vertex (scale fixed
for stereo / RGB-D), edges from loop closures, the spanning tree and strong
covisibility; the loop keyframe fixed; LM; then SE3 recovery by dividing the
translation by the scale.

Edges are capacity-padded arrays. Per-edge 7-vector residuals
r_e = log(S_meas_e * S_i * S_j^-1) and their Jacobians with respect to both
endpoint updates come from forward-mode autodiff. The JAX package sums the
7x7 blocks of the normal matrix with ``segment_sum``; on CUDA a scatter-add
sums with float atomics in no fixed order, and the ``cost1 < cost0`` accept
would then change from run to run. Here the [7K, 7K] normal matrix is one
product of the edge Jacobian stacked over the keyframes (each edge row holds
its two 7x7 blocks at its endpoints' columns), a fixed summation order; it is
solved dense by Cholesky (``cholesky_ex``: no error flag is read back).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import se3, sim3
from ..utils.torch_ops import blockwise_jacfwd, const_tensor

_NO_SCALE = (1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.0)


class PoseGraphEdges(NamedTuple):
    """Capacity-padded edge list."""
    i: torch.Tensor        # [E] int32 source keyframe
    j: torch.Tensor        # [E] int32 target keyframe
    s: torch.Tensor        # [E] measured S_ji scale
    q: torch.Tensor        # [E, 4] measured S_ji rotation
    t: torch.Tensor        # [E, 3] measured S_ji translation
    valid: torch.Tensor    # [E] bool


class PoseGraphResult(NamedTuple):
    s: torch.Tensor
    q: torch.Tensor
    t: torch.Tensor
    final_chi2: torch.Tensor


def make_edge_measurements(s_i, q_i, t_i, s_j, q_j, t_j):
    """Measured relative transform S_ji = S_j * S_i^-1 from the current
    vertex estimates."""
    si_inv, qi_inv, ti_inv = sim3.inverse(s_i, q_i, t_i)
    return sim3.compose(s_j, q_j, t_j, si_inv, qi_inv, ti_inv)


def _edge_residual(xi_i, xi_j, s_i, q_i, t_i, s_j, q_j, t_j,
                   s_m, q_m, t_m, fix_scale: bool):
    """r = log(S_m * (exp(xi_i) S_i) * (exp(xi_j) S_j)^-1), [E, 7]."""
    if fix_scale:
        keep = const_tensor(_NO_SCALE, xi_i.dtype, xi_i.device)
        xi_i = xi_i * keep
        xi_j = xi_j * keep
    dsi, dqi, dti = sim3.exp(xi_i)
    si, qi, ti = sim3.compose(dsi, dqi, dti, s_i, q_i, t_i)
    dsj, dqj, dtj = sim3.exp(xi_j)
    sj, qj, tj = sim3.compose(dsj, dqj, dtj, s_j, q_j, t_j)
    sji, qji, tji = sim3.inverse(sj, qj, tj)
    s1, q1, t1 = sim3.compose(si, qi, ti, sji, qji, tji)
    s2, q2, t2 = sim3.compose(s_m, q_m, t_m, s1, q1, t1)
    return sim3.log(s2, q2, t2)


@torch.no_grad()
def optimize_pose_graph(s0, q0, t0, vertex_valid, vertex_fixed,
                        edges: PoseGraphEdges, fix_scale: bool = True,
                        n_iters: int = 20) -> PoseGraphResult:
    """LM over all Sim3 vertices. s0 [K], q0 [K, 4], t0 [K, 3]. The loop
    runs on the device (no host read)."""
    K = s0.shape[0]
    D = 7
    dev = s0.device
    free = vertex_valid & ~vertex_fixed
    ii = edges.i.long().clamp(0, K - 1)
    jj = edges.j.long().clamp(0, K - 1)
    E = ii.shape[0]
    zeros = torch.zeros((E, 2 * D), dtype=s0.dtype, device=dev)
    w = edges.valid.to(s0.dtype)
    # [E, K] endpoint indicators of the valid edges
    kk = torch.arange(K, device=dev)
    on_i = ((ii[:, None] == kk[None, :]) & edges.valid[:, None]).to(s0.dtype)
    on_j = ((jj[:, None] == kk[None, :]) & edges.valid[:, None]).to(s0.dtype)
    eye = torch.eye(K * D, dtype=s0.dtype, device=dev)
    free_d = free.repeat_interleave(D)

    def residual(s, q, t, xi):
        """[E, 7] residuals at the updates xi = [E, 14] (both endpoints)."""
        return _edge_residual(xi[:, :D], xi[:, D:], s[ii], q[ii], t[ii],
                              s[jj], q[jj], t[jj], edges.s, edges.q, edges.t,
                              fix_scale)

    def cost(s, q, t):
        r = residual(s, q, t, zeros)
        return r, torch.sum(torch.sum(r * r, -1) * w)

    def solve(s, q, t, r, lam):
        J2 = blockwise_jacfwd(lambda x: residual(s, q, t, x), zeros)
        Ji, Jj = J2[..., :D], J2[..., D:]
        # stacked Jacobian [E, 7, K, 7]: edge e's blocks at its endpoints
        J = (on_i[:, None, :, None] * Ji[:, :, None, :]
             + on_j[:, None, :, None] * Jj[:, :, None, :]).reshape(E * D,
                                                                   K * D)
        H = J.t() @ J                                   # [7K, 7K], k-major
        b = -(J.t() @ r.reshape(-1))
        # damping + gauge fixing
        H = H + torch.diag(lam * torch.diagonal(H) + 1e-6)
        H = torch.where(free_d[:, None] & free_d[None, :], H,
                        torch.zeros_like(H))
        H = H + torch.diag((~free_d).to(H.dtype))
        b = torch.where(free_d, b, torch.zeros_like(b))
        L = torch.linalg.cholesky_ex(H + 1e-8 * eye).L
        dx = torch.cholesky_solve(b[:, None], L)[:, 0].reshape(K, D)
        return torch.where(free[:, None], dx, torch.zeros_like(dx))

    s, q, t = s0, q0, t0
    lam = torch.full((), 1e-6, dtype=s0.dtype, device=dev)
    for _ in range(n_iters):
        r, cost0 = cost(s, q, t)
        dx = solve(s, q, t, r, lam)
        if fix_scale:
            dx = dx * const_tensor(_NO_SCALE, dx.dtype, dev)
        ds, dq, dt = sim3.exp(dx)
        s2, q2, t2 = sim3.compose(ds, dq, dt, s, q, t)
        q2 = se3.quat_normalize(q2)
        accept = cost(s2, q2, t2)[1] < cost0
        s = torch.where(accept, s2, s)
        q = torch.where(accept, q2, q)
        t = torch.where(accept, t2, t)
        lam = torch.where(accept, lam * 0.5, lam * 5.0).clamp(1e-10, 1e5)
    return PoseGraphResult(s=s, q=q, t=t, final_chi2=cost(s, q, t)[1])
