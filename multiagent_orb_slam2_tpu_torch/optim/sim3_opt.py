"""Sim3 refinement between two keyframes (OptimizeSim3).

Counterpart of the JAX package's ``optim/sim3_opt.py`` (the reference's
Optimizer::OptimizeSim3): one Sim3 S12 (frame-2 camera coordinates ->
frame-1 camera coordinates) against fixed matched point pairs, with
bidirectional projection residuals, Huber sqrt(10), LM, and an inlier
re-gate between two rounds.

The Jacobian of the residual stack with respect to the 7-vector left
update comes from forward-mode autodiff (``torch.func`` products through
``utils.torch_ops.blockwise_jacfwd``), as the JAX package takes it with
``jax.jacfwd``. The LM loop runs on the device: lambda, the costs and the
accept decision stay tensors, and nothing is read back.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import se3, sim3
from ..geometry.camera import Intrinsics
from ..utils.torch_ops import blockwise_jacfwd, const_tensor

# zeroes the scale component of a 7-vector update (rho, phi, sigma)
_NO_SCALE = (1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.0)


class Sim3OptResult(NamedTuple):
    s: torch.Tensor
    q: torch.Tensor
    t: torch.Tensor
    inliers: torch.Tensor
    n_inliers: torch.Tensor


def _residuals(xi, s0, q0, t0, x1, x2, uv1, uv2, cam: Intrinsics,
               fix_scale: bool):
    """Bidirectional reprojection residuals for the update exp(xi) o S12;
    xi is [1, 7] (one row, see blockwise_jacfwd)."""
    if fix_scale:
        xi = xi * const_tensor(_NO_SCALE, xi.dtype, xi.device)
    ds, dq, dt = sim3.exp(xi)
    s, q, t = sim3.compose(ds, dq, dt, s0, q0, t0)
    si, qi, ti = sim3.inverse(s, q, t)

    def project(p):
        z = p[..., 2].clamp_min(1e-6)
        return torch.stack([cam.fx * p[..., 0] / z + cam.cx,
                            cam.fy * p[..., 1] / z + cam.cy], -1)

    p2_in1 = s * se3.quat_rotate(q, x2) + t
    p1_in2 = si * se3.quat_rotate(qi, x1) + ti
    r1 = uv1 - project(p2_in1)        # [N, 2] error in image 1
    r2 = uv2 - project(p1_in2)        # [N, 2] error in image 2
    return r1, r2


def _robust(chi2, delta2: float):
    delta = delta2 ** 0.5
    return torch.where(chi2 <= delta2, chi2,
                       2.0 * delta * torch.sqrt(chi2.clamp_min(1e-12))
                       - delta2)


@torch.no_grad()
def optimize_sim3(s0, q0, t0, x1, x2, uv1, uv2, inv_sigma2_1, inv_sigma2_2,
                  mask, cam: Intrinsics, fix_scale: bool = False,
                  n_iters: int = 10, chi2_th: float = 10.0) -> Sim3OptResult:
    """LM on S12 with Huber(sqrt(10)) and a mid-way outlier erasure, as the
    reference does: n_iters iterations, drop pairs with chi2 > chi2_th in
    either image, n_iters more."""
    dev = x1.device
    zero7 = torch.zeros((1, 7), dtype=x1.dtype, device=dev)
    eye7 = torch.eye(7, dtype=x1.dtype, device=dev)

    def chi2(s, q, t):
        r1, r2 = _residuals(zero7, s, q, t, x1, x2, uv1, uv2, cam, fix_scale)
        return (torch.sum(r1 * r1, -1) * inv_sigma2_1,
                torch.sum(r2 * r2, -1) * inv_sigma2_2)

    def robust_cost(s, q, t, active):
        c1, c2 = chi2(s, q, t)
        return torch.sum((_robust(c1, chi2_th) + _robust(c2, chi2_th))
                         * active)

    def lm_iters(s, q, t, active, n):
        lam = torch.full((), 1e-4, dtype=x1.dtype, device=dev)
        w1 = torch.sqrt(inv_sigma2_1 * active)
        w2 = torch.sqrt(inv_sigma2_2 * active)
        for _ in range(n):
            def res_flat(xi, s=s, q=q, t=t):
                r1, r2 = _residuals(xi, s, q, t, x1, x2, uv1, uv2, cam,
                                    fix_scale)
                return torch.cat([(r1 * w1[:, None]).reshape(1, -1),
                                  (r2 * w2[:, None]).reshape(1, -1)], 1)

            J = blockwise_jacfwd(res_flat, zero7)[0]     # [4N, 7]
            r = res_flat(zero7)[0]
            # Huber IRLS on per-observation 2-vector blocks
            c = torch.sum(r.reshape(-1, 2) ** 2, -1)
            w_rob = torch.minimum(torch.ones_like(c),
                                  torch.sqrt(chi2_th / c.clamp_min(1e-12)))
            w = torch.repeat_interleave(w_rob, 2)
            H = J.t() @ (J * w[:, None])
            b = -(J.t() @ (r * w))
            H = H + lam * torch.diag(torch.diagonal(H).clamp_min(1e-6))
            dx = torch.linalg.solve_ex(H + 1e-9 * eye7, b).result
            if fix_scale:
                dx = dx * const_tensor(_NO_SCALE, dx.dtype, dev)
            ds, dq, dt = sim3.exp(dx)
            s2, q2, t2 = sim3.compose(ds, dq, dt, s, q, t)
            accept = robust_cost(s2, q2, t2, active) \
                < robust_cost(s, q, t, active)
            s = torch.where(accept, s2, s)
            q = torch.where(accept, q2, q)
            t = torch.where(accept, t2, t)
            lam = torch.where(accept, lam * 0.5, lam * 5.0).clamp(1e-8, 1e5)
        return s, q, t

    s, q, t = lm_iters(s0, q0, t0, mask.to(x1.dtype), n_iters)
    c1, c2 = chi2(s, q, t)
    inl = mask & (c1 <= chi2_th) & (c2 <= chi2_th)
    s, q, t = lm_iters(s, q, t, inl.to(x1.dtype), n_iters)
    c1, c2 = chi2(s, q, t)
    inl = mask & (c1 <= chi2_th) & (c2 <= chi2_th)
    return Sim3OptResult(s=s, q=q, t=t, inliers=inl,
                         n_inliers=torch.sum(inl.to(torch.int32)))
