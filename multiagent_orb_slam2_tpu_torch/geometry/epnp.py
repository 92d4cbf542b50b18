"""Batched EPnP + RANSAC for relocalization.

Counterpart of the JAX package's ``geometry/epnp.py`` (the reference's
PnPsolver: EPnP with 4 control points and barycentric coordinates inside an
adaptive RANSAC). RANSAC hypotheses form one batch: every hypothesis solves
EPnP on a 6-point subset through one batched 12x12 eigendecomposition; the
dominant (N = 1) beta case recovers the control points in the camera frame
up to scale, fixed by matching the inter-control-point distances; the rigid
transform comes from the batched Horn solver. All hypotheses are scored
against all matches in one broadcast.

RANSAC is split into ``draw_samples`` and ``score_samples``, as Sim3 RANSAC
is in ``geometry/horn.py``, so a test can score the JAX package's own
samples (``jax.random.choice(p=...)`` cannot be reproduced here).

``torch.linalg.eigh`` reads its error flags back to the host on CUDA: two
waits a RANSAC call (the 3x3 control-point axes and the 12x12 null vector).
Relocalization runs on LOST frames only. The smallest eigenvector's sign is
free; the cheirality flip absorbs it, so hypotheses compare by pose.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import horn, se3
from .camera import Intrinsics


def _control_points(pw):
    """Centroid + principal axes control points [..., 4, 3]
    (reference choose_control_points)."""
    c = torch.mean(pw, dim=-2, keepdim=True)
    d = pw - c
    cov = torch.einsum("...ni,...nj->...ij", d, d) / pw.shape[-2]
    wvals, v = torch.linalg.eigh(cov)
    scale = torch.sqrt(wvals.clamp_min(1e-9))[..., None, :]
    axes = torch.swapaxes(v * scale, -1, -2)            # [..., 3(axis), 3]
    return torch.cat([c, c + axes], dim=-2)             # [..., 4, 3]


def _barycentric(pw, cps):
    """alpha s.t. p = sum_j alpha_j c_j and sum alpha = 1
    (compute_barycentric)."""
    base = cps[..., 1:, :] - cps[..., :1, :]            # [..., 3, 3]
    eye = torch.eye(3, dtype=pw.dtype, device=pw.device)
    inv = torch.linalg.inv_ex(torch.swapaxes(base, -1, -2) + 1e-9 * eye)[0]
    rel = pw - cps[..., :1, :]
    a123 = torch.einsum("...ij,...nj->...ni", inv, rel)
    a0 = 1.0 - torch.sum(a123, dim=-1, keepdim=True)
    return torch.cat([a0, a123], dim=-1)                # [..., n, 4]


def _pdists(c):
    d = c[..., :, None, :] - c[..., None, :, :]
    return torch.sqrt(torch.sum(d * d, dim=-1) + 1e-12)


def epnp_solve(pw, uv, cam: Intrinsics):
    """EPnP pose from correspondences pw [..., n, 3], uv [..., n, 2].

    Returns (q, t) world-to-camera. Batched over leading axes."""
    n = pw.shape[-2]
    lead = pw.shape[:-2]
    cps = _control_points(pw)
    alpha = _barycentric(pw, cps)                       # [..., n, 4]

    # M: one row for u and one for v per point (reference fill_M)
    xn = (uv[..., 0] - cam.cx) / cam.fx
    yn = (uv[..., 1] - cam.cy) / cam.fy
    zero = torch.zeros_like(alpha)
    # row_u: [a0, 0, -a0*xn, a1, 0, -a1*xn, ...] over the 4 control points
    ru = torch.stack([alpha, zero, -alpha * xn[..., None]], dim=-1)
    rv = torch.stack([zero, alpha, -alpha * yn[..., None]], dim=-1)
    M = torch.cat([ru.reshape(*lead, n, 12), rv.reshape(*lead, n, 12)],
                  dim=-2)
    MtM = torch.einsum("...ni,...nj->...ij", M, M)
    _, vecs = torch.linalg.eigh(MtM)
    # the control points in the camera frame, up to scale
    cc = vecs[..., :, 0].reshape(*lead, 4, 3)

    # N = 1 beta: match the inter-control-point distances
    dw = _pdists(cps)
    dc = _pdists(cc)
    beta = torch.sum(dc * dw, dim=(-2, -1)) / torch.sum(
        dc * dc, dim=(-2, -1)).clamp_min(1e-12)
    cc = cc * beta[..., None, None]
    # cheirality: points must lie in front; flip if the mean z < 0
    pc = torch.einsum("...nj,...jk->...nk", alpha, cc)
    flip = torch.mean(pc[..., 2], dim=-1) < 0
    cc = torch.where(flip[..., None, None], -cc, cc)

    # rigid transform: world control points -> camera control points
    _, q, t = horn.horn_sim3(cps, cc, fix_scale=True)
    return q, t


class PnPRansacResult(NamedTuple):
    ok: torch.Tensor          # 0-d bool
    q: torch.Tensor
    t: torch.Tensor
    inliers: torch.Tensor     # [N] bool
    n_inliers: torch.Tensor   # 0-d int64


def draw_samples(mask, n_iters: int, sample: int, seed: int):
    """[n_iters, sample] indices, distinct within a row, drawn uniformly among
    the correspondences with `mask` set (the JAX package draws with
    probabilities mask / sum(mask), without replacement), from a generator
    on the mask's device seeded with `seed`."""
    return horn.draw_samples(mask, n_iters, seed, size=sample)


def score_hypotheses(q, t, pw, uv, sigma2, mask, cam: Intrinsics,
                     min_inliers: int = 10, chi2_th: float = 5.991
                     ) -> PnPRansacResult:
    """The hypothesis (q [B, 4], t [B, 3]) with the most inliers among the
    correspondences, the first of equals (as jnp.argmax picks). Inlier:
    reprojection below chi2_th sigma^2, in front of the camera."""
    pc = se3.apply(q[:, None, :], t[:, None, :], pw[None])
    z = pc[..., 2].clamp_min(1e-6)
    u = cam.fx * pc[..., 0] / z + cam.cx
    v = cam.fy * pc[..., 1] / z + cam.cy
    err2 = ((u - uv[None, :, 0]) ** 2 + (v - uv[None, :, 1]) ** 2) / sigma2
    inl = (err2 < chi2_th) & (pc[..., 2] > 0.05) & mask[None]
    n_inl = torch.sum(inl, dim=-1)
    best = torch.argmax(n_inl).reshape(1)     # first maximum
    n_best = n_inl.index_select(0, best)[0]
    return PnPRansacResult(ok=n_best >= min_inliers,
                           q=q.index_select(0, best)[0],
                           t=t.index_select(0, best)[0],
                           inliers=inl.index_select(0, best)[0],
                           n_inliers=n_best)


def score_samples(pw, uv, sigma2, mask, cam: Intrinsics, samples,
                  min_inliers: int = 10, chi2_th: float = 5.991
                  ) -> PnPRansacResult:
    """One EPnP hypothesis per row of `samples` [B, s], scored by
    score_hypotheses."""
    q, t = epnp_solve(pw[samples], uv[samples], cam)     # [B, ...]
    return score_hypotheses(q, t, pw, uv, sigma2, mask, cam, min_inliers,
                            chi2_th)


def epnp_ransac(pw, uv, sigma2, mask, cam: Intrinsics, seed: int,
                n_iters: int = 300, sample: int = 6, min_inliers: int = 10,
                chi2_th: float = 5.991) -> PnPRansacResult:
    """RANSAC over batched EPnP hypotheses (reference PnPsolver::iterate);
    `seed` takes the place of the JAX package's PRNG key (the same
    integer)."""
    return score_samples(pw, uv, sigma2, mask, cam,
                         draw_samples(mask, n_iters, sample, seed),
                         min_inliers, chi2_th)
