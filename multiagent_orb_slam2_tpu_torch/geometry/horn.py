"""Closed-form Sim3 from 3D-3D correspondences (Horn 1987) + batched RANSAC.

Counterpart of the JAX package's ``geometry/horn.py`` (the reference's
Sim3Solver: Horn's quaternion absolute orientation and its RANSAC, budget
300 hypotheses). Every hypothesis is one batch: 3-point samples drawn up
front, batched Horn solves, one broadcast inlier check of every hypothesis
against every correspondence in both images. Fixed budget, no early exit,
and no host wait: the samples come from a seeded generator on the device,
the best hypothesis is selected on the device.

RANSAC is split into ``draw_samples`` and ``score_samples``, so a test can
score the JAX package's own samples (this port cannot reproduce
``jax.random``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.torch_ops import const_tensor
from . import se3
from .camera import Intrinsics

# rows (and columns) left in each 3x3 minor of a 4x4 matrix
_MINOR = ((1, 2, 3), (0, 2, 3), (0, 1, 3), (0, 1, 2))
_COFACTOR_SIGN = tuple(tuple((-1.0) ** (i + j) for j in range(4))
                      for i in range(4))
_NEWTON_STEPS = 30


def _det3(m):
    return (m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2]
                            - m[..., 1, 2] * m[..., 2, 1])
            - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2]
                              - m[..., 1, 2] * m[..., 2, 0])
            + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1]
                              - m[..., 1, 1] * m[..., 2, 0]))


def top_eigenvector(N):
    """Unit eigenvector of the largest eigenvalue of symmetric N [..., 4, 4],
    computed in float64 without a host wait (``torch.linalg.eigh`` reads its
    error flags back to the host on CUDA).

    The largest root of the characteristic polynomial (coefficients from
    the power sums tr N^k) is found by Newton's method from the Frobenius
    norm, which lies above every eigenvalue: from there the iterates fall
    monotonically onto the largest root. The eigenvector is the column of
    largest norm of adj(N - lambda I), which is proportional to v v^T."""
    A = N.to(torch.float64)
    A2 = A @ A
    p1 = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1)
    p2 = torch.diagonal(A2, dim1=-2, dim2=-1).sum(-1)
    p3 = torch.diagonal(A2 @ A, dim1=-2, dim2=-1).sum(-1)
    p4 = torch.diagonal(A2 @ A2, dim1=-2, dim2=-1).sum(-1)
    e1 = p1
    e2 = (e1 * p1 - p2) / 2.0
    e3 = (e2 * p1 - e1 * p2 + p3) / 3.0
    e4 = (e3 * p1 - e2 * p2 + e1 * p3 - p4) / 4.0
    lam = torch.sqrt(p2) + 1e-30
    for _ in range(_NEWTON_STEPS):
        f = (((lam - e1) * lam + e2) * lam - e3) * lam + e4
        df = ((4.0 * lam - 3.0 * e1) * lam + 2.0 * e2) * lam - e3
        lam = lam - f / torch.where(df > 0, df, torch.ones_like(df))
    B = A - lam[..., None, None] * torch.eye(4, dtype=A.dtype,
                                             device=A.device)
    idx = const_tensor(_MINOR, torch.int64, A.device)
    minors = B[..., idx[:, None, :, None], idx[None, :, None, :]]
    sign = const_tensor(_COFACTOR_SIGN, A.dtype, A.device)
    adj = sign * _det3(minors)                         # [..., 4, 4], symmetric
    col = torch.argmax(torch.linalg.norm(adj, dim=-2), dim=-1)
    v = torch.gather(adj, -1, col[..., None, None].expand(
        adj.shape[:-1] + (1,)))[..., 0]
    v = v / torch.linalg.norm(v, dim=-1, keepdim=True).clamp_min(1e-300)
    return v.to(N.dtype)


def horn_sim3(p1, p2, fix_scale: bool = False):
    """Batched Horn absolute orientation: p1, p2 [..., N, 3] -> (s, q, t)
    mapping frame-1 points into frame 2: p2 ~ s R p1 + t."""
    c1 = torch.mean(p1, dim=-2, keepdim=True)
    c2 = torch.mean(p2, dim=-2, keepdim=True)
    r1 = p1 - c1
    r2 = p2 - c2
    M = torch.einsum("...ni,...nj->...ij", r1, r2)     # [..., 3, 3]
    Sxx, Sxy, Sxz = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    Syx, Syy, Syz = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    Szx, Szy, Szz = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    N = torch.stack([
        torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
        torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
        torch.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], -1),
        torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], -1),
    ], dim=-2)                                         # [..., 4, 4]
    q = se3.quat_normalize(top_eigenvector(N))
    r1_rot = se3.quat_rotate(q[..., None, :], r1)
    if fix_scale:
        s = torch.ones(q.shape[:-1], dtype=q.dtype, device=q.device)
    else:
        # reference: s = sum(r2 . R r1) / sum(|r1|^2)
        s = torch.sum(r2 * r1_rot, dim=(-2, -1)) / torch.sum(
            r1 * r1, dim=(-2, -1)).clamp_min(1e-12)
    t = c2[..., 0, :] - s[..., None] * se3.quat_rotate(q, c1[..., 0, :])
    return s, q, t


class Sim3RansacResult(NamedTuple):
    ok: torch.Tensor          # 0-d bool
    s: torch.Tensor
    q: torch.Tensor
    t: torch.Tensor
    inliers: torch.Tensor     # [N] bool
    n_inliers: torch.Tensor   # 0-d int64


def draw_samples(mask, n_iters: int, seed: int, size: int = 3):
    """[n_iters, size] indices of distinct correspondences, each row drawn
    uniformly among those with `mask` set (the JAX package draws with
    probabilities mask / sum(mask), without replacement): the `size`
    largest of one uniform number per correspondence, from a generator on
    the mask's device seeded with `seed`."""
    gen = torch.Generator(device=mask.device)
    gen.manual_seed(int(seed))
    u = torch.rand((n_iters, mask.shape[0]), generator=gen,
                   device=mask.device)
    keys = torch.where(mask[None, :], u, torch.full_like(u, -1.0))
    return torch.topk(keys, size, dim=-1).indices


def _project(cam: Intrinsics, p):
    z = p[..., 2].clamp_min(1e-6)
    return torch.stack([cam.fx * p[..., 0] / z + cam.cx,
                        cam.fy * p[..., 1] / z + cam.cy], dim=-1)


def score_samples(p1, p2, uv1, uv2, sigma2_1, sigma2_2, mask,
                  cam: Intrinsics, samples, min_inliers: int = 20,
                  fix_scale: bool = False) -> Sim3RansacResult:
    """One Horn hypothesis per row of `samples` [B, 3]; the hypothesis with
    the most bidirectional inliers wins, the first of equals (as jnp.argmax
    picks). Inlier: reprojection below 9.21 sigma^2 in both images."""
    s, q, t = horn_sim3(p1[samples], p2[samples], fix_scale)    # [B]
    # hypothesis x point: map p1 -> frame 2, p2 -> frame 1
    p1_in2 = (s[:, None, None] * se3.quat_rotate(q[:, None, :], p1[None])
              + t[:, None, :])
    si, qi = 1.0 / s, se3.quat_conj(q)
    ti = -si[:, None] * se3.quat_rotate(qi, t)
    p2_in1 = (si[:, None, None] * se3.quat_rotate(qi[:, None, :], p2[None])
              + ti[:, None, :])
    e2 = torch.sum((_project(cam, p1_in2) - uv2[None]) ** 2, -1)   # [B, N]
    e1 = torch.sum((_project(cam, p2_in1) - uv1[None]) ** 2, -1)
    inl = (e1 < 9.21 * sigma2_1[None]) & (e2 < 9.21 * sigma2_2[None]) \
        & mask[None]
    n_inl = torch.sum(inl, -1)
    best = torch.argmax(n_inl).reshape(1)     # first maximum
    n_best = n_inl.index_select(0, best)[0]
    return Sim3RansacResult(
        ok=n_best >= min_inliers, s=s.index_select(0, best)[0],
        q=q.index_select(0, best)[0], t=t.index_select(0, best)[0],
        inliers=inl.index_select(0, best)[0], n_inliers=n_best)


def sim3_ransac(p1, p2, uv1, uv2, sigma2_1, sigma2_2, mask,
                cam: Intrinsics, seed: int, n_iters: int = 300,
                min_inliers: int = 20, fix_scale: bool = False
                ) -> Sim3RansacResult:
    """RANSAC Sim3 between matched map-point clouds of two keyframes.

    p1/p2: [N, 3] matched points in each keyframe's CAMERA frame; uv1/uv2:
    [N, 2] observed pixels; `seed` takes the place of the JAX package's
    PRNG key (the same integer)."""
    return score_samples(p1, p2, uv1, uv2, sigma2_1, sigma2_2, mask, cam,
                         draw_samples(mask, n_iters, seed), min_inliers,
                         fix_scale)
