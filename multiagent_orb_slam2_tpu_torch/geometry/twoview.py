"""Monocular two-view bootstrap: parallel homography / fundamental RANSAC.

Counterpart of the JAX package's ``geometry/twoview.py`` (reference
Initializer): 200 RANSAC hypotheses of a homography (8-point DLT) and of a
fundamental matrix (8-point) as one batch, model selection by the score
ratio RH > 0.4, a least-squares refit of each winner on its inliers, then
motion recovery (Faugeras decomposition of H: 8 hypotheses; decomposition
of E: 4), every hypothesis triangulating every match in one batched DLT and
scored by cheirality, parallax and reprojection.

The RANSAC is split as the port's EPnP and Horn RANSACs are:
``draw_samples`` draws the [n_iters, 8] sample rows from a seeded generator
on the mask's device, and ``initialize_two_view`` takes the rows, so a
parity test can feed it the JAX package's own draws.

Host waits on CUDA: ``torch.linalg.svd`` reads its error flags back, once
per call; ``initialize_two_view`` makes nine such calls (the two batched
8-point SVDs and F's rank-2 projection, the two refits and the refit F's
projection, the decompositions of H and E, the batched triangulation).
Inverses go through ``inv_ex`` and determinants of 3x3 matrices are
written out, so neither waits. Mono initialization runs this once per
map.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..utils.torch_ops import const_tensor
from . import horn, se3
from .camera import Intrinsics


class TwoViewResult(NamedTuple):
    ok: torch.Tensor          # 0-d bool
    q: torch.Tensor           # [4] world-to-cam2 rotation (cam1 = identity)
    t: torch.Tensor           # [3] unit-norm translation
    points: torch.Tensor      # [N, 3] triangulated points in cam1 frame
    inliers: torch.Tensor     # [N] bool triangulated-good mask
    used_homography: torch.Tensor


def draw_samples(mask, n_iters: int, seed: int):
    """[n_iters, 8] indices, distinct within a row, drawn uniformly among the
    matches with `mask` set (the JAX package draws with probabilities
    mask / sum(mask), without replacement), from a generator on the mask's
    device seeded with `seed`."""
    return horn.draw_samples(mask, n_iters, seed, size=8)


def _det3(M):
    """Determinant of [..., 3, 3] matrices, written out (no LU, no wait)."""
    return (M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2]
                            - M[..., 1, 2] * M[..., 2, 1])
            - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2]
                              - M[..., 1, 2] * M[..., 2, 0])
            + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1]
                              - M[..., 1, 1] * M[..., 2, 0]))


def _inv(M):
    return torch.linalg.inv_ex(M)[0]


def _normalize(x, mask):
    """Zero-mean unit-mean-abs-dev normalization (reference Normalize).
    Returns (normalized points [N, 2], T [3, 3])."""
    n = torch.sum(mask).clamp_min(1).to(x.dtype)
    m = mask[:, None]
    mean = torch.sum(torch.where(m, x, torch.zeros_like(x)), 0) / n
    d = torch.where(m, x - mean, torch.zeros_like(x))
    md = torch.sum(torch.abs(d), 0) / n
    s = 1.0 / md.clamp_min(1e-9)
    xn = d * s
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    one = torch.ones((), dtype=x.dtype, device=x.device)
    T = torch.stack([torch.stack([s[0], zero, -mean[0] * s[0]]),
                     torch.stack([zero, s[1], -mean[1] * s[1]]),
                     torch.stack([zero, zero, one])])
    return xn, T


def _dlt_h(p1, p2):
    """Batched homography DLT from 8 correspondences [B, 8, 2] -> [B, 3, 3]."""
    B = p1.shape[0]
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    z = torch.zeros_like(x1)
    o = torch.ones_like(x1)
    r1 = torch.stack([z, z, z, -x1, -y1, -o, y2 * x1, y2 * y1, y2], -1)
    r2 = torch.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2], -1)
    A = torch.cat([r1, r2], dim=1)                  # [B, 16, 9]
    vt = torch.linalg.svd(A, full_matrices=True)[2]
    return vt[..., -1, :].reshape(B, 3, 3)


def _rank2(F):
    """The nearest rank-2 matrix of each F [..., 3, 3]."""
    u, s, vt = torch.linalg.svd(F)
    s = torch.cat([s[..., :2], torch.zeros_like(s[..., 2:])], -1)
    return u @ (s[..., None] * vt)


def _eight_point_f(p1, p2):
    """Batched fundamental from 8 correspondences -> [B, 3, 3], rank-2."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    o = torch.ones_like(x1)
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, o],
                    -1)
    vt = torch.linalg.svd(A, full_matrices=True)[2]
    return _rank2(vt[..., -1, :].reshape(-1, 3, 3))


def _homog(x):
    return torch.cat([x, torch.ones_like(x[..., :1])], -1)


def _score_h(H, H_inv, x1, x2, mask, sigma: float = 1.0):
    """Symmetric transfer error score (reference CheckHomography)."""
    th = 5.991
    inv_s2 = 1.0 / (sigma * sigma)

    def transfer(M, a, b):
        """M [B,3,3], a/b [N,2] -> chi2 [B,N] of M*a vs b."""
        p = torch.einsum("bij,nj->bni", M, _homog(a))
        w = p[..., 2:]
        p = p[..., :2] / torch.where(torch.abs(w) < 1e-9,
                                     torch.full_like(w, 1e-9), w)
        return torch.sum((b[None] - p) ** 2, -1) * inv_s2

    c1 = transfer(H_inv, x2, x1)   # [B, N]
    c2 = transfer(H, x1, x2)
    ok = (c1 < th) & (c2 < th) & mask[None]
    score = torch.sum(torch.where(ok, (th - c1) + (th - c2),
                                  torch.zeros_like(c1)), -1)
    return score, ok


def _score_f(F, x1, x2, mask, sigma: float = 1.0):
    """Epipolar distance score (reference CheckFundamental)."""
    th = 3.841
    th_score = 5.991
    inv_s2 = 1.0 / (sigma * sigma)
    x1h = _homog(x1)
    x2h = _homog(x2)
    l2 = x1h @ F.transpose(-1, -2)                       # [B, N, 3] in im2
    d2 = (torch.sum(l2 * x2h[None], -1) ** 2
          / (l2[..., 0] ** 2 + l2[..., 1] ** 2).clamp_min(1e-12)) * inv_s2
    l1 = x2h @ F                                          # [B, N, 3] in im1
    d1 = (torch.sum(l1 * x1h[None], -1) ** 2
          / (l1[..., 0] ** 2 + l1[..., 1] ** 2).clamp_min(1e-12)) * inv_s2
    m = mask[None]
    ok = (d1 < th) & (d2 < th) & m
    zero = torch.zeros_like(d1)
    score = torch.sum(torch.where((d1 < th) & m, th_score - d1, zero)
                      + torch.where((d2 < th) & m, th_score - d2, zero), -1)
    return score, ok


def triangulate_batch(P1, P2, x1, x2):
    """Batched linear triangulation (Initializer::Triangulate):
    P1, P2 [..., 3, 4]; x1, x2 [..., 2] -> [..., 3] points (in frame of P1).
    """
    rows = [
        x1[..., 0:1] * P1[..., 2, :] - P1[..., 0, :],
        x1[..., 1:2] * P1[..., 2, :] - P1[..., 1, :],
        x2[..., 0:1] * P2[..., 2, :] - P2[..., 0, :],
        x2[..., 1:2] * P2[..., 2, :] - P2[..., 1, :],
    ]
    A = torch.stack(rows, dim=-2)
    _, _, vt = torch.linalg.svd(A)
    Xh = vt[..., -1, :]
    w = Xh[..., 3:]
    return Xh[..., :3] / torch.where(torch.abs(w) < 1e-12,
                                     torch.full_like(w, 1e-12), w)


def _check_rt(R, t, x1, x2, mask, cam: Intrinsics, sigma2: float = 1.0):
    """Cheirality + parallax + reprojection check of the motion hypotheses
    R [H, 3, 3], t [H, 3] over all matches (reference CheckRT). x1 / x2 are
    normalized camera coords. Returns (n_good [H], parallax [H] degrees,
    good [H, N], points [H, N, 3] in cam1)."""
    th2 = 4.0 * sigma2
    Hn = R.shape[0]
    dev, dt = R.device, R.dtype
    P1 = torch.cat([torch.eye(3, dtype=dt, device=dev),
                    torch.zeros((3, 1), dtype=dt, device=dev)], -1
                   ).expand(Hn, 3, 4)
    P2 = torch.cat([R, t[..., None]], -1)
    x1b = x1.expand((Hn,) + x1.shape)
    x2b = x2.expand((Hn,) + x2.shape)
    X = triangulate_batch(P1[:, None], P2[:, None], x1b, x2b)   # [H, N, 3]

    z1 = X[..., 2]
    Xc2 = torch.einsum("hij,hnj->hni", R, X) + t[:, None, :]
    z2 = Xc2[..., 2]
    o2 = -torch.einsum("hij,hi->hj", R, t)        # cam2 centre in cam1
    r1 = X
    r2 = X - o2[:, None, :]
    cosp = torch.sum(r1 * r2, -1) / (
        torch.linalg.norm(r1, dim=-1) * torch.linalg.norm(r2, dim=-1)
    ).clamp_min(1e-12)
    p1 = X[..., :2] / X[..., 2:].clamp_min(1e-9)
    p2 = Xc2[..., :2] / Xc2[..., 2:].clamp_min(1e-9)
    e1 = torch.sum((p1 - x1b) ** 2, -1) * cam.fx * cam.fx
    e2 = torch.sum((p2 - x2b) ** 2, -1) * cam.fx * cam.fx
    good = mask[None] & (z1 > 0) & (z2 > 0) & (cosp < 0.99998) \
        & (e1 < th2) & (e2 < th2)
    n_good = torch.sum(good, -1)
    cosp_masked = torch.where(good, cosp, torch.ones_like(cosp))
    k = min(50, cosp.shape[-1] - 1)
    par = torch.rad2deg(torch.arccos(torch.sort(cosp_masked, -1).values[
        ..., k].clamp(-1.0, 1.0)))
    return n_good, par, good, X


def _decompose_e(E):
    """E -> 4 motion hypotheses (R [4, 3, 3], t [4, 3])."""
    u, _, vt = torch.linalg.svd(E)
    W = const_tensor(((0.0, -1.0, 0.0), (1.0, 0.0, 0.0), (0.0, 0.0, 1.0)),
                     E.dtype, E.device)
    R1 = u @ W @ vt
    R2 = u @ W.T @ vt
    R1 = R1 * torch.sign(_det3(R1))
    R2 = R2 * torch.sign(_det3(R2))
    t = u[:, 2]
    t = t / torch.linalg.norm(t).clamp_min(1e-12)
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


def _decompose_h(H):
    """Faugeras SVD decomposition of a euclidean homography -> 8 hypotheses
    (reference ReconstructH)."""
    U, w, Vt = torch.linalg.svd(H)
    s = _det3(U) * _det3(Vt)
    d1, d2, d3 = w[0], w[1], w[2]
    dev, dt = H.device, H.dtype

    aux1 = torch.sqrt(((d1 * d1 - d2 * d2) / (d1 * d1 - d3 * d3).clamp_min(
        1e-12)).clamp_min(0.0))
    aux3 = torch.sqrt(((d2 * d2 - d3 * d3) / (d1 * d1 - d3 * d3).clamp_min(
        1e-12)).clamp_min(0.0))
    sx1 = const_tensor((1.0, 1.0, -1.0, -1.0), dt, dev)
    sx3 = const_tensor((1.0, -1.0, 1.0, -1.0), dt, dev)
    x1s = aux1 * sx1
    x3s = aux3 * sx3
    sgn = torch.where(x1s * x3s >= 0, 1.0, -1.0)
    zero = torch.zeros(4, dtype=dt, device=dev)
    one = torch.ones(4, dtype=dt, device=dev)
    root = torch.sqrt(((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3)
                       ).clamp_min(0.0))

    # case d' > 0
    sin_t = root / ((d1 + d3) * d2).clamp_min(1e-12)
    cos_t = (d2 * d2 + d1 * d3) / ((d1 + d3) * d2).clamp_min(1e-12)
    st = sin_t * sgn
    ct = cos_t * one
    Rp = torch.stack([torch.stack([ct, zero, -st], -1),
                      torch.stack([zero, one, zero], -1),
                      torch.stack([st, zero, ct], -1)], -2)      # [4, 3, 3]
    tp = torch.stack([x1s, zero, -x3s], -1) * (d1 - d3)
    # case d' < 0
    sin_p = root / ((d1 - d3) * d2).clamp_min(1e-12)
    cos_p = (d1 * d3 - d2 * d2) / ((d1 - d3) * d2).clamp_min(1e-12)
    sp = sin_p * sgn
    cp = cos_p * one
    Rn = torch.stack([torch.stack([cp, zero, sp], -1),
                      torch.stack([zero, -one, zero], -1),
                      torch.stack([sp, zero, -cp], -1)], -2)
    tn = torch.stack([x1s, zero, x3s], -1) * (d1 + d3)

    Rs = s * (U @ torch.cat([Rp, Rn]) @ Vt)
    ts = torch.cat([tp, tn]) @ U.T
    ts = ts / torch.linalg.norm(ts, dim=-1, keepdim=True).clamp_min(1e-12)
    return Rs, ts


@functools.lru_cache(maxsize=16)
def k_matrices(cam: Intrinsics, device_str: str):
    """(K, K^-1) as float32 tensors on the device; the inverse is taken on
    the host."""
    Kmat = np.asarray(cam.K.numpy(), np.float32)
    Kinv = np.linalg.inv(Kmat).astype(np.float32)
    return (torch.from_numpy(Kmat).to(device_str),
            torch.from_numpy(Kinv).to(device_str))


def _refit_h(xn1, xn2, w, T1, T2):
    x1n, y1n = xn1[:, 0], xn1[:, 1]
    x2n, y2n = xn2[:, 0], xn2[:, 1]
    z = torch.zeros_like(x1n)
    o = torch.ones_like(x1n)
    r1 = torch.stack([z, z, z, -x1n, -y1n, -o, y2n * x1n, y2n * y1n, y2n], -1)
    r2 = torch.stack([x1n, y1n, o, z, z, z, -x2n * x1n, -x2n * y1n, -x2n], -1)
    A = torch.cat([r1 * w[:, None], r2 * w[:, None]], dim=0)
    vt = torch.linalg.svd(A, full_matrices=True)[2]
    Hf = _inv(T2) @ vt[-1].reshape(3, 3) @ T1
    h22 = Hf[2, 2]
    return Hf / torch.where(torch.abs(h22) < 1e-12,
                            torch.full_like(h22, 1e-12), h22)


def _refit_f(xn1, xn2, w, T1, T2):
    x1n, y1n = xn1[:, 0], xn1[:, 1]
    x2n, y2n = xn2[:, 0], xn2[:, 1]
    o = torch.ones_like(x1n)
    A = torch.stack([x2n * x1n, x2n * y1n, x2n, y2n * x1n, y2n * y1n, y2n,
                     x1n, y1n, o], -1) * w[:, None]
    vt = torch.linalg.svd(A, full_matrices=True)[2]
    return T2.T @ _rank2(vt[-1].reshape(3, 3)) @ T1


def _pick(x, i):
    """x[i] for a 1-element index tensor, without a host read."""
    return x.index_select(0, i)[0]


@torch.no_grad()
def initialize_two_view(x1_px, x2_px, mask, cam: Intrinsics, samples,
                        sigma: float = 1.0) -> TwoViewResult:
    """Mono initialization from matched pixel coords x1_px / x2_px [N, 2]
    and the RANSAC's sample rows `samples` [B, 8] (``draw_samples``).

    Returns the motion (cam1 = identity, cam2 pose) and the triangulated
    points. Scale is arbitrary (unit translation); the initial map
    normalizes it by the median depth. Everything stays on the device; the
    caller fetches `ok`.
    """
    dev = x1_px.device
    samples = samples.to(device=dev, dtype=torch.int64)
    xn1, T1 = _normalize(x1_px, mask)
    xn2, T2 = _normalize(x2_px, mask)
    s1 = xn1[samples]
    s2 = xn2[samples]

    # homography hypotheses
    Hn = _dlt_h(s1, s2)
    H = _inv(T2) @ Hn @ T1                      # denormalized, px -> px
    h22 = H[:, 2:3, 2:3]
    H = H / torch.where(torch.abs(h22) < 1e-12, torch.full_like(h22, 1e-12),
                        h22)
    h_scores, h_in = _score_h(H, _inv(H), x1_px, x2_px, mask, sigma)
    bi_h = torch.argmax(h_scores).reshape(1)
    SH = _pick(h_scores, bi_h)

    # fundamental hypotheses
    Fn = _eight_point_f(s1, s2)
    F = T2.T @ Fn @ T1
    f_scores, f_in = _score_f(F, x1_px, x2_px, mask, sigma)
    bi_f = torch.argmax(f_scores).reshape(1)
    SF = _pick(f_scores, bi_f)

    RH = SH / (SH + SF).clamp_min(1e-9)
    use_h = RH > 0.40

    # refit the winning models on all their inliers before decomposition
    h_best_in = _pick(h_in, bi_h)
    f_best_in = _pick(f_in, bi_f)
    H_best = _refit_h(xn1, xn2, h_best_in.to(x1_px.dtype), T1, T2)
    F_best = _refit_f(xn1, xn2, f_best_in.to(x1_px.dtype), T1, T2)

    # normalized camera coordinates for motion recovery
    Kmat, Kinv = k_matrices(cam, str(dev))
    c1 = (_homog(x1_px) @ Kinv.T)[:, :2]
    c2 = (_homog(x2_px) @ Kinv.T)[:, :2]

    Rh, th = _decompose_h(Kinv @ H_best @ Kmat)     # 8 from K^-1 H K
    Rf, tf = _decompose_e(Kmat.T @ F_best @ Kmat)   # 4 from E = K^T F K

    Rs = torch.cat([Rh, Rf])                         # [12, 3, 3]
    ts = torch.cat([th, tf])
    idx = torch.arange(12, device=dev)
    hyp_valid = torch.where(use_h, idx < 8, idx >= 8)
    in_mask = torch.where(use_h, h_best_in, f_best_in) & mask

    n_good, par, good, X = _check_rt(Rs, ts, c1, c2, in_mask, cam,
                                     sigma2=sigma * sigma)
    n_good = torch.where(hyp_valid, n_good, torch.full_like(n_good, -1))
    best = torch.argmax(n_good).reshape(1)
    n_best = _pick(n_good, best)
    n_second = torch.sort(n_good).values[-2]
    n_inliers = torch.sum(in_mask)

    # acceptance (reference ReconstructF/H): a clear winner, enough points,
    # enough parallax
    ok = (n_best > 0.7 * n_inliers) & (n_best > 40) \
        & (n_second < 0.75 * n_best) & (_pick(par, best) > 1.0)

    q = se3.matrix_to_quat(_pick(Rs, best))
    return TwoViewResult(ok=ok, q=q, t=_pick(ts, best),
                         points=_pick(X, best), inliers=_pick(good, best),
                         used_homography=use_h)
