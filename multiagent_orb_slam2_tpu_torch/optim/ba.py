"""Bundle adjustment with explicit Schur-complement point marginalization.

Counterpart of the JAX package's ``optim/ba.py`` (reference
Optimizer::BundleAdjustment / LocalBundleAdjustment). Observations are stored
grouped by point, [P, M] with M = max observations per point. Fixed poses keep
their observation contributions (they constrain points) but get identity rows
in the reduced camera system S, so their update is zero. Problem size is
static (capacity-padded); validity is carried in masks.

Two solvers of the same problem:

- ``ba_solve``: the straightforward formulation ([P, M, 3, 6] Jacobians,
  batched 3x3 inverses, dense Cholesky of S). It is the independent oracle of
  the tests.
- ``ba_solve_fast``: the production path. Per LM iteration one fused
  preparation of all per-observation and per-point terms
  (``ba_prep.prep_terms``, a CUDA kernel on the card), the one-hot assembly
  of S as matrix products, and block-Jacobi preconditioned CG
  (``pcg.pcg_solve``, a CUDA kernel on the card), with deferred-accept LM: the
  build at the current parameters yields the robust cost there, which is the
  accept test of the previous step.

The assembly is full width (a (K + 1)-wide one-hot) or banded, as the JAX
package picks it (``band="auto"``: K >= 192 and P >= 8192). Banded, the
points are sorted by their first observing pose, each chunk of them gets a
window of R poses, and the cross-term products run R wide; the points that
leave their window go through an exact full-width overflow pass, sized once
per solve (one host read) so that it holds all of them.

On the card the LM loop never waits for the host: lambda, the costs and the
accept decision stay on the device (``torch.where``), the 6x6 block inverse
is ``torch.linalg.inv_ex`` (``inv`` reads an error flag back), and every sum
that feeds the accept test has a fixed order (no float atomics), so two
solves of the same problem are bit-identical.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..geometry import se3
from ..geometry.camera import Intrinsics
from ..utils.torch_ops import (const_tensor, first_true_indices,
                               host_fetch)
from . import ba_prep, pcg
from . import residuals as res


class BAProblem(NamedTuple):
    """Fixed-capacity BA problem, observations grouped by point."""
    q: torch.Tensor            # [K, 4] world-to-camera rotations
    t: torch.Tensor            # [K, 3]
    pose_valid: torch.Tensor   # [K] bool
    pose_fixed: torch.Tensor   # [K] bool (gauge anchors / boundary poses)
    pw: torch.Tensor           # [P, 3] world points
    point_valid: torch.Tensor  # [P] bool
    obs_kf: torch.Tensor       # [P, M] int32 observing pose index (-1 invalid)
    obs_uvr: torch.Tensor      # [P, M, 3] (u, v, u_right)
    obs_inv_sigma2: torch.Tensor  # [P, M]
    obs_stereo: torch.Tensor   # [P, M] bool
    obs_mask: torch.Tensor     # [P, M] bool


class BAResult(NamedTuple):
    q: torch.Tensor
    t: torch.Tensor
    pw: torch.Tensor
    cost: torch.Tensor         # final robust cost
    obs_chi2: torch.Tensor     # [P, M] final per-observation chi2
    n_iters: torch.Tensor
    band_ov: Optional[torch.Tensor] = None   # out-of-band points (banded)


def _chunks(P: int, chunk: int):
    """(n_chunks, points per chunk): the chunk count must divide P."""
    n_chunks = max(P // max(chunk, 1), 1)
    while P % n_chunks:
        n_chunks -= 1
    return n_chunks, P // n_chunks


def _reduced_system(S_blocks, Hcc, lam, free, idx):
    """Damped reduced camera system from the summed cross blocks
    S_blocks [K, K, 6, 6] and the pose blocks Hcc [K, 6, 6]: fixed / invalid
    poses get identity rows and columns. Returns S [K, K, 6, 6]."""
    eye6 = torch.eye(6, dtype=Hcc.dtype, device=Hcc.device)
    dd = torch.diagonal(Hcc, dim1=-2, dim2=-1)                 # [K, 6]
    S = -S_blocks
    S[idx, idx] += Hcc + torch.diag_embed(lam * dd + 1e-8)
    S = torch.where((free[:, None] & free[None, :])[:, :, None, None], S,
                    torch.zeros_like(S))
    S[idx, idx] += (~free).to(Hcc.dtype)[:, None, None] * eye6
    return S


# ===========================================================================
# Straightforward formulation (the tests' oracle)
# ===========================================================================

def _obs_terms(prob: BAProblem, q, t, pw, cam, delta2_m, delta2_s, use_huber):
    """Residuals, Jacobians and IRLS weights for every observation slot."""
    kf = prob.obs_kf.long().clamp(0, q.shape[0] - 1)
    qk = q[kf]                              # [P, M, 4]
    tk = t[kf]
    pw_b = pw[:, None, :].expand(prob.obs_uvr.shape)
    r, pc = res.project_residual(cam, qk, tk, pw_b, prob.obs_uvr,
                                 prob.obs_stereo)
    Jc, Jp, _ = res.jacobians(cam, qk, tk, pw_b, prob.obs_stereo)
    chi2 = torch.sum(r * r, dim=-1) * prob.obs_inv_sigma2
    delta2 = torch.where(prob.obs_stereo, delta2_s, delta2_m).to(chi2.dtype)
    active = (prob.obs_mask & (prob.obs_kf >= 0)
              & prob.point_valid[:, None] & (pc[..., 2] > 0.01))
    if use_huber:
        w_rob = res.huber_weight(chi2, delta2)
        rho = torch.where(chi2 <= delta2, chi2,
                          2.0 * torch.sqrt(delta2)
                          * torch.sqrt(chi2.clamp_min(1e-12)) - delta2)
    else:
        w_rob = torch.ones_like(chi2)
        rho = chi2
    w = prob.obs_inv_sigma2 * w_rob * active
    cost = torch.sum(rho * active)
    return r, Jc, Jp, w, chi2, cost


def _build_and_solve(prob: BAProblem, q, t, pw, cam, lam, delta2_m, delta2_s,
                     use_huber, chunk: int):
    """One damped normal-equation build + Schur solve. Returns
    (dc [K, 6], dp [P, 3], cost at the build point, chi2 [P, M])."""
    K = q.shape[0]
    P, M = prob.obs_kf.shape
    KK = K + 1
    dev = q.device
    r, Jc, Jp, w, chi2, cost0 = _obs_terms(prob, q, t, pw, cam, delta2_m,
                                           delta2_s, use_huber)

    # per-point blocks
    Hpp = torch.einsum("pmij,pmik,pm->pjk", Jp, Jp, w)        # [P, 3, 3]
    bp = -torch.einsum("pmij,pmi,pm->pj", Jp, r, w)           # [P, 3]
    diag = torch.diagonal(Hpp, dim1=-2, dim2=-1)
    Hpp_inv = torch.linalg.inv(Hpp + torch.diag_embed(lam * diag + 1e-8))

    # Schur + pose-block assembly as one-hot matrix products: with O the
    # per-observation one-hot keyframe assignment, the cross term is
    # S[k1, k2] = sum_p U[p, k1] V[p, k2]^T with U = O^T Y, V = O^T Wb
    Wb = torch.einsum("pmij,pmik,pm->pmjk", Jc, Jp, w)        # [P, M, 6, 3]
    Y = torch.einsum("pmjk,pkl->pmjl", Wb, Hpp_inv)           # [P, M, 6, 3]
    kf_all = torch.where(prob.obs_kf >= 0, prob.obs_kf.long(),
                         torch.full_like(prob.obs_kf, K, dtype=torch.int64))
    Hcc_terms = torch.einsum("pmij,pmik,pm->pmjk", Jc, Jc, w)
    bc_terms = -torch.einsum("pmij,pmi,pm->pmj", Jc, r, w)
    Ybp = torch.einsum("pmjk,pk->pmj", Y, bp)

    S_flat = torch.zeros((KK * 6, KK * 6), dtype=q.dtype, device=dev)
    rhs_p = torch.zeros((KK, 6), dtype=q.dtype, device=dev)
    Hcc_p = torch.zeros((KK, 36), dtype=q.dtype, device=dev)
    bc_p = torch.zeros((KK, 6), dtype=q.dtype, device=dev)
    ids = torch.arange(KK, device=dev)
    n_chunks, cp = _chunks(P, chunk)
    for ci in range(n_chunks):
        sl = slice(ci * cp, (ci + 1) * cp)
        O3 = (kf_all[sl][..., None] == ids).to(q.dtype)       # [c, M, KK]
        Of = O3.reshape(cp * M, KK)
        Hcc_p += Of.t() @ Hcc_terms[sl].reshape(cp * M, 36)
        bc_p += Of.t() @ bc_terms[sl].reshape(cp * M, 6)
        rhs_p += Of.t() @ Ybp[sl].reshape(cp * M, 6)
        U = torch.bmm(O3.transpose(1, 2), Y[sl].reshape(cp, M, 18))
        V = torch.bmm(O3.transpose(1, 2), Wb[sl].reshape(cp, M, 18))
        # rows (point, coordinate), columns (pose, twist component)
        U2 = U.reshape(cp, KK, 6, 3).permute(0, 3, 1, 2).reshape(cp * 3, -1)
        V2 = V.reshape(cp, KK, 6, 3).permute(0, 3, 1, 2).reshape(cp * 3, -1)
        S_flat += U2.t() @ V2
    Hcc = Hcc_p[:K].reshape(K, 6, 6)
    S_blocks = S_flat.reshape(KK, 6, KK, 6).permute(0, 2, 1, 3)[:K, :K]

    free = prob.pose_valid & ~prob.pose_fixed                 # [K]
    S = _reduced_system(S_blocks, Hcc, lam, free,
                        torch.arange(K, device=dev))
    rhs = torch.where(free[:, None], bc_p[:K] - rhs_p[:K],
                      torch.zeros_like(bc_p[:K]))

    # dense reduced solve
    S_dense = S.permute(0, 2, 1, 3).reshape(6 * K, 6 * K)
    L = torch.linalg.cholesky(
        S_dense + 1e-8 * torch.eye(6 * K, dtype=q.dtype, device=dev))
    dc = torch.cholesky_solve(rhs.reshape(-1, 1), L).reshape(K, 6)
    dc = torch.where(free[:, None], dc, torch.zeros_like(dc))

    # point back-substitution
    dc_obs = dc[prob.obs_kf.long().clamp(0, K - 1)]           # [P, M, 6]
    corr = torch.einsum("pmjk,pmj->pk", Wb, dc_obs)           # [P, 3]
    dp = torch.einsum("pkl,pl->pk", Hpp_inv, bp - corr)
    has_obs = torch.any(prob.obs_mask & (prob.obs_kf >= 0), dim=-1)
    dp = torch.where((prob.point_valid & has_obs)[:, None], dp,
                     torch.zeros_like(dp))
    return dc, dp, cost0, chi2


def _apply_step(q, t, pw, dc, dp):
    dq, dt = se3.se3_exp(dc)
    q_new, t_new = se3.compose(dq, dt, q, t)
    return se3.quat_normalize(q_new), t_new, pw + dp


@torch.no_grad()
def ba_solve(prob: BAProblem, cam: Intrinsics, n_iters: int = 10,
             use_huber: bool = True, chi2_mono: float = 5.991,
             chi2_stereo: float = 7.815, chunk: int = 2048) -> BAResult:
    """Levenberg-Marquardt BA (reference 10-iteration GBA / 5+10 local BA)."""
    q, t, pw = prob.q, prob.t, prob.pw
    lam = torch.full((), 1e-4, dtype=q.dtype, device=q.device)
    for _ in range(n_iters):
        dc, dp, cost0, _ = _build_and_solve(prob, q, t, pw, cam, lam,
                                            chi2_mono, chi2_stereo,
                                            use_huber, chunk)
        q_new, t_new, pw_new = _apply_step(q, t, pw, dc, dp)
        cost1 = _obs_terms(prob, q_new, t_new, pw_new, cam, chi2_mono,
                           chi2_stereo, use_huber)[5]
        accept = cost1 < cost0
        q = torch.where(accept, q_new, q)
        t = torch.where(accept, t_new, t)
        pw = torch.where(accept, pw_new, pw)
        lam = torch.where(accept, lam * 0.5, lam * 5.0).clamp(1e-8, 1e4)

    # final per-observation chi2 (for outlier erasure)
    _, _, _, _, chi2, cost = _obs_terms(prob, q, t, pw, cam, chi2_mono,
                                        chi2_stereo, use_huber)
    return BAResult(q=q, t=t, pw=pw, cost=cost, obs_chi2=chi2,
                    n_iters=_int_scalar(n_iters, q.device))


def _int_scalar(v: int, device):
    return torch.full((), v, dtype=torch.int32, device=device)


def outlier_mask(result: BAResult, prob: BAProblem,
                 chi2_mono: float = 5.991, chi2_stereo: float = 7.815):
    """Post-BA observation culling mask (the reference erases edges with
    chi2 > threshold or negative depth)."""
    th = torch.where(prob.obs_stereo, chi2_stereo, chi2_mono)
    return prob.obs_mask & (result.obs_chi2 <= th.to(result.obs_chi2.dtype))


# ===========================================================================
# Production path: fused preparation + one-hot assembly + PCG
# ===========================================================================

# row of ba_prep's `diag` that holds Ht[a, b], flattened over (a, b)
_TRIU_ROW = tuple(ba_prep.TRIU6.index((min(a, b), max(a, b)))
                  for a in range(6) for b in range(6))

# the per-point fields of a BAProblem (the rest are the poses')
POINT_FIELDS = ("pw", "point_valid", "obs_kf", "obs_uvr", "obs_inv_sigma2",
                "obs_stereo", "obs_mask")


def _resolve_band(band, K: int, P: int, auto_oc_div: int = 64):
    """The JAX package's `band` forms as (R, OC, snap), or None for the
    full-width assembly: "auto" is (128, max(256, P // auto_oc_div), 64)
    when K >= 192 and P >= 8192, else None (a shard passes its own P and
    auto_oc_div 16); an int R is (R, max(256, P // 16), 1); (R, OC) is
    (R, OC, 1). R is the window of poses, OC the overflow pass's static
    capacity, snap the multiple the window bases are snapped to."""
    if band is None:
        return None
    if isinstance(band, str):
        if band != "auto":
            raise ValueError(f"band: unknown form {band!r}")
        return ((128, max(256, P // auto_oc_div), 64)
                if K >= 192 and P >= 8192 else None)
    if isinstance(band, int):
        band = (band, max(256, P // 16), 1)
    band = tuple(int(b) for b in band)
    if len(band) == 2:
        band += (1,)
    if len(band) != 3 or not (1 <= band[0] <= K + 1 and band[1] >= 0
                              and band[2] >= 1):
        raise ValueError(f"band {band}: needs (R, OC[, snap]) with "
                         f"1 <= R <= K + 1 = {K + 1}, OC >= 0, snap >= 1")
    return band


def _classify_band(prob: BAProblem, chunk: int, R: int, snap: int):
    """The JAX package's ``_classify_band``, on the device without a host
    read. Returns (perm [P] int64: the points stably sorted by their first
    observing pose; base_c [n_chunks] int64: each chunk's window base, its
    first pose snapped down to a multiple of `snap` and clamped to
    ((K - R) // snap) * snap; in_band [n_chunks, cp] bool, in sorted order:
    every observation of the point inside its chunk's window [base,
    base + R), or none at all; n_ov int32: the points that are not). The
    clamp can strand up to snap - 1 top poses outside every window: their
    points take the overflow pass."""
    K = prob.q.shape[0]
    P = prob.obs_kf.shape[0]
    mask = prob.obs_mask & (prob.obs_kf >= 0)
    kf = prob.obs_kf.long()
    kf_min = torch.where(mask, kf, K + 1).amin(dim=1)
    perm = torch.argsort(kf_min, stable=True)
    n_chunks, cp = _chunks(P, chunk)
    kf_min_s = kf_min[perm].clamp(0, K)
    kf_max_s = torch.where(mask, kf, -1).amax(dim=1)[perm]
    has_act = mask.any(dim=1)[perm]
    cmin = kf_min_s.reshape(n_chunks, cp).amin(dim=1)
    b_max = (max(K - R, 0) // snap) * snap
    base_c = ((cmin // snap) * snap).clamp(max=b_max)
    base_p = base_c.repeat_interleave(cp)
    in_band = ((kf_min_s >= base_p) & (kf_max_s < base_p + R)) | ~has_act
    return (perm, base_c, in_band.reshape(n_chunks, cp),
            (~in_band).sum(dtype=torch.int32))


def _overflow_capacity(n_ov: int, OC: int, P: int):
    """Capacity of the overflow pass for n_ov out-of-band points, so that it
    holds all of them, as the JAX package's untraced wrapper re-solves: the
    smallest power of two >= 256 that holds them, at most the static OC
    while OC holds them (0 when there are none); past OC that power of two,
    or None (full width) once it reaches max(P // 4, 256)."""
    if n_ov == 0:
        return 0
    cap = 256
    while cap < n_ov:
        cap *= 2
    if n_ov <= OC:
        return min(cap, OC)
    return None if cap >= max(P // 4, 256) else cap


class _Band(NamedTuple):
    """The banded assembly of one solve, points in sorted order."""
    R: int                   # window of poses
    snap: int                # window bases are b * snap, b < NB
    onehot: torch.Tensor     # [n_chunks, cp, M, R] float32: in-band slots
    base_oh: torch.Tensor    # [NB, n_chunks] float32: chunk c's base b
    ov_idx: torch.Tensor     # [OC] int64: out-of-band points, then P
    ov_onehot: torch.Tensor  # [OC, M, K] float32: their slots' poses


def _one_hot(idx, ok, width: int):
    """[*idx.shape, width] float32 one-hot of idx where ok, zero rows
    elsewhere; written in place (one index a row: no accumulation)."""
    out = torch.zeros(idx.shape + (width,), dtype=torch.float32,
                      device=idx.device)
    return out.scatter_(-1, idx[..., None], ok[..., None].to(torch.float32))


def _band_plan(ws: ba_prep.PrepWorkspace, base_c, in_band, R: int,
               snap: int, OC: int, K: int) -> _Band:
    """The one-hots of the banded assembly, built once per solve from K2's
    workspace of the sorted problem: the JAX package's ``_band_onehot`` in
    the point-major layout (an active slot of an in-band point at column
    pose - base) and the overflow pass's, full width over the first OC
    out-of-band points (ascending)."""
    P, M = ws.kf.shape
    n_chunks, cp = in_band.shape
    dev = ws.kf.device
    kf = ws.kf.long()
    active = ws.active > 0
    rel = (kf.view(n_chunks, cp, M) - base_c[:, None, None]).clamp(0, R - 1)
    onehot = _one_hot(rel, active.view(n_chunks, cp, M)
                      & in_band[..., None], R)
    NB = max(K - R, 0) // snap + 1
    base_oh = (base_c // snap == torch.arange(NB, device=dev)[:, None]
               ).to(torch.float32)
    ov_idx = first_true_indices(~in_band.reshape(P), OC, P)
    ovc = ov_idx.clamp(max=P - 1)
    ov_onehot = _one_hot(kf[ovc], active[ovc] & (ov_idx < P)[:, None], K)
    return _Band(R, snap, onehot, base_oh, ov_idx, ov_onehot)


class _SolveConsts(NamedTuple):
    """What stays fixed inside one solve, the points in solve order (sorted
    by first observing pose on the banded path)."""
    ws: ba_prep.PrepWorkspace
    onehot: Optional[torch.Tensor]   # [n_chunks, cp, M, K + 1] (full width)
    band: Optional[_Band]            # the banded assembly, else None
    free: torch.Tensor       # [K] bool
    has_obs: torch.Tensor    # [P] bool (valid point with an observation)
    idx: torch.Tensor        # arange(K)
    triu: torch.Tensor       # [6, 6] int64: row of diag holding Ht[a, b]
    pw: torch.Tensor         # [P, 3] starting points, solve order
    inv: Optional[torch.Tensor]   # [P] solve position of each caller point
    band_ov: torch.Tensor    # int32: out-of-band points (0 at full width)


def _prepare_solve(prob: BAProblem, chunk: int, band=None,
                   check_overflow: bool = True) -> _SolveConsts:
    """The constants of one solve. `band`: (R, OC, snap) from
    ``_resolve_band``, or None for full width. Banded, the points are
    classified and sorted, and K2's workspace is prepared on the sorted
    problem. With check_overflow the out-of-band count is read (the solve's
    one host read) and sizes the overflow pass (``_overflow_capacity``;
    full width on the caller's order where banding no longer pays); without
    it the static OC holds the first OC out-of-band points and the rest
    drop out of the assembly, not out of the cost (the JAX package's traced
    callers)."""
    K = prob.q.shape[0]
    P, M = prob.obs_kf.shape
    dev = prob.q.device
    band_ov = _int_scalar(0, dev)
    perm = None
    if band is not None:
        R, OC, snap = band
        perm, base_c, in_band, band_ov = _classify_band(prob, chunk, R, snap)
        if check_overflow:
            OC = _overflow_capacity(int(host_fetch(band_ov)), OC, P)
        if OC is None:
            perm = None
        else:
            prob = prob._replace(**{f: getattr(prob, f)[perm]
                                    for f in POINT_FIELDS})
    ws = ba_prep.prepare(prob.obs_kf, prob.obs_uvr, prob.obs_inv_sigma2,
                         prob.obs_stereo, prob.obs_mask, prob.point_valid, K)
    onehot = plan = inv = None
    if perm is None:
        onehot = _full_onehot(ws, chunk, K)
    else:
        plan = _band_plan(ws, base_c, in_band, R, snap, OC, K)
        inv = torch.empty_like(perm).scatter_(
            0, perm, torch.arange(P, device=dev))
    has_obs = torch.any(prob.obs_mask & (prob.obs_kf >= 0), dim=-1) \
        & prob.point_valid
    return _SolveConsts(ws=ws, onehot=onehot, band=plan,
                        free=prob.pose_valid & ~prob.pose_fixed,
                        has_obs=has_obs, idx=torch.arange(K, device=dev),
                        triu=const_tensor(_TRIU_ROW, torch.int64,
                                          dev).reshape(6, 6),
                        pw=prob.pw, inv=inv, band_ov=band_ov)


def _full_onehot(ws: ba_prep.PrepWorkspace, chunk: int, K: int):
    """The full-width one-hot [n_chunks, cp, M, K + 1] of K2's workspace:
    inactive slots go to the (dropped) column K."""
    P, M = ws.kf.shape
    kf_masked = torch.where(ws.active > 0, ws.kf.long(),
                            torch.full_like(ws.kf, K, dtype=torch.int64))
    n_chunks, cp = _chunks(P, chunk)
    return (kf_masked[..., None] == torch.arange(K + 1, device=ws.kf.device)
            ).to(torch.float32).reshape(n_chunks, cp, M, K + 1)


def _caller_order(x, sc: _SolveConsts):
    """A per-point array of the solve ([P, ...]) in the caller's order."""
    return x if sc.inv is None else x[sc.inv]


def _cross_sums(Y, Wb, diag, Of, out=(None, None)):
    """Raw sums of one group of n points onto W poses: S [6W, 6W], rows and
    columns (twist component, pose), and d [33, W] of Ht / bt / Ybp, from
    K2's Y, Wb [18, n, M] and diag [33, n, M] and the slots' one-hot
    Of [n, M, W], written into `out` (S, d) where given. Every product has
    a fixed summation order."""
    n, M, W = Of.shape
    d = torch.mm(diag.reshape(33, n * M), Of.reshape(n * M, W), out=out[1])
    # per-point factorized cross term: U[p, (c, a), k] = sum_m Y O
    U = torch.bmm(Y.transpose(0, 1), Of)                       # [n, 18, W]
    V = torch.bmm(Wb.transpose(0, 1), Of)
    # rows (point, coordinate), columns (twist component, pose)
    return torch.mm(U.reshape(n * 3, 6 * W).t(), V.reshape(n * 3, 6 * W),
                    out=out[0]), d


def _assemble(terms: ba_prep.PrepTerms, sc: _SolveConsts):
    """Reduce the per-observation terms onto keyframes: the raw sums S_acc
    [6 (K + 1), 6 (K + 1)] of the cross blocks, (twist component, pose)
    major, and dsum [33, K + 1] of Ht / bt / Ybp, whose pose K (dropped by
    ``_pose_sums``) collects nothing but zeros. Chunked over points; the
    terms are point-major, so every operand is a view of them.

    Full width: one (K + 1)-wide one-hot product a chunk. Banded: an R-wide
    [6R, 6R] patch a chunk, the patches summed per window base by a product
    with the chunks' base one-hot, each base's sum added at its static
    window of S_acc; then the overflow pass, full width over the points that
    leave their window. No dynamic index and no float atomics: the sums have
    a fixed order."""
    K = sc.idx.shape[0]
    KK = K + 1
    dev = terms.Wb.device
    S_acc = torch.zeros((6 * KK, 6 * KK), dtype=torch.float32, device=dev)
    dsum = torch.zeros((33, KK), dtype=torch.float32, device=dev)
    b = sc.band
    onehot = sc.onehot if b is None else b.onehot
    n_chunks, cp = onehot.shape[:2]
    if b is not None:
        R = b.R
        S_c = torch.empty((n_chunks, 36 * R * R), dtype=torch.float32,
                          device=dev)
        d_c = torch.empty((n_chunks, 33 * R), dtype=torch.float32, device=dev)
    for ci in range(n_chunks):
        sl = slice(ci * cp, (ci + 1) * cp)
        out = ((None, None) if b is None else
               (S_c[ci].view(6 * R, 6 * R), d_c[ci].view(33, R)))
        S, d = _cross_sums(terms.Y[:, sl], terms.Wb[:, sl],
                           terms.diag[:, sl], onehot[ci], out)
        if b is None:
            dsum += d
            S_acc += S
    if b is None:
        return S_acc, dsum
    S_b = (b.base_oh @ S_c).view(-1, 6, R, 6, R)
    d_b = (b.base_oh @ d_c).view(-1, 33, R)
    del S_c, d_c
    S4 = S_acc.view(6, KK, 6, KK)
    for i in range(S_b.shape[0]):
        w = slice(i * b.snap, i * b.snap + R)
        S4[:, w, :, w] += S_b[i]
        dsum[:, w] += d_b[i]
    if b.ov_idx.numel():
        ovc = b.ov_idx.clamp(max=terms.Wb.shape[1] - 1)
        S, d = _cross_sums(terms.Y[:, ovc], terms.Wb[:, ovc],
                           terms.diag[:, ovc], b.ov_onehot)
        S4[:, :K, :, :K] += S.view(6, K, 6, K)
        dsum[:, :K] += d
    return S_acc, dsum


def _pose_sums(S_acc, dsum, K: int):
    """The cross blocks S_blocks [K, K, 6, 6] and the [33, K] sums of the K
    poses from ``_assemble``'s raw sums."""
    KK = K + 1
    return (S_acc.reshape(6, KK, 6, KK).permute(1, 3, 0, 2)[:K, :K],
            dsum[:, :K])


def _reduce_sums(reduce, S_acc, dsum, cost):
    """S_acc, dsum and the cost of one shard of points summed over every
    shard: packed into one flat float32 buffer, so that `reduce` (an
    all-reduce that returns the summed buffer) makes one collective, then
    unpacked as views of the result."""
    n_s, n_d = S_acc.numel(), dsum.numel()
    buf = reduce(torch.cat([S_acc.reshape(-1), dsum.reshape(-1),
                            cost.reshape(1)]))
    return (buf[:n_s].view(S_acc.shape), buf[n_s:n_s + n_d].view(dsum.shape),
            buf[n_s + n_d])


def _camera_system(S_acc, dsum, sc: _SolveConsts, lam):
    """The damped reduced camera system from ``_assemble``'s raw sums (one
    shard's, or all shards' summed): (S [6K, 6K], rows and columns (pose,
    twist component); rhs [K, 6]; Dinv [K, 6, 6], the inverses of its
    diagonal blocks)."""
    K = sc.idx.shape[0]
    S_blocks, dsum = _pose_sums(S_acc, dsum, K)
    Hcc = dsum[:21].t()[:, sc.triu]                           # [K, 6, 6]
    bc = dsum[21:27].t()
    rhs_pose = dsum[27:33].t()
    S = _reduced_system(S_blocks, Hcc, lam, sc.free, sc.idx)
    rhs = torch.where(sc.free[:, None], bc - rhs_pose, torch.zeros_like(bc))
    eye6 = torch.eye(6, dtype=torch.float32, device=S.device)
    Dinv = torch.linalg.inv_ex(S[sc.idx, sc.idx] + 1e-8 * eye6).inverse
    return S.permute(0, 2, 1, 3).reshape(6 * K, 6 * K), rhs, Dinv


def _build_and_solve_fast(sc: _SolveConsts, q, t, pw, cam, lam, delta2_m,
                          delta2_s, use_huber, pcg_iters, x0, reduce=None):
    """One LM build and solve. Returns (dc [K, 6], dp [P, 3], robust cost at
    the build point). x0 [K, 6] warm-starts PCG (None: from zero). With
    `reduce`, the problem is one shard of the points (poses replicated):
    the shard's sums and cost are all-reduced before the reduced camera
    system is formed, and the cost returned is the total."""
    K = q.shape[0]
    ws = sc.ws
    P, M = ws.kf.shape
    terms = ba_prep.prep_terms(ws, q, t, pw, lam, cam, delta2_m, delta2_s,
                               use_huber)
    cost0 = torch.sum(terms.cost)

    S_acc, dsum = _assemble(terms, sc)
    if reduce is not None:
        S_acc, dsum, cost0 = _reduce_sums(reduce, S_acc, dsum, cost0)
    S_dense, rhs, Dinv = _camera_system(S_acc, dsum, sc, lam)
    dc = pcg.pcg_solve(S_dense, rhs.reshape(-1), Dinv, n_iters=pcg_iters,
                       x0=None if x0 is None else x0.reshape(-1)
                       ).reshape(K, 6)
    dc = torch.where(sc.free[:, None], dc, torch.zeros_like(dc))

    # back-substitution
    dcE = dc.t()[:, ws.kf.long()] * ws.active                 # [6, P, M]
    corr = torch.sum(terms.Wb.view(3, 6, P, M) * dcE, dim=(1, 3))
    rp = terms.bp - corr                                      # [3, P]
    h = terms.hinv6
    dp = torch.stack([h[0] * rp[0] + h[1] * rp[1] + h[2] * rp[2],
                      h[1] * rp[0] + h[3] * rp[1] + h[4] * rp[2],
                      h[2] * rp[0] + h[4] * rp[1] + h[5] * rp[2]], dim=-1)
    dp = torch.where(sc.has_obs[:, None], dp, torch.zeros_like(dp))
    return dc, dp, cost0


@torch.no_grad()
def ba_solve_fast(prob: BAProblem, cam: Intrinsics, n_iters: int = 10,
                  use_huber: bool = True, chi2_mono: float = 5.991,
                  chi2_stereo: float = 7.815, chunk: int = 4096,
                  pcg_iters: int = 32, band="auto", cross_bf16=None,
                  use_pallas=None, check_overflow: bool = True) -> BAResult:
    """ba_solve's semantics with the fused preparation, the one-hot assembly
    and PCG; deferred-accept LM with lambda in [1e-8, 1e4] and a warm-started
    PCG. The signature is the JAX package's; `chunk` bounds how many points
    one assembly product takes.

    band: None for the full-width assembly, "auto" (banded where K >= 192
    and P >= 8192), an int R, (R, OC) or (R, OC, snap) (``_resolve_band``).
    Banded, the result is exact whatever the overflow: with check_overflow
    the out-of-band count is read once and the overflow pass holds every
    such point (full width where banding no longer pays), which is the JAX
    package's re-solve, solved once. check_overflow=False reads nothing and
    keeps the static capacity OC: points past it drop out of the assembly
    (not out of the cost), as in the JAX package's traced callers, and the
    caller checks `band_ov` (the out-of-band count; 0 at full width)
    against OC. `pw` and `obs_chi2` come back in the caller's order.
    `cross_bf16` and `use_pallas` select layouts of the TPU program and are
    ignored: every product is float32.
    """
    K = prob.q.shape[0]
    P = prob.obs_kf.shape[0]
    sc = _prepare_solve(prob, chunk, _resolve_band(band, K, P),
                        check_overflow)
    q, t, pw = _lm_solve(sc, prob.q, prob.t, cam, n_iters, use_huber,
                         chi2_mono, chi2_stereo, pcg_iters, warm_start=True)
    out = ba_prep.prep_terms(sc.ws, q, t, pw, None, cam, chi2_mono,
                             chi2_stereo, use_huber, cost_only=True)
    return BAResult(q=q, t=t, pw=_caller_order(pw, sc),
                    cost=torch.sum(out.cost),
                    obs_chi2=_caller_order(out.chi2, sc),
                    n_iters=_int_scalar(n_iters, prob.q.device),
                    band_ov=sc.band_ov)


def _lm_solve(sc: _SolveConsts, q, t, cam: Intrinsics, n_iters: int,
              use_huber: bool, chi2_mono: float, chi2_stereo: float,
              pcg_iters: int, warm_start: bool, reduce=None):
    """The LM loop of ``ba_solve_fast`` from poses (q, t) and the points
    sc.pw; returns (q, t, pw), pw in solve order. warm_start: each PCG solve
    starts from the previous step (else from zero). With `reduce` (an
    all-reduce that returns the summed tensor), the solve is one shard of
    the points: every build's sums and cost and the final cost are summed
    over the shards, so the replicated poses take the same steps on every
    shard."""
    dev = q.device

    def cost_fn(q, t, pw):
        out = ba_prep.prep_terms(sc.ws, q, t, pw, None, cam, chi2_mono,
                                 chi2_stereo, use_huber, cost_only=True)
        cost = torch.sum(out.cost)
        return cost if reduce is None else reduce(cost.reshape(1))[0]

    # Deferred-accept LM: one observation pass per iteration. The build at
    # the current parameters yields the robust cost there, which doubles as
    # the accept test for the PREVIOUS step: if that step increased the cost,
    # revert to the backup and raise lambda (the build at the bad point is
    # discarded).
    pw = sc.pw
    qb, tb, pwb = q, t, pw
    cost_prev = torch.full((), torch.inf, dtype=torch.float32, device=dev)
    lam = torch.full((1,), 1e-4, dtype=torch.float32, device=dev)
    dc_prev = torch.zeros((q.shape[0], 6), dtype=torch.float32, device=dev)
    for _ in range(n_iters):
        dc, dp, cost_here = _build_and_solve_fast(
            sc, q, t, pw, cam, lam, chi2_mono, chi2_stereo, use_huber,
            pcg_iters, dc_prev if warm_start else None, reduce)
        improved = cost_here <= cost_prev
        lam = torch.where(improved, lam * 0.5, lam * 5.0).clamp(1e-8, 1e4)
        q_step, t_step, pw_step = _apply_step(q, t, pw, dc, dp)
        # improved: keep current as backup, apply the fresh step
        # regressed: discard the step, revert to backup
        q_next = torch.where(improved, q_step, qb)
        t_next = torch.where(improved, t_step, tb)
        pw_next = torch.where(improved, pw_step, pwb)
        qb = torch.where(improved, q, qb)
        tb = torch.where(improved, t, tb)
        pwb = torch.where(improved, pw, pwb)
        cost_prev = torch.minimum(cost_here, cost_prev)
        q, t, pw, dc_prev = q_next, t_next, pw_next, dc

    # final accept check for the last applied step
    take_last = cost_fn(q, t, pw) <= cost_prev
    return (torch.where(take_last, q, qb), torch.where(take_last, t, tb),
            torch.where(take_last, pw, pwb))
