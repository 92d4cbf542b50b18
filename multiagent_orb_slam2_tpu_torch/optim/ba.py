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
  (``ba_prep.prep_terms``, a CUDA kernel on the card), the full-width one-hot
  assembly of S as matrix products, and block-Jacobi preconditioned CG
  (``pcg.pcg_solve``, a CUDA kernel on the card), with deferred-accept LM: the
  build at the current parameters yields the robust cost there, which is the
  accept test of the previous step.

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
from ..utils.torch_ops import const_tensor
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
    band_ov: Optional[torch.Tensor] = None   # always 0: assembly is full width


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


class _SolveConsts(NamedTuple):
    """What stays fixed inside one solve."""
    ws: ba_prep.PrepWorkspace
    onehot: torch.Tensor     # [n_chunks, cp, M, K + 1] float32
    free: torch.Tensor       # [K] bool
    has_obs: torch.Tensor    # [P] bool (valid point with an observation)
    idx: torch.Tensor        # arange(K)
    triu: torch.Tensor       # [6, 6] int64: row of diag holding Ht[a, b]


def _prepare_solve(prob: BAProblem, chunk: int) -> _SolveConsts:
    K = prob.q.shape[0]
    P, M = prob.obs_kf.shape
    dev = prob.q.device
    ws = ba_prep.prepare(prob.obs_kf, prob.obs_uvr, prob.obs_inv_sigma2,
                         prob.obs_stereo, prob.obs_mask, prob.point_valid, K)
    # inactive slots go to the (dropped) row K of the one-hot
    kf_masked = torch.where(ws.active > 0, ws.kf.long(),
                            torch.full_like(ws.kf, K, dtype=torch.int64))
    n_chunks, cp = _chunks(P, chunk)
    onehot = (kf_masked[..., None] == torch.arange(K + 1, device=dev)
              ).to(torch.float32).reshape(n_chunks, cp, M, K + 1)
    has_obs = torch.any(prob.obs_mask & (prob.obs_kf >= 0), dim=-1) \
        & prob.point_valid
    return _SolveConsts(ws=ws, onehot=onehot,
                        free=prob.pose_valid & ~prob.pose_fixed,
                        has_obs=has_obs, idx=torch.arange(K, device=dev),
                        triu=const_tensor(_TRIU_ROW, torch.int64,
                                          dev).reshape(6, 6))


def _assemble(terms: ba_prep.PrepTerms, sc: _SolveConsts):
    """Reduce the per-observation terms onto keyframes: the raw sums S_acc
    [6 (K + 1), 6 (K + 1)] of the cross blocks and dsum [33, K + 1] of
    Ht / bt / Ybp, whose pose K collects the inactive slots (``_pose_sums``
    drops it). Full-width one-hot products, chunked over points; every
    product has a fixed summation order. The terms are point-major, so every
    operand is a view of them."""
    n_chunks, cp, M, KK = sc.onehot.shape
    dev = terms.Wb.device
    S_acc = torch.zeros((6 * KK, 6 * KK), dtype=torch.float32, device=dev)
    dsum = torch.zeros((33, KK), dtype=torch.float32, device=dev)
    for ci in range(n_chunks):
        sl = slice(ci * cp, (ci + 1) * cp)
        Of = sc.onehot[ci]                                    # [cp, M, KK]
        d = terms.diag[:, sl].reshape(33, cp * M)
        dsum += d @ Of.reshape(cp * M, KK)
        # per-point factorized cross term: U[p, (c, a), k] = sum_m Y O
        U = torch.bmm(terms.Y[:, sl].transpose(0, 1), Of)      # [cp, 18, KK]
        V = torch.bmm(terms.Wb[:, sl].transpose(0, 1), Of)
        # rows (point, coordinate), columns (twist component, pose)
        S_acc += U.reshape(cp * 3, 6 * KK).t() @ V.reshape(cp * 3, 6 * KK)
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
    S_blocks, dsum = _pose_sums(S_acc, dsum, K)
    Hcc = dsum[:21].t()[:, sc.triu]                           # [K, 6, 6]
    bc = dsum[21:27].t()
    rhs_pose = dsum[27:33].t()
    S = _reduced_system(S_blocks, Hcc, lam, sc.free, sc.idx)
    rhs = torch.where(sc.free[:, None], bc - rhs_pose, torch.zeros_like(bc))

    S_dense = S.permute(0, 2, 1, 3).reshape(6 * K, 6 * K)
    eye6 = torch.eye(6, dtype=torch.float32, device=q.device)
    Dinv = torch.linalg.inv_ex(S[sc.idx, sc.idx] + 1e-8 * eye6).inverse
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
    PCG.

    The signature is the JAX package's. `band`, `cross_bf16`, `use_pallas`
    and `check_overflow` select layouts of the TPU program and are ignored:
    the assembly is always full width and exact, and `band_ov` is 0. `chunk`
    bounds how many points one assembly product takes.
    """
    sc = _prepare_solve(prob, chunk)
    q, t, pw = _lm_solve(sc, prob, cam, n_iters, use_huber, chi2_mono,
                         chi2_stereo, pcg_iters, warm_start=True)
    out = ba_prep.prep_terms(sc.ws, q, t, pw, None, cam, chi2_mono,
                             chi2_stereo, use_huber, cost_only=True)
    dev = prob.q.device
    return BAResult(q=q, t=t, pw=pw, cost=torch.sum(out.cost),
                    obs_chi2=out.chi2,
                    n_iters=_int_scalar(n_iters, dev),
                    band_ov=_int_scalar(0, dev))


def _lm_solve(sc: _SolveConsts, prob: BAProblem, cam: Intrinsics,
              n_iters: int, use_huber: bool, chi2_mono: float,
              chi2_stereo: float, pcg_iters: int, warm_start: bool,
              reduce=None):
    """The LM loop of ``ba_solve_fast``; returns (q, t, pw). warm_start:
    each PCG solve starts from the previous step (else from zero). With
    `reduce` (an all-reduce that returns the summed tensor), `prob` is one
    shard of the points: every build's sums and cost and the final cost are
    summed over the shards, so the replicated poses take the same steps on
    every shard."""
    dev = prob.q.device

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
    q, t, pw = prob.q, prob.t, prob.pw
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
