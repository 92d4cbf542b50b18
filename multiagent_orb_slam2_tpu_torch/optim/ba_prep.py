"""Schur-complement preparation of one LM build: the per-observation and
per-point half of bundle adjustment.

Counterpart of the JAX package's ``optim/ba_pallas.py``. Two implementations
of one function live here:

- the CUDA kernel ``csrc/ba_prep.cu`` (replaces the Pallas TPU kernel
  ``optim/ba_pallas.py::_prep_kernel``): one warp per point that has an
  active slot, lane m = slot m, each slot evaluated once, the point block
  summed over the lanes in a fixed order, whole rows of M slots written; a
  persistent launch over the list of such points that ``prepare`` builds once
  per solve (``compact_points``, a one-block kernel of the same source); see
  the source's header. The first design (one thread per point over all P,
  slot-major arrays) stays loadable as ``ba_prep_launch_v1`` for timing old
  against new in one process;
- ``_prep_terms_plain``: the same terms from ``ba_kernels.obs_terms_e`` and
  ``ba_kernels.sym3_inv`` plus the componentwise stacks, in tensor ops.

``prep_terms`` dispatches on the pose table's device only: CUDA tensors go to
the kernel (or raise), CPU tensors to the plain version.

Layout: point-major, the problem's own. Every per-observation array is
``[*, P, M]`` (slot m of point p), so ``prepare`` only casts.

Output contract (what ``optim/ba.py`` assembles from):
  Wb, Y [18, P, M]   rows c * 6 + a (point coordinate c, twist component a)
  diag  [33, P, M]   rows 0..20 the upper triangle of Ht = Jc^T w Jc in
                     row-major (a, b >= a) order, 21..26 bt, 27..32 Ybp
  hinv6 [6, P]       (00, 01, 02, 11, 12, 22) of the damped Hpp^-1
  bp    [3, P]
  cost, chi2 [P, M]  robust cost term and raw chi2 of every active slot
Slots that take no part in the solve hold zeros everywhere, and so do hinv6
and bp at points without such a slot.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from ..geometry.camera import Intrinsics
from ..utils.torch_ops import first_true_indices
from . import ba_kernels as bk

# (a, b) of diag rows 0..20
TRIU6 = tuple((a, b) for a in range(6) for b in range(a, 6))


class PrepWorkspace(NamedTuple):
    """Iteration-invariant inputs of a solve, and on the card the output
    buffers every build of that solve writes into."""
    kf: torch.Tensor       # [P, M] int32 observing pose, clipped to [0, K)
    uvr: torch.Tensor      # [P, M, 3] float32
    isig: torch.Tensor     # [P, M] float32
    flags: torch.Tensor    # [P, M] uint8: bit 0 active in the solve, 1 stereo
    active: torch.Tensor   # [P, M] float32, bit 0 of flags
    points: torch.Tensor   # [P] int32: points with an active slot, ascending
    n_points: torch.Tensor  # [1] int32: how many of `points` are listed
    buffers: Optional[tuple]   # (Wb, Y, diag, hinv6, bp, cost, chi2) on CUDA


class PrepTerms(NamedTuple):
    Wb: Optional[torch.Tensor]
    Y: Optional[torch.Tensor]
    diag: Optional[torch.Tensor]
    hinv6: Optional[torch.Tensor]
    bp: Optional[torch.Tensor]
    cost: torch.Tensor
    chi2: torch.Tensor


def compact_points(active: torch.Tensor):
    """(points [P] int32, n_points [1] int32) of an active mask [P, M]: the
    points with at least one active slot in ascending order, then zeros, and
    their count, both left in device memory (no host wait). On the card a
    one-block kernel of csrc/ba_prep.cu lists them (counted in
    compact_points.launches, not in prep_terms'); on the CPU tensor ops."""
    has = active.any(dim=1)
    if has.is_cuda:
        return _compact_points_cuda(has)
    return _compact_points_plain(has)


compact_points.launches = 0   # compaction kernel launches so far


def _compact_points_plain(has):
    P = has.shape[0]
    return (first_true_indices(has, P, 0).to(torch.int32),
            has.sum(dtype=torch.int32).reshape(1))


def prepare(obs_kf, obs_uvr, obs_inv_sigma2, obs_stereo, obs_mask,
            point_valid, n_poses: int) -> PrepWorkspace:
    """Kernel inputs from the problem arrays ([P, M, ...]). A slot is active
    when it is masked in, names a pose and its point is valid; the pose index
    is clipped before any gather."""
    active = obs_mask & (obs_kf >= 0) & point_valid[:, None]        # [P, M]
    kf = obs_kf.clamp(0, n_poses - 1).to(torch.int32).contiguous()
    uvr = obs_uvr.to(torch.float32).contiguous()
    isig = obs_inv_sigma2.to(torch.float32).contiguous()
    flags = active.to(torch.uint8) + 2 * obs_stereo.to(torch.uint8)
    points, n_points = compact_points(active)
    P, M = kf.shape
    buffers = None
    if kf.is_cuda:
        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=kf.device)
        buffers = (zeros(18, P, M), zeros(18, P, M), zeros(33, P, M),
                   zeros(6, P), zeros(3, P), zeros(P, M), zeros(P, M))
    return PrepWorkspace(kf=kf, uvr=uvr, isig=isig, flags=flags.contiguous(),
                         active=active.to(torch.float32), points=points,
                         n_points=n_points, buffers=buffers)


def prep_terms(ws: PrepWorkspace, q, t, pw, lam, cam: Intrinsics,
               delta2_m: float, delta2_s: float, use_huber: bool,
               cost_only: bool = False) -> PrepTerms:
    """All per-observation and per-point terms of one LM build at poses
    (q [K, 4], t [K, 3]) and points pw [P, 3] with damping lam (a 0-d or
    1-element float32 tensor on the same device; ignored when cost_only).
    With cost_only, only `cost` and `chi2` are computed."""
    if q.is_cuda:
        return _prep_terms_cuda(ws, q, t, pw, lam, cam, delta2_m, delta2_s,
                                use_huber, cost_only)
    return _prep_terms_plain(ws, q, t, pw, lam, cam, delta2_m, delta2_s,
                             use_huber, cost_only)


prep_terms.launches = 0   # kernel launches so far (plain int)


# ---------------------------------------------------------------------------
# CUDA kernel wrapper
# ---------------------------------------------------------------------------

_lib = None


def load_kernel():
    """Build (first use) and load csrc/ba_prep.cu; returns the ctypes library
    with argument types set."""
    global _lib
    if _lib is None:
        from ..utils.cuda_build import load_library
        lib = load_library("ba_prep")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        launch_args = [p] * 16 + [i, i] + [f] * 7 + [i, i]
        lib.ba_prep_launch.argtypes = launch_args + [p]
        lib.ba_prep_launch_v1.argtypes = launch_args + [p]
        lib.ba_prep_compact.argtypes = [p, i, p, p, p]
        for fn in (lib.ba_prep_launch, lib.ba_prep_launch_v1,
                   lib.ba_prep_compact, lib.ba_prep_max_slots,
                   lib.ba_prep_grid_blocks):
            fn.restype = i
        _lib = lib
    return _lib


def _compact_points_cuda(has):
    lib = load_kernel()
    P = has.shape[0]
    if has.dtype != torch.bool or not has.is_contiguous():
        raise ValueError("compact_points: has must be a contiguous bool "
                         "tensor")
    points = torch.empty(P, dtype=torch.int32, device=has.device)
    n_points = torch.empty(1, dtype=torch.int32, device=has.device)
    with torch.cuda.device(has.device):
        err = lib.ba_prep_compact(has.data_ptr(), P, points.data_ptr(),
                                  n_points.data_ptr(),
                                  torch.cuda.current_stream().cuda_stream)
    compact_points.launches += 1
    if err != 0:
        raise RuntimeError(f"ba_prep compaction kernel launch failed: CUDA "
                           f"error {err}")
    return points, n_points


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"prep_terms: {name} is on {t.device}, "
                         f"expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"prep_terms: {name} is {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"prep_terms: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"prep_terms: {name} is not contiguous")
    return t


def _bind_launch(ws, q, t, pw, lam, cam, delta2_m, delta2_s, use_huber,
                 cost_only=False):
    """Check the inputs and return (run, terms). run() launches the kernel
    into the workspace's buffers on the current stream and does nothing else,
    so a timing script can call it back to back."""
    lib = load_kernel()
    dev = q.device
    f32 = torch.float32
    P, M = ws.kf.shape
    K = q.shape[0]
    if M > lib.ba_prep_max_slots():
        raise ValueError(f"prep_terms: M = {M} observation slots per point "
                         f"exceed the kernel's limit of "
                         f"{lib.ba_prep_max_slots()} (one lane of a warp "
                         "each)")
    if ws.buffers is None:
        raise ValueError("prep_terms: the workspace was prepared on the CPU")
    _check("q", q, f32, (K, 4), dev)
    _check("t", t, f32, (K, 3), dev)
    pw = _check("pw", pw.contiguous(), f32, (P, 3), dev)
    _check("ws.kf", ws.kf, torch.int32, (P, M), dev)
    _check("ws.uvr", ws.uvr, f32, (P, M, 3), dev)
    _check("ws.isig", ws.isig, f32, (P, M), dev)
    _check("ws.flags", ws.flags, torch.uint8, (P, M), dev)
    _check("ws.points", ws.points, torch.int32, (P,), dev)
    _check("ws.n_points", ws.n_points, torch.int32, (1,), dev)
    Wb, Y, diag, hinv6, bp, cost, chi2 = ws.buffers
    if cost_only:
        lam_ptr = 0
    else:
        lam = _check("lam", lam.reshape(1), f32, (1,), dev)
        lam_ptr = lam.data_ptr()
    qt = torch.cat([q, t], dim=1)

    def run():
        with torch.cuda.device(dev):
            err = lib.ba_prep_launch(
                qt.data_ptr(), pw.data_ptr(), ws.kf.data_ptr(),
                ws.uvr.data_ptr(), ws.isig.data_ptr(), ws.flags.data_ptr(),
                ws.points.data_ptr(),
                ws.n_points.data_ptr(), lam_ptr, Wb.data_ptr(), Y.data_ptr(),
                diag.data_ptr(), hinv6.data_ptr(), bp.data_ptr(),
                cost.data_ptr(), chi2.data_ptr(), P, M, cam.fx, cam.fy,
                cam.cx, cam.cy, cam.bf, delta2_m, delta2_s, int(use_huber),
                int(cost_only), torch.cuda.current_stream().cuda_stream)
        prep_terms.launches += 1
        if err != 0:
            raise RuntimeError(
                f"ba_prep kernel launch failed: CUDA error {err}")

    if cost_only:
        return run, PrepTerms(None, None, None, None, None, cost, chi2)
    return run, PrepTerms(Wb, Y, diag, hinv6, bp, cost, chi2)


def _prep_terms_cuda(ws, q, t, pw, lam, cam, delta2_m, delta2_s, use_huber,
                     cost_only):
    run, terms = _bind_launch(ws, q, t, pw, lam, cam, delta2_m, delta2_s,
                              use_huber, cost_only)
    run()
    return terms


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

def _prep_terms_plain(ws, q, t, pw, lam, cam, delta2_m, delta2_s, use_huber,
                      cost_only=False):
    """The kernel's terms from obs_terms_e + sym3_inv + the componentwise
    stacks, computed over E = P * M (observation e = p * M + m)."""
    P, M = ws.kf.shape
    E = P * M

    def pm(a):      # [..., E] -> [..., P, M]
        return a.reshape(a.shape[:-1] + (P, M))

    kf_e, isig_e = ws.kf.reshape(E), ws.isig.reshape(E)
    uvr_e = ws.uvr.reshape(E, 3).t()
    stereo_e = ws.flags.reshape(E) >= 2
    active_e = ws.active.reshape(E)
    Z = bk._camera_points(kf_e, q, t, pw, M)[3]
    in_front = active_e * (Z > 0.01).to(active_e.dtype)

    def cost_terms(chi2):
        _, rho = bk._robust(chi2, stereo_e, delta2_m, delta2_s, use_huber)
        return pm(rho * in_front), pm(chi2 * active_e)

    if cost_only:
        _, chi2 = bk.cost_e(kf_e, uvr_e, isig_e, stereo_e, active_e, q, t, pw,
                            cam, delta2_m, delta2_s, use_huber)
        return PrepTerms(None, None, None, None, None, *cost_terms(chi2))

    tm = bk.obs_terms_e(kf_e, uvr_e, isig_e, stereo_e, active_e, q, t, pw,
                        cam, delta2_m, delta2_s, use_huber)
    Jc, Jp, r, w = tm.Jc, tm.Jp, tm.r, tm.w

    # point blocks (all elementwise over [P] after the M-reduction)
    JpP = Jp.reshape(3, 3, P, M)
    wP = w.reshape(P, M)
    rP = r.reshape(3, P, M)

    def hpp(a, b):
        return torch.sum((JpP[0, a] * JpP[0, b] + JpP[1, a] * JpP[1, b]
                          + JpP[2, a] * JpP[2, b]) * wP, -1)

    H6 = (hpp(0, 0), hpp(0, 1), hpp(0, 2), hpp(1, 1), hpp(1, 2), hpp(2, 2))
    Hinv6 = bk.sym3_inv(H6, lam.reshape(()))
    bp = torch.stack([
        -torch.sum((JpP[0, b] * rP[0] + JpP[1, b] * rP[1]
                    + JpP[2, b] * rP[2]) * wP, -1) for b in range(3)])

    # W = Jc^T w Jp and Y = W Hpp^-1 (componentwise over E), rows c * 6 + a
    Wb = torch.stack([
        (Jc[0, a] * Jp[0, c] + Jc[1, a] * Jp[1, c] + Jc[2, a] * Jp[2, c]) * w
        for c in range(3) for a in range(6)])             # [18, E]
    Hfull = ((Hinv6[0], Hinv6[1], Hinv6[2]),
             (Hinv6[1], Hinv6[3], Hinv6[4]),
             (Hinv6[2], Hinv6[4], Hinv6[5]))
    HinvE = [[v.repeat_interleave(M) for v in row] for row in Hfull]
    Y = torch.stack([
        Wb[a] * HinvE[0][c] + Wb[6 + a] * HinvE[1][c]
        + Wb[12 + a] * HinvE[2][c] for c in range(3) for a in range(6)])

    # pose-side terms
    Ht = torch.stack([
        (Jc[0, a] * Jc[0, b] + Jc[1, a] * Jc[1, b] + Jc[2, a] * Jc[2, b]) * w
        for a, b in TRIU6])                               # [21, E]
    bt = torch.stack([
        -(Jc[0, a] * r[0] + Jc[1, a] * r[1] + Jc[2, a] * r[2]) * w
        for a in range(6)])                               # [6, E]
    bpE = [bp[c].repeat_interleave(M) for c in range(3)]
    Ybp = torch.stack([
        Y[a] * bpE[0] + Y[6 + a] * bpE[1] + Y[12 + a] * bpE[2]
        for a in range(6)])                               # [6, E]
    # points without an active slot are not written by the kernel
    listed = ws.active.amax(dim=1) > 0                    # [P]
    hinv6 = torch.where(listed, torch.stack(Hinv6), torch.zeros_like(bp[:1]))
    bp = torch.where(listed, bp, torch.zeros_like(bp))
    return PrepTerms(Wb=pm(Wb), Y=pm(Y), diag=pm(torch.cat([Ht, bt, Ybp])),
                     hinv6=hinv6, bp=bp,
                     **dict(zip(("cost", "chi2"), cost_terms(tm.chi2))))
