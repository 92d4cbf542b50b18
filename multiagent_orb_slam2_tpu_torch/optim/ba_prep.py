"""Schur-complement preparation of one LM build: the per-observation and
per-point half of bundle adjustment.

Counterpart of the JAX package's ``optim/ba_pallas.py``. Two implementations
of one function live here:

- the CUDA kernel ``csrc/ba_prep.cu`` (replaces the Pallas TPU kernel
  ``optim/ba_pallas.py::_prep_kernel``): one thread per point, two passes over
  the point's observation slots; bound by the bytes it writes; see the
  source's header;
- ``_prep_terms_plain``: the same terms from ``ba_kernels.obs_terms_e`` and
  ``ba_kernels.sym3_inv`` plus the componentwise stacks, in tensor ops.

``prep_terms`` dispatches on the pose table's device only: CUDA tensors go to
the kernel (or raise), CPU tensors to the plain version.

Layout: slot-major. Every per-observation array is ``[*, M, P]`` (slot m of
point p), so neighbouring threads of the kernel touch neighbouring floats.
``prepare`` transposes the problem's point-major ``[P, M]`` arrays once per
solve; the keyframe structure does not change inside a solve.

Output contract (what ``optim/ba.py`` assembles from):
  Wb, Y [18, M, P]   rows c * 6 + a (point coordinate c, twist component a)
  diag  [33, M, P]   rows 0..20 the upper triangle of Ht = Jc^T w Jc in
                     row-major (a, b >= a) order, 21..26 bt, 27..32 Ybp
  hinv6 [6, P]       (00, 01, 02, 11, 12, 22) of the damped Hpp^-1
  bp    [3, P]
  cost, chi2 [M, P]  robust cost term and raw chi2 of every active slot
Slots that take no part in the solve hold zeros everywhere.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from ..geometry.camera import Intrinsics
from . import ba_kernels as bk

# (a, b) of diag rows 0..20
TRIU6 = tuple((a, b) for a in range(6) for b in range(a, 6))


class PrepWorkspace(NamedTuple):
    """Iteration-invariant inputs of a solve in slot-major layout, and on the
    card the output buffers every build of that solve writes into."""
    kf: torch.Tensor       # [M, P] int32 observing pose, clipped to [0, K)
    uvr: torch.Tensor      # [3, M, P] float32
    isig: torch.Tensor     # [M, P] float32
    flags: torch.Tensor    # [M, P] uint8: bit 0 active in the solve, 1 stereo
    active: torch.Tensor   # [M, P] float32, bit 0 of flags
    buffers: Optional[tuple]   # (Wb, Y, diag, hinv6, bp, cost, chi2) on CUDA


class PrepTerms(NamedTuple):
    Wb: Optional[torch.Tensor]
    Y: Optional[torch.Tensor]
    diag: Optional[torch.Tensor]
    hinv6: Optional[torch.Tensor]
    bp: Optional[torch.Tensor]
    cost: torch.Tensor
    chi2: torch.Tensor


def prepare(obs_kf, obs_uvr, obs_inv_sigma2, obs_stereo, obs_mask,
            point_valid, n_poses: int) -> PrepWorkspace:
    """Slot-major inputs from the point-major problem arrays ([P, M, ...]).
    A slot is active when it is masked in, names a pose and its point is
    valid; the pose index is clipped before any gather."""
    active = obs_mask & (obs_kf >= 0) & point_valid[:, None]        # [P, M]
    kf = obs_kf.clamp(0, n_poses - 1).to(torch.int32).t().contiguous()
    uvr = obs_uvr.to(torch.float32).permute(2, 1, 0).contiguous()
    isig = obs_inv_sigma2.to(torch.float32).t().contiguous()
    act_m = active.t().contiguous()
    flags = act_m.to(torch.uint8) + 2 * obs_stereo.t().to(torch.uint8)
    M, P = kf.shape
    buffers = None
    if kf.is_cuda:
        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=kf.device)
        buffers = (zeros(18, M, P), zeros(18, M, P), zeros(33, M, P),
                   zeros(6, P), zeros(3, P), zeros(M, P), zeros(M, P))
    return PrepWorkspace(kf=kf, uvr=uvr, isig=isig, flags=flags.contiguous(),
                         active=act_m.to(torch.float32), buffers=buffers)


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
        lib.ba_prep_launch.argtypes = [p] * 14 + [i, i] + [f] * 7 + [i, i, p]
        lib.ba_prep_launch.restype = i
        _lib = lib
    return _lib


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


def _prep_terms_cuda(ws, q, t, pw, lam, cam, delta2_m, delta2_s, use_huber,
                     cost_only):
    lib = load_kernel()
    dev = q.device
    f32 = torch.float32
    M, P = ws.kf.shape
    K = q.shape[0]
    if ws.buffers is None:
        raise ValueError("prep_terms: the workspace was prepared on the CPU")
    _check("q", q, f32, (K, 4), dev)
    _check("t", t, f32, (K, 3), dev)
    pw = _check("pw", pw.contiguous(), f32, (P, 3), dev)
    _check("ws.kf", ws.kf, torch.int32, (M, P), dev)
    _check("ws.uvr", ws.uvr, f32, (3, M, P), dev)
    _check("ws.isig", ws.isig, f32, (M, P), dev)
    _check("ws.flags", ws.flags, torch.uint8, (M, P), dev)
    Wb, Y, diag, hinv6, bp, cost, chi2 = ws.buffers
    if cost_only:
        lam_ptr = 0
    else:
        lam = _check("lam", lam.reshape(1), f32, (1,), dev)
        lam_ptr = lam.data_ptr()
    qt = torch.cat([q, t], dim=1)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ba_prep_launch(
            qt.data_ptr(), pw.data_ptr(), ws.kf.data_ptr(), ws.uvr.data_ptr(),
            ws.isig.data_ptr(), ws.flags.data_ptr(), lam_ptr, Wb.data_ptr(),
            Y.data_ptr(), diag.data_ptr(), hinv6.data_ptr(), bp.data_ptr(),
            cost.data_ptr(), chi2.data_ptr(), P, M, cam.fx, cam.fy, cam.cx,
            cam.cy, cam.bf, delta2_m, delta2_s, int(use_huber),
            int(cost_only), stream)
    prep_terms.launches += 1
    if err != 0:
        raise RuntimeError(f"ba_prep kernel launch failed: CUDA error {err}")
    if cost_only:
        return PrepTerms(None, None, None, None, None, cost, chi2)
    return PrepTerms(Wb, Y, diag, hinv6, bp, cost, chi2)


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

def _prep_terms_plain(ws, q, t, pw, lam, cam, delta2_m, delta2_s, use_huber,
                      cost_only=False):
    """The kernel's terms from obs_terms_e + sym3_inv + the componentwise
    stacks, computed point-major over E = P * M and returned slot-major."""
    M, P = ws.kf.shape
    E = P * M

    def pm(a):      # [..., M, P] -> [..., P * M], observation e = p * M + m
        return a.transpose(-1, -2).reshape(a.shape[:-2] + (E,))

    def mp(a):      # [..., E] -> [..., M, P]
        return a.reshape(a.shape[:-1] + (P, M)).transpose(-1, -2).contiguous()

    kf_e, uvr_e, isig_e = pm(ws.kf), pm(ws.uvr), pm(ws.isig)
    stereo_e = pm(ws.flags) >= 2
    active_e = pm(ws.active)
    Z = bk._camera_points(kf_e, q, t, pw, M)[3]
    in_front = active_e * (Z > 0.01).to(active_e.dtype)

    def cost_terms(chi2):
        _, rho = bk._robust(chi2, stereo_e, delta2_m, delta2_s, use_huber)
        return mp(rho * in_front), mp(chi2 * active_e)

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
    return PrepTerms(Wb=mp(Wb), Y=mp(Y), diag=mp(torch.cat([Ht, bt, Ybp])),
                     hinv6=torch.stack(Hinv6), bp=bp,
                     **dict(zip(("cost", "chi2"), cost_terms(tm.chi2))))
