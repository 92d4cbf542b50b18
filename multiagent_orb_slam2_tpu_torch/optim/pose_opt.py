"""Pose-only optimization: the hottest per-frame optimizer.

Counterpart of the JAX package's ``optim/pose_opt.py`` and
``optim/pose_opt_pallas.py`` (reference Optimizer::PoseOptimization): a
single 6-DoF world-to-camera pose against fixed map points,
``pose_opt_rounds`` rounds of ``pose_opt_iters`` LM iterations, chi-square
outlier relabeling between rounds (5.991 mono / 7.815 stereo), Huber kernel
dropped for the final round.

Two implementations of one function live here:

- the CUDA kernel ``csrc/pose_opt.cu`` (replaces the Pallas TPU kernel
  ``optim/pose_opt_pallas.py::_pose_kernel``): the whole schedule in one
  launch, one thread block per problem, so a batch of poses is one launch.
  On an H100 the work is bound by its serial chain of block-wide reductions,
  not by bytes (72 KB at N = 2048) or arithmetic; see the source's header;
- ``_pose_optimize_plain``: the same schedule in tensor ops, following the
  kernel's arithmetic (damping, Cholesky clamps, cost definition), batched.

``pose_optimize`` dispatches on the input's device only: a CUDA tensor goes
to the kernel (or raises), a CPU tensor to the plain version.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..config import OptimizerConfig
from ..geometry.camera import Intrinsics


class PoseObs(NamedTuple):
    """Fixed-capacity observation set for one frame ([N, ...]) or a batch of
    frames ([B, N, ...])."""
    pw: torch.Tensor          # [N, 3] world points (fixed)
    obs: torch.Tensor         # [N, 3] (u, v, u_right); u_right ignored for mono
    inv_sigma2: torch.Tensor  # [N] information scale 1/1.2^(2 level)
    is_stereo: torch.Tensor   # [N] bool
    mask: torch.Tensor        # [N] bool valid observation


def pose_optimize(q0, t0, obs: PoseObs, cam: Intrinsics,
                  cfg: OptimizerConfig = OptimizerConfig()):
    """Optimize Tcw against fixed points.

    q0 [4], t0 [3] and obs fields [N, ...] for one pose, or q0 [B, 4],
    t0 [B, 3] and obs fields [B, N, ...] for a batch of independent poses.
    Returns (q, t, inlier_mask, n_inliers) with the same leading shape.
    """
    single = q0.dim() == 1
    if single:
        q0, t0 = q0[None], t0[None]
        obs = PoseObs(*[a[None] for a in obs])
    if q0.is_cuda:
        out = _pose_optimize_cuda(q0, t0, obs, cam, cfg)
    else:
        out = _pose_optimize_plain(q0, t0, obs, cam, cfg)
    if single:
        out = tuple(a[0] for a in out)
    return out


pose_optimize.launches = 0   # kernel launches so far (plain int)


# ---------------------------------------------------------------------------
# CUDA kernel wrapper
# ---------------------------------------------------------------------------

_lib = None


def load_kernel():
    """Build (first use) and load csrc/pose_opt.cu; returns the ctypes
    library with argument types set."""
    global _lib
    if _lib is None:
        from ..utils.cuda_build import load_library
        lib = load_library("pose_opt")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.pose_opt_launch.argtypes = [p] * 8 + [i, i] + [f] * 7 + [i, i, p]
        lib.pose_opt_launch.restype = i
        lib.pose_opt_max_obs.argtypes = []
        lib.pose_opt_max_obs.restype = i
        lib.pose_opt_reduce_chain.argtypes = [p, i, i, p]
        lib.pose_opt_reduce_chain.restype = i
        _lib = lib
    return _lib


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"pose_optimize: {name} is on {t.device}, "
                         f"expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"pose_optimize: {name} is {t.dtype}, "
                        f"expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"pose_optimize: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    return t.contiguous()


def _pose_optimize_cuda(q0, t0, obs: PoseObs, cam: Intrinsics,
                        cfg: OptimizerConfig):
    lib = load_kernel()
    dev = q0.device
    B, N = obs.pw.shape[0], obs.pw.shape[1]
    if N > lib.pose_opt_max_obs():
        raise ValueError(
            f"pose_optimize: N = {N} observations exceed the kernel's "
            f"register budget of {lib.pose_opt_max_obs()} per problem")
    f32 = torch.float32
    q0 = _check("q0", q0, f32, (B, 4), dev)
    t0 = _check("t0", t0, f32, (B, 3), dev)
    pw = _check("obs.pw", obs.pw, f32, (B, N, 3), dev)
    ob = _check("obs.obs", obs.obs, f32, (B, N, 3), dev)
    isig = _check("obs.inv_sigma2", obs.inv_sigma2, f32, (B, N), dev)
    stereo = _check("obs.is_stereo", obs.is_stereo, torch.bool, (B, N), dev)
    mask = _check("obs.mask", obs.mask, torch.bool, (B, N), dev)

    qt0 = torch.cat([q0, t0, q0.new_zeros((B, 1))], dim=1)
    qt_out = torch.empty((B, 8), dtype=f32, device=dev)
    inlier = torch.empty((B, N), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.pose_opt_launch(
            qt0.data_ptr(), pw.data_ptr(), ob.data_ptr(), isig.data_ptr(),
            stereo.data_ptr(), mask.data_ptr(), qt_out.data_ptr(),
            inlier.data_ptr(), B, N, cam.fx, cam.fy, cam.cx, cam.cy, cam.bf,
            cfg.chi2_mono, cfg.chi2_stereo, cfg.pose_opt_rounds,
            cfg.pose_opt_iters, stream)
    pose_optimize.launches += 1
    if err != 0:
        raise RuntimeError(f"pose_opt kernel launch failed: CUDA error {err}")
    return (qt_out[:, :4], qt_out[:, 4:7], inlier.view(torch.bool),
            qt_out[:, 7].to(torch.int32))


# ---------------------------------------------------------------------------
# Plain PyTorch version (same arithmetic as the kernel, batched over B)
# ---------------------------------------------------------------------------

def _residual(qt, pw, ob, isig, stf, cam):
    """Residual pass at poses qt [B, 7] -> dict of [B, N] tensors."""
    qw, qx, qy, qz, tx, ty, tz = [qt[:, i:i + 1] for i in range(7)]
    pwx, pwy, pwz = pw[..., 0], pw[..., 1], pw[..., 2]
    cx1 = 2.0 * (qy * pwz - qz * pwy)
    cy1 = 2.0 * (qz * pwx - qx * pwz)
    cz1 = 2.0 * (qx * pwy - qy * pwx)
    X = pwx + qw * cx1 + (qy * cz1 - qz * cy1) + tx
    Y = pwy + qw * cy1 + (qz * cx1 - qx * cz1) + ty
    Z = pwz + qw * cz1 + (qx * cy1 - qy * cx1) + tz
    zok = (Z > 0.01).to(Z.dtype)
    iz = 1.0 / Z.clamp_min(1e-6)
    u = cam.fx * X * iz + cam.cx
    v = cam.fy * Y * iz + cam.cy
    r0 = ob[..., 0] - u
    r1 = ob[..., 1] - v
    r2 = (ob[..., 2] - (u - cam.bf * iz)) * stf
    chi2 = (r0 * r0 + r1 * r1 + r2 * r2) * isig
    return X, Y, Z, iz, r0, r1, r2, chi2, zok


def _robust_cost(chi2, d2, use_huber):
    if not use_huber:
        return chi2
    return torch.where(chi2 > d2,
                       2.0 * torch.sqrt(d2) * torch.sqrt(chi2.clamp_min(1e-12))
                       - d2, chi2)


def _chol_solve6(H, b):
    """Damped system H [B, 6, 6], b [B, 6] -> x [B, 6]; clamps as the kernel."""
    B = H.shape[0]
    L = H.new_zeros((B, 6, 6))
    for j in range(6):
        d = H[:, j, j] - torch.sum(L[:, j, :j] * L[:, j, :j], dim=-1)
        ljj = torch.sqrt(d.clamp_min(1e-12))
        L[:, j, j] = ljj
        if j < 5:
            s = H[:, j + 1:, j] - torch.sum(
                L[:, j + 1:, :j] * L[:, j:j + 1, :j], dim=-1)
            L[:, j + 1:, j] = s * (1.0 / ljj)[:, None]
    y = H.new_zeros((B, 6))
    for i in range(6):
        s = b[:, i] - torch.sum(L[:, i, :i] * y[:, :i], dim=-1)
        y[:, i] = s / L[:, i, i]
    x = H.new_zeros((B, 6))
    for i in range(5, -1, -1):
        s = y[:, i] - torch.sum(L[:, i + 1:, i] * x[:, i + 1:], dim=-1)
        x[:, i] = s / L[:, i, i]
    return x


def _se3_update(dx, qt):
    """T_new = exp(dx) * T for dx [B, 6] = (rho, phi), qt [B, 7]; quaternion
    renormalised onto the w >= 0 hemisphere."""
    r0, r1, r2, px, py, pz = [dx[:, i] for i in range(6)]
    qw, qx, qy, qz, tx, ty, tz = [qt[:, i] for i in range(7)]
    t2 = px * px + py * py + pz * pz
    th = torch.sqrt(t2.clamp_min(1e-24))
    small = t2 < 1e-8
    half = 0.5 * th
    k = torch.where(small, 0.5 - t2 / 48.0, torch.sin(half) / th)
    dqw = torch.cos(half)
    dqx, dqy, dqz = k * px, k * py, k * pz
    A = torch.where(small, 0.5 - t2 / 24.0,
                    (1.0 - torch.cos(th)) / t2.clamp_min(1e-30))
    Bc = torch.where(small, 1.0 / 6.0 - t2 / 120.0,
                     (th - torch.sin(th)) / (t2 * th).clamp_min(1e-24))
    h1x = py * r2 - pz * r1
    h1y = pz * r0 - px * r2
    h1z = px * r1 - py * r0
    h2x = py * h1z - pz * h1y
    h2y = pz * h1x - px * h1z
    h2z = px * h1y - py * h1x
    dtx = r0 + A * h1x + Bc * h2x
    dty = r1 + A * h1y + Bc * h2y
    dtz = r2 + A * h1z + Bc * h2z
    nw = dqw * qw - dqx * qx - dqy * qy - dqz * qz
    nx = dqw * qx + dqx * qw + dqy * qz - dqz * qy
    ny = dqw * qy - dqx * qz + dqy * qw + dqz * qx
    nz = dqw * qz + dqx * qy - dqy * qx + dqz * qw
    uvx = dqy * tz - dqz * ty
    uvy = dqz * tx - dqx * tz
    uvz = dqx * ty - dqy * tx
    uux = dqy * uvz - dqz * uvy
    uuy = dqz * uvx - dqx * uvz
    uuz = dqx * uvy - dqy * uvx
    ntx = tx + 2.0 * (dqw * uvx + uux) + dtx
    nty = ty + 2.0 * (dqw * uvy + uuy) + dty
    ntz = tz + 2.0 * (dqw * uvz + uuz) + dtz
    inv = 1.0 / torch.sqrt((nw * nw + nx * nx + ny * ny + nz * nz
                            ).clamp_min(1e-24))
    sgn = torch.where(nw < 0, -inv, inv)
    return torch.stack([nw * sgn, nx * sgn, ny * sgn, nz * sgn,
                        ntx, nty, ntz], dim=1)


def _pose_optimize_plain(q0, t0, obs: PoseObs, cam: Intrinsics,
                         cfg: OptimizerConfig = OptimizerConfig()):
    """The kernel's schedule in tensor ops. q0 [B, 4], t0 [B, 3], obs fields
    [B, N, ...]. Returns (q [B, 4], t [B, 3], inlier [B, N] bool,
    n_inliers [B] int32)."""
    f32 = torch.float32
    pw = obs.pw.to(f32)
    ob = obs.obs.to(f32)
    isig = obs.inv_sigma2.to(f32)
    stf = obs.is_stereo.to(f32)
    mask0 = obs.mask.to(f32)
    d2 = cfg.chi2_stereo * stf + cfg.chi2_mono * (1.0 - stf)
    fx, fy, bf = cam.fx, cam.fy, cam.bf
    rounds, iters = cfg.pose_opt_rounds, cfg.pose_opt_iters
    B = q0.shape[0]
    eye = torch.eye(6, dtype=f32, device=q0.device)

    qt = torch.cat([q0.to(f32), t0.to(f32)], dim=1)          # [B, 7]
    inlier = mask0
    for rnd in range(rounds):
        use_huber = rnd < rounds - 1
        lam = torch.full((B,), 1e-3, dtype=f32, device=q0.device)
        for _ in range(iters):
            X, Y, Z, iz, r0, r1, r2, chi2, zok = _residual(
                qt, pw, ob, isig, stf, cam)
            if use_huber:
                w_rob = torch.sqrt(d2 / chi2.clamp_min(1e-12)).clamp_max(1.0)
            else:
                w_rob = torch.ones_like(chi2)
            w = isig * w_rob * inlier * zok
            cost0 = torch.sum(_robust_cost(chi2, d2, use_huber) * inlier * zok,
                              dim=-1)
            iz2 = iz * iz
            zero = torch.zeros_like(iz)
            a = ((-fx * iz, zero, fx * X * iz2),
                 (zero, -fy * iz, fy * Y * iz2),
                 ((-fx * iz) * stf, zero, (fx * X * iz2 - bf * iz2) * stf))
            rows = []
            for (a0, a1, a2) in a:
                rows.append(torch.stack(
                    [a0, a1, a2, a2 * Y - a1 * Z, a0 * Z - a2 * X,
                     a1 * X - a0 * Y], dim=-1))
            J = torch.stack(rows, dim=-2)                     # [B, N, 3, 6]
            Jw = J * w[..., None, None]
            H = torch.einsum("bnri,bnrj->bij", Jw, J)
            rr = torch.stack([r0, r1, r2], dim=-1)            # [B, N, 3]
            bvec = -torch.einsum("bnri,bnr->bi", Jw, rr)
            # damping: H + lam * diag(H) (+ tiny floor)
            diag = torch.diagonal(H, dim1=-2, dim2=-1)
            Hd = H + eye * (diag * lam[:, None] + 1e-9)[:, None, :]
            dx = _chol_solve6(Hd, bvec)
            qt_new = _se3_update(dx, qt)
            _, _, _, _, _, _, _, chi2n, zokn = _residual(
                qt_new, pw, ob, isig, stf, cam)
            cost1 = torch.sum(_robust_cost(chi2n, d2, use_huber) * inlier
                              * zokn, dim=-1)
            acc = cost1 < cost0
            qt = torch.where(acc[:, None], qt_new, qt)
            lam = torch.where(acc, lam * 0.5, lam * 4.0).clamp(1e-8, 1e6)
        # relabel by chi2 at the current pose (re-admits improved obs)
        _, _, _, _, _, _, _, chi2, zok = _residual(qt, pw, ob, isig, stf, cam)
        inlier = mask0 * (chi2 <= d2).to(f32) * zok
    inl = inlier > 0.5
    return (qt[:, :4], qt[:, 4:7], inl,
            torch.sum(inl, dim=-1).to(torch.int32))
