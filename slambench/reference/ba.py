"""Plain bundle adjustment: the reference the global-BA cells are judged by.

The semantics are those of a map's global BA in ORB-SLAM2 as the port
states them: world-to-camera poses perturbed on the left, T' = exp(xi) T
with xi = (rho, phi); observations (u, v, u_right), the third row only for
stereo ones; a Huber kernel with chi2 thresholds 5.991 (mono) and 7.815
(stereo), or none (local BA's second stage); each slot weighted by its inverse level variance and taking part
while the point is in front of the camera (z > 0.01); fixed and invalid
poses do not move; Levenberg-Marquardt with the damping lambda * diag + 1e-8
on the pose and the point blocks, lambda from 1e-4, halved on a step that
does not raise the cost and multiplied by 5 on one that does, within
[1e-8, 1e4], a step's cost judged at the next build (the rejected step's
build is thrown away and the next one starts from the last good point), and
the last step kept only if it did not raise the cost.

Written from those semantics alone, in plain PyTorch: rotation matrices,
explicit Jacobians, the Schur complement as one dense product of the
points' scattered cross terms, and an exact solve of the free poses'
reduced system in float64. Nothing here comes from the program under test.

``precision``: "fp32" computes every product in float32 (TF32 off);
"tf32" rounds both operands of every matrix product to TF32's 10-bit
mantissa first, as the tensor cores would: the control that a correct
result has to be told apart from.
"""
from __future__ import annotations

import contextlib

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to the nearest TF32 value (10 mantissa bits), ties to
    even, kept in float32."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & -8192
    return i.view(torch.float32)


class Precision:
    def __init__(self, name: str):
        if name not in ("fp32", "tf32"):
            raise ValueError(f"precision: {name!r}")
        self.name = name

    def mm(self, a, b):
        if self.name == "tf32":
            a, b = round_tf32(a), round_tf32(b)
        return torch.matmul(a, b)


@contextlib.contextmanager
def no_tf32():
    """Matrix products in full float32 on the card, whatever was set."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def quat_to_rot(q):
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(q.shape[:-1] + (3, 3))


def skew(v):
    z = torch.zeros_like(v[..., 0])
    return torch.stack([z, -v[..., 2], v[..., 1],
                        v[..., 2], z, -v[..., 0],
                        -v[..., 1], v[..., 0], z], -1
                       ).reshape(v.shape[:-1] + (3, 3))


def se3_exp(xi, pr: Precision):
    """(dR [K, 3, 3], dt [K, 3]) of twists xi = (rho, phi)."""
    rho, phi = xi[:, :3], xi[:, 3:]
    th = phi.norm(dim=-1)[:, None, None]
    W = skew(phi)
    W2 = pr.mm(W, W)
    small = th < 1e-4
    ths = th.clamp_min(1e-4)
    A = torch.where(small, 1 - th ** 2 / 6, torch.sin(ths) / ths)
    B = torch.where(small, 0.5 - th ** 2 / 24, (1 - torch.cos(ths)) / ths ** 2)
    C = torch.where(small, 1 / 6 - th ** 2 / 120,
                    (ths - torch.sin(ths)) / ths ** 3)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    dR = eye + A * W + B * W2
    V = eye + B * W + C * W2
    return dR, pr.mm(V, rho[:, :, None])[..., 0]


class Problem:
    """The map's observations, with the slots that take part in the solve."""

    def __init__(self, f: dict, cam: dict, chi2_mono: float,
                 chi2_stereo: float, use_huber: bool = True):
        self.K = f["q"].shape[0]
        self.kf = f["obs_kf"].long().clamp(0, self.K - 1)
        self.base = (f["obs_mask"] & (f["obs_kf"] >= 0)
                     & f["point_valid"][:, None])
        self.uvr = f["obs_uvr"]
        self.isig = f["obs_inv_sigma2"]
        self.stereo = f["obs_stereo"]
        self.cam = cam
        self.delta2 = torch.where(self.stereo, chi2_stereo, chi2_mono
                                  ).to(torch.float32)
        self.use_huber = use_huber
        self.free = f["pose_valid"] & ~f["pose_fixed"]
        self.free_idx = torch.nonzero(self.free)[:, 0]
        self.has_obs = self.base.any(dim=1)


def _project(pb: Problem, R, t, pw, pr: Precision):
    """Camera-frame points pc [P, M, 3], residuals r [P, M, 3], chi2 and the
    robust cost of every slot (zero where it takes no part)."""
    pc = pr.mm(R[pb.kf], pw[:, None, :, None])[..., 0] + t[pb.kf]
    z = pc[..., 2]
    iz = 1.0 / z.clamp_min(1e-6)
    c = pb.cam
    u = c["fx"] * pc[..., 0] * iz + c["cx"]
    v = c["fy"] * pc[..., 1] * iz + c["cy"]
    ur = u - c["bf"] * iz
    r = pb.uvr - torch.stack([u, v, ur], -1)
    r = torch.cat([r[..., :2],
                   torch.where(pb.stereo, r[..., 2], 0.0)[..., None]], -1)
    chi2 = (r * r).sum(-1) * pb.isig
    act = pb.base & (z > 0.01)
    root = torch.sqrt(chi2.clamp_min(1e-12))
    rho = torch.where(chi2 <= pb.delta2, chi2,
                      2 * torch.sqrt(pb.delta2) * root - pb.delta2) \
        if pb.use_huber else chi2
    return pc, r, chi2, act, torch.where(act, rho, 0.0)


def cost(pb: Problem, R, t, pw, pr: Precision):
    return _project(pb, R, t, pw, pr)[4].sum()


def _step(pb: Problem, R, t, pw, lam, pr: Precision, chunk: int):
    """One damped Gauss-Newton step (dc [K, 6], dp [P, 3]) and the robust
    cost at (R, t, pw)."""
    K = pb.K
    pc, r, chi2, act, rho = _project(pb, R, t, pw, pr)
    c = pb.cam
    z = pc[..., 2].clamp_min(1e-6)
    iz, iz2 = 1 / z, 1 / (z * z)
    zero = torch.zeros_like(z)
    x, y = pc[..., 0], pc[..., 1]
    st = pb.stereo
    # d r / d pc (r = obs - projection)
    A = -torch.stack([
        c["fx"] * iz, zero, -c["fx"] * x * iz2,
        zero, c["fy"] * iz, -c["fy"] * y * iz2,
        torch.where(st, c["fx"] * iz, zero), zero,
        torch.where(st, -c["fx"] * x * iz2 + c["bf"] * iz2, zero)], -1
    ).reshape(pc.shape + (3,))
    Jp = pr.mm(A, R[pb.kf])                                    # [P, M, 3, 3]
    Jc = torch.cat([A, pr.mm(A, -skew(pc))], -1)               # [P, M, 3, 6]
    w_rob = (torch.sqrt(pb.delta2 / chi2.clamp_min(1e-12)).clamp_max(1.0)
             if pb.use_huber else torch.ones_like(chi2))
    w = torch.where(act, pb.isig * w_rob, 0.0)[..., None, None]

    JpT, JcT = Jp.transpose(-1, -2), Jc.transpose(-1, -2)
    Hpp = pr.mm(JpT, w * Jp).sum(1)                            # [P, 3, 3]
    bp = -pr.mm(JpT, w * r[..., None]).sum(1)[..., 0]          # [P, 3]
    Wb = pr.mm(JcT, w * Jp)                                    # [P, M, 6, 3]
    Hcc_s = pr.mm(JcT, w * Jc)                                 # [P, M, 6, 6]
    bc_s = -pr.mm(JcT, w * r[..., None])[..., 0]               # [P, M, 6]

    eye3 = torch.eye(3, dtype=Hpp.dtype, device=Hpp.device)
    dgp = torch.diagonal(Hpp, dim1=-2, dim2=-1)
    Hpp_inv = torch.linalg.inv(Hpp + torch.diag_embed(lam * dgp + 1e-8)
                               + (~pb.has_obs)[:, None, None] * eye3)
    Y = pr.mm(Wb, Hpp_inv[:, None])                            # [P, M, 6, 3]
    Ybp = pr.mm(Y, bp[:, None, :, None])[..., 0]               # [P, M, 6]

    # pose blocks and right-hand side, summed over the slots
    kf = pb.kf.reshape(-1)
    Hcc = torch.zeros(K, 6, 6, dtype=Hpp.dtype, device=Hpp.device)
    Hcc.index_add_(0, kf, Hcc_s.reshape(-1, 6, 6))
    rhs = torch.zeros(K, 6, dtype=Hpp.dtype, device=Hpp.device)
    rhs.index_add_(0, kf, (bc_s - Ybp).reshape(-1, 6))

    # Schur complement over the free poses: sum_p (Y_p)^T-scatter x Wb_p
    F = len(pb.free_idx)
    col = torch.full((K,), F, dtype=torch.int64, device=Hpp.device)
    col[pb.free_idx] = torch.arange(F, device=Hpp.device)
    fc = col[pb.kf]                                            # [P, M]
    S = torch.zeros(6 * F, 6 * F, dtype=Hpp.dtype, device=Hpp.device)
    P, M = pb.kf.shape
    for s in range(0, P, chunk):
        e = min(s + chunk, P)
        n = e - s
        pid = torch.arange(n, device=Hpp.device)[:, None].expand(n, M)
        Yd = torch.zeros(n, F + 1, 6, 3, dtype=Hpp.dtype, device=Hpp.device)
        Wd = torch.zeros_like(Yd)
        Yd.index_put_((pid, fc[s:e]), Y[s:e], accumulate=True)
        Wd.index_put_((pid, fc[s:e]), Wb[s:e], accumulate=True)
        Yd = Yd[:, :F].permute(0, 3, 1, 2).reshape(n * 3, 6 * F)
        Wd = Wd[:, :F].permute(0, 3, 1, 2).reshape(n * 3, 6 * F)
        S -= pr.mm(Yd.t(), Wd)
    Hf = Hcc[pb.free_idx]
    dgc = torch.diagonal(Hf, dim1=-2, dim2=-1)
    Hf = Hf + torch.diag_embed(lam * dgc + 1e-8)
    S = S.view(F, 6, F, 6)
    ar = torch.arange(F, device=Hpp.device)
    S[ar, :, ar, :] += Hf
    S = S.view(6 * F, 6 * F)
    # solved exactly in float64: the reduced system's condition number
    # (1e7 to 1e8 on these maps) is past a float32 factorization, and LU,
    # unlike Cholesky, still gives a step where rounding left the system
    # indefinite (the TF32 control)
    x = torch.linalg.solve(S.double(),
                           rhs[pb.free_idx].reshape(-1, 1).double())
    dc = torch.zeros(K, 6, dtype=Hpp.dtype, device=Hpp.device)
    dc[pb.free_idx] = x.view(F, 6).to(Hpp.dtype)

    # points: back-substitution
    corr = pr.mm(Wb.transpose(-1, -2), dc[pb.kf][..., None])[..., 0].sum(1)
    dp = pr.mm(Hpp_inv, (bp - corr)[..., None])[..., 0]
    dp = torch.where(pb.has_obs[:, None], dp, 0.0)
    return dc, dp, rho.sum()


def _apply(R, t, pw, dc, dp, pr: Precision):
    dR, dt = se3_exp(dc, pr)
    return pr.mm(dR, R), pr.mm(dR, t[..., None])[..., 0] + dt, pw + dp


@torch.no_grad()
def solve(f: dict, cam: dict, n_iters: int = 10, chi2_mono: float = 5.991,
          chi2_stereo: float = 7.815, precision: str = "fp32",
          chunk: int = 2048, use_huber: bool = True):
    """BA of a map's fields (the port's BAProblem fields as tensors), Huber
    or plain least squares. Returns (R [K, 3, 3], t [K, 3], pw [P, 3],
    final cost)."""
    pr = Precision(precision)
    with no_tf32():
        pb = Problem(f, cam, chi2_mono, chi2_stereo, use_huber)
        R, t, pw = quat_to_rot(f["q"]), f["t"], f["pw"]
        Rb, tb, pwb = R, t, pw
        lam = 1e-4
        cost_prev = float("inf")
        for _ in range(n_iters):
            dc, dp, cost_here = _step(pb, R, t, pw, lam, pr, chunk)
            cost_here = float(cost_here)
            improved = cost_here <= cost_prev
            lam = min(max(lam * (0.5 if improved else 5.0), 1e-8), 1e4)
            if improved:
                Rb, tb, pwb = R, t, pw
                R, t, pw = _apply(R, t, pw, dc, dp, pr)
            else:
                R, t, pw = Rb, tb, pwb
            cost_prev = min(cost_here, cost_prev)
        if float(cost(pb, R, t, pw, pr)) > cost_prev:
            R, t, pw = Rb, tb, pwb
        return R, t, pw, float(cost(pb, R, t, pw, pr))
