"""Plain pose-only optimization: the reference a tracked frame's pose is
judged by.

The semantics are those of ORB-SLAM2's Optimizer::PoseOptimization as the
port states them: one world-to-camera pose against fixed map points,
perturbed on the left, T' = exp(xi) T with xi = (rho, phi); observations
(u, v, u_right), the third row only for stereo ones, each weighted by its
inverse level variance and taking part while its point is in front of the
camera (z > 0.01); ``rounds`` rounds of ``iterations`` Levenberg-Marquardt
steps, a Huber kernel with the chi2 thresholds (5.991 mono, 7.815 stereo)
in every round but the last; between rounds every valid observation is
relabelled an inlier where its chi2 at the current pose is within its
threshold. Levenberg-Marquardt: lambda from 1e-3 each round, the damping
lambda * diag + 1e-9, a step kept only where it lowers the robust cost of
the round's inliers, lambda halved then, else multiplied by 4, within
[1e-8, 1e6].

Written from those semantics alone, in plain PyTorch with rotation
matrices and explicit Jacobians; nothing here comes from the program under
test. ``precision``: "fp64" is the reference; "tf32" computes in float32
with both operands of every matrix product rounded to TF32's 10-bit
mantissa, the control.
"""
from __future__ import annotations

import torch

from .ba import Precision, no_tf32, quat_to_rot, skew


class _Mm:
    """Matrix products at a precision: float64, or float32 with TF32
    operands."""

    def __init__(self, precision: str):
        if precision not in ("fp64", "tf32"):
            raise ValueError(f"precision: {precision!r}")
        self.dtype = torch.float64 if precision == "fp64" else torch.float32
        self.pr = Precision("tf32" if precision == "tf32" else "fp32")

    def __call__(self, a, b):
        return self.pr.mm(a, b)


def _exp(xi, mm: _Mm):
    """(dR [3, 3], dt [3]) of the twist xi = (rho, phi) [6]."""
    rho, phi = xi[:3], xi[3:]
    th = float(phi.norm())
    W = skew(phi)
    W2 = mm(W, W)
    if th < 1e-4:
        A, B, C = 1 - th ** 2 / 6, 0.5 - th ** 2 / 24, 1 / 6 - th ** 2 / 120
    else:
        s, c = torch.sin(phi.norm()), torch.cos(phi.norm())
        A, B, C = s / th, (1 - c) / th ** 2, (th - s) / th ** 3
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    return eye + A * W + B * W2, mm(eye + B * W + C * W2, rho[:, None])[:, 0]


class _Frame:
    def __init__(self, pw, uvr, isig, stereo, valid, cam, chi2_mono,
                 chi2_stereo, dtype):
        self.pw = pw.to(dtype)
        self.uvr = uvr.to(dtype)
        self.isig = isig.to(dtype)
        self.stereo = stereo.bool()
        self.valid = valid.bool()
        self.cam = cam
        self.d2 = torch.where(self.stereo, chi2_stereo, chi2_mono).to(dtype)

    def residuals(self, R, t, mm: _Mm):
        """Camera-frame points [N, 3], residuals [N, 3], chi2 [N], in front
        [N]."""
        pc = mm(self.pw, R.t()) + t
        z = pc[:, 2]
        iz = 1.0 / z.clamp_min(1e-6)
        c = self.cam
        u = c["fx"] * pc[:, 0] * iz + c["cx"]
        v = c["fy"] * pc[:, 1] * iz + c["cy"]
        r = self.uvr - torch.stack([u, v, u - c["bf"] * iz], -1)
        r = torch.cat([r[:, :2], torch.where(self.stereo, r[:, 2], 0.0)
                       [:, None]], -1)
        return pc, r, (r * r).sum(-1) * self.isig, z > 0.01

    def robust(self, chi2, huber: bool):
        if not huber:
            return chi2
        return torch.where(chi2 <= self.d2, chi2, 2 * torch.sqrt(self.d2)
                           * torch.sqrt(chi2.clamp_min(1e-12)) - self.d2)

    def cost(self, R, t, inl, huber, mm):
        _, _, chi2, front = self.residuals(R, t, mm)
        return torch.where(inl & front, self.robust(chi2, huber), 0.0).sum()

    def normal_equations(self, R, t, inl, huber, mm):
        pc, r, chi2, front = self.residuals(R, t, mm)
        c = self.cam
        z = pc[:, 2].clamp_min(1e-6)
        iz, iz2 = 1 / z, 1 / (z * z)
        zero = torch.zeros_like(z)
        x, y = pc[:, 0], pc[:, 1]
        st = self.stereo
        # d r / d pc (r = obs - projection), then d pc / d xi = [I, -[pc]x]
        A = -torch.stack([
            c["fx"] * iz, zero, -c["fx"] * x * iz2,
            zero, c["fy"] * iz, -c["fy"] * y * iz2,
            torch.where(st, c["fx"] * iz, zero), zero,
            torch.where(st, -c["fx"] * x * iz2 + c["bf"] * iz2, zero)], -1
        ).reshape(-1, 3, 3)
        J = torch.cat([A, mm(A, -skew(pc))], -1)                 # [N, 3, 6]
        w_rob = (torch.sqrt(self.d2 / chi2.clamp_min(1e-12)).clamp_max(1.0)
                 if huber else torch.ones_like(chi2))
        w = torch.where(inl & front, self.isig * w_rob, 0.0)
        Jt = J.permute(2, 0, 1).reshape(6, -1)                   # [6, 3N]
        Jw = (J * w[:, None, None]).reshape(-1, 6)               # [3N, 6]
        H = mm(Jt, Jw)
        b = -mm(Jt, (w[:, None] * r).reshape(-1, 1))[:, 0]
        return H, b


@torch.no_grad()
def solve(q0, t0, pw, uvr, inv_sigma2, is_stereo, valid, cam: dict,
          rounds: int = 4, iterations: int = 10, chi2_mono: float = 5.991,
          chi2_stereo: float = 7.815, precision: str = "fp64"):
    """One pose's optimization from q0 [4] (w, x, y, z), t0 [3] against its
    observations [N, ...]. Returns (R [3, 3], t [3], inlier [N] bool)."""
    mm = _Mm(precision)
    dt = mm.dtype
    with no_tf32():
        fr = _Frame(pw, uvr, inv_sigma2, is_stereo, valid, cam, chi2_mono,
                    chi2_stereo, dt)
        q = q0.to(dt)
        R, t = quat_to_rot(q / q.norm()), t0.to(dt)
        inl = fr.valid
        eye = torch.eye(6, dtype=dt, device=R.device)
        for rnd in range(rounds):
            huber = rnd < rounds - 1
            lam = 1e-3
            for _ in range(iterations):
                c0 = fr.cost(R, t, inl, huber, mm)
                H, b = fr.normal_equations(R, t, inl, huber, mm)
                Hd = H + eye * (lam * torch.diagonal(H) + 1e-9)
                xi = torch.linalg.solve(Hd, b)
                dR, dtr = _exp(xi, mm)
                R1, t1 = mm(dR, R), mm(dR, t[:, None])[:, 0] + dtr
                if fr.cost(R1, t1, inl, huber, mm) < c0:
                    R, t, lam = R1, t1, lam * 0.5
                else:
                    lam = lam * 4.0
                lam = min(max(lam, 1e-8), 1e6)
            _, _, chi2, front = fr.residuals(R, t, mm)
            inl = fr.valid & (chi2 <= fr.d2) & front
        return R, t, inl


def centre(R, t):
    """Camera centre -R^T t."""
    return -(R.transpose(-1, -2) @ t[..., None])[..., 0]


def rotation_gap(Ra, Rb) -> float:
    """Angle (rad) of Ra^T Rb."""
    D = Ra.double().t() @ Rb.double()
    s = torch.stack([D[2, 1] - D[1, 2], D[0, 2] - D[2, 0],
                     D[1, 0] - D[0, 1]]).norm() / 2
    return float(torch.atan2(s, (torch.trace(D) - 1) / 2))
