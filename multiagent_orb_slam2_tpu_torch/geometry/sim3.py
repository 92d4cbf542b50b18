"""Batched Sim(3) similarity transforms (s, quaternion, translation).

Counterpart of the JAX package's ``geometry/sim3.py`` (g2o::Sim3 of the
reference), used by loop closing: Sim3 RANSAC and refinement, the
neighbourhood correction and the essential graph. Layout: scalar scale s,
unit quaternion q (w, x, y, z), translation t. Action: x -> s * R x + t.
"""
from __future__ import annotations

import torch

from . import se3


def identity(shape=(), device=None):
    shape = tuple(shape)
    return (torch.ones(shape, device=device),
            se3.quat_identity(shape, device=device),
            torch.zeros(shape + (3,), device=device))


def apply(s, q, t, p):
    return s[..., None] * se3.quat_rotate(q, p) + t


def compose(sa, qa, ta, sb, qb, tb):
    """S_a * S_b (apply b first)."""
    s = sa * sb
    q = se3.quat_mul(qa, qb)
    t = sa[..., None] * se3.quat_rotate(qa, tb) + ta
    return s, q, t


def inverse(s, q, t):
    si = 1.0 / s
    qi = se3.quat_conj(q)
    ti = -si[..., None] * se3.quat_rotate(qi, t)
    return si, qi, ti


def from_se3(q, t):
    return torch.ones(q.shape[:-1], dtype=q.dtype, device=q.device), q, t


def to_se3(s, q, t):
    """Project to SE3 the way the reference recovers poses after the
    essential graph: divide the translation by the scale."""
    return q, t / s[..., None]


# --- sim3 log/exp (7-vector: rho, phi, sigma) for pose-graph optimization ---

def log(s, q, t):
    """Sim3 -> [..., 7] twist (rho, phi, log s), through the W matrix."""
    phi = se3.so3_log(q)
    sigma = torch.log(s)
    Winv = torch.linalg.inv_ex(_W_matrix(phi, sigma)).inverse
    rho = torch.einsum("...ij,...j->...i", Winv, t)
    return torch.cat([rho, phi, sigma[..., None]], dim=-1)


def exp(xi):
    """[..., 7] twist (rho, phi, sigma) -> (s, q, t)."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    s = torch.exp(sigma)
    q = se3.so3_exp_quat(phi)
    t = torch.einsum("...ij,...j->...i", _W_matrix(phi, sigma), rho)
    return s, q, t


def _W_matrix(phi, sigma):
    """The Sim(3) 'W' integral matrix: W = A I + B Phi + C Phi^2 with
    scale-coupled coefficients. The branches for sigma -> 0 and theta -> 0
    are those of the JAX package, operand for operand: they decide the
    accuracy near the identity, where every LM step is taken."""
    eps = 1e-6
    theta = se3.safe_norm(phi)
    Phi = se3.hat(phi)
    Phi2 = Phi @ Phi
    s = torch.exp(sigma)
    one = torch.ones_like(sigma)

    sig_small = torch.abs(sigma) < eps
    th_small = theta < eps
    sigma_safe = torch.where(sig_small, one, sigma)
    theta_safe = torch.where(th_small, one, theta)

    # A = (s - 1) / sigma
    A = torch.where(sig_small, 1.0 + sigma / 2.0, (s - 1.0) / sigma_safe)

    # a = s sin(theta), b = s cos(theta)
    a = s * torch.sin(theta)
    b = s * torch.cos(theta)
    th2 = theta_safe * theta_safe
    sig2 = sigma_safe * sigma_safe
    denom = torch.where(sig_small & th_small, one, sig2 + th2)

    # B = (a sigma + (1 - b) theta) / (theta (sigma^2 + theta^2))
    B_general = (a * sigma + (1.0 - b) * theta) / (theta_safe * denom)
    B_sig0 = torch.where(th_small, 0.5 * one,
                         (1.0 - torch.cos(theta_safe)) / th2)
    B = torch.where(sig_small, B_sig0,
                    torch.where(th_small, _B_theta0(sigma_safe, s), B_general))

    # C = (A - ((b - 1) sigma + a theta) / denom) / theta^2   [general]
    C_general = (A - ((b - 1.0) * sigma + a * theta) / denom) / th2
    C_sig0 = torch.where(th_small, one / 6.0,
                         (theta_safe - torch.sin(theta_safe))
                         / (th2 * theta_safe))
    C = torch.where(sig_small, C_sig0,
                    torch.where(th_small, _C_theta0(sigma_safe, s), C_general))

    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    return (A[..., None, None] * eye + B[..., None, None] * Phi
            + C[..., None, None] * Phi2)


def _B_theta0(sigma, s):
    # lim theta->0 of B: ((sigma - 1) s + 1) / sigma^2
    return ((sigma - 1.0) * s + 1.0) / (sigma * sigma)


def _C_theta0(sigma, s):
    # lim theta->0 of C: (s (0.5 sigma^2 - sigma + 1) - 1) / sigma^3
    return (s * (0.5 * sigma * sigma - sigma + 1.0) - 1.0) / (sigma ** 3)
