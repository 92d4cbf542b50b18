"""Stereo undistort-rectify for EuRoC-style raw camera pairs.

Counterpart of the JAX package's ``io/rectify.py`` (the reference's EuRoC
drivers build per-camera maps from the LEFT./RIGHT. K, D, R, P settings
matrices with cv::initUndistortRectifyMap and cv::remap every frame). The
dst->src sampling maps are built once on the host (numpy, a copy of the JAX
package's function); the per-frame remap is the same explicit four-tap
bilinear gather on the device, zero outside the image. ``grid_sample`` is
not used: its corner conventions differ from this gather's.
"""
from __future__ import annotations

import numpy as np
import torch


def rectify_map(K, D, R, P, width: int, height: int) -> np.ndarray:
    """Build the dst->src sampling map (equivalent to
    cv::initUndistortRectifyMap with CV_32FC2 output).

    For each destination pixel: back-rotate through R and the new projection
    P[:3,:3], apply the radial-tangential distortion model (k1,k2,p1,p2[,k3]),
    and project through the original K. Returns [H, W, 2] float32 (x, y)
    source coordinates.
    """
    K = np.asarray(K, np.float64).reshape(3, 3)
    D = np.asarray(D, np.float64).ravel()
    k1, k2, p1, p2 = D[0], D[1], D[2], D[3]
    k3 = D[4] if D.size > 4 else 0.0
    R = np.asarray(R, np.float64).reshape(3, 3)
    P = np.asarray(P, np.float64)
    Knew = P[:3, :3]

    u, v = np.meshgrid(np.arange(width, dtype=np.float64),
                       np.arange(height, dtype=np.float64))
    ones = np.ones_like(u)
    pix = np.stack([u, v, ones], axis=-1)          # [H,W,3]
    # x_h = R^-1 @ Knew^-1 @ [u v 1]
    M = np.linalg.inv(R) @ np.linalg.inv(Knew)
    xyz = pix @ M.T
    x = xyz[..., 0] / xyz[..., 2]
    y = xyz[..., 1] / xyz[..., 2]

    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 ** 2 + k3 * r2 ** 3
    x_d = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    y_d = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y

    map_x = K[0, 0] * x_d + K[0, 1] * y_d + K[0, 2]
    map_y = K[1, 1] * y_d + K[1, 2]
    return np.stack([map_x, map_y], axis=-1).astype(np.float32)


@torch.no_grad()
def remap_bilinear(img: torch.Tensor, mapping: torch.Tensor) -> torch.Tensor:
    """Bilinear sample img [H, W] at mapping [H', W', 2] (x, y) on the
    tensors' device; out-of-range taps read 0 (cv::remap BORDER_CONSTANT)."""
    img = img.to(torch.float32)
    H, W = img.shape
    x = mapping[..., 0]
    y = mapping[..., 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    flat = img.reshape(-1)

    def sample(yi, xi):
        ok = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        val = flat[yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)]
        return torch.where(ok, val, torch.zeros_like(val))

    v00 = sample(y0i, x0i)
    v01 = sample(y0i, x0i + 1)
    v10 = sample(y0i + 1, x0i)
    v11 = sample(y0i + 1, x0i + 1)
    return (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
            + v10 * (1 - fx) * fy + v11 * fx * fy)


class StereoRectifier:
    """Per-sequence rectifier built from LEFT./RIGHT. settings matrices.
    The two maps are uploaded to `device` once; a call takes a (left,
    right) pair of numpy arrays or tensors and returns the rectified pair
    as float32 tensors on that device."""

    def __init__(self, settings: dict, device=torch.device("cuda")):
        self.device = torch.device(device)
        wl = int(settings.get("LEFT.width", settings.get("Camera.width", 752)))
        hl = int(settings.get("LEFT.height",
                              settings.get("Camera.height", 480)))
        wr = int(settings.get("RIGHT.width", wl))
        hr = int(settings.get("RIGHT.height", hl))
        self.map_l = torch.from_numpy(rectify_map(
            settings["LEFT.K"], settings["LEFT.D"], settings["LEFT.R"],
            settings["LEFT.P"], wl, hl)).to(self.device)
        self.map_r = torch.from_numpy(rectify_map(
            settings["RIGHT.K"], settings["RIGHT.D"], settings["RIGHT.R"],
            settings["RIGHT.P"], wr, hr)).to(self.device)

    @staticmethod
    def available(settings: dict) -> bool:
        return all(f"{side}.{m}" in settings for side in ("LEFT", "RIGHT")
                   for m in ("K", "D", "R", "P"))

    def _image(self, img):
        if isinstance(img, np.ndarray):
            img = torch.from_numpy(np.ascontiguousarray(img))
        return img.to(device=self.device, dtype=torch.float32)

    def __call__(self, left, right):
        return (remap_bilinear(self._image(left), self.map_l),
                remap_bilinear(self._image(right), self.map_r))
