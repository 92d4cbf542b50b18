"""Map / trajectory / frame rendering to image files.

Counterpart of the JAX package's ``viz/plot.py``; the tensors it is given
may live on any device and are copied to the host.

- plot_map:          top-down + side view of map points, keyframe centres
                     and covisibility edges, coloured per agent (MapDrawer's
                     per-System reference colours, include/MapDrawer.h:60)
- plot_trajectories: estimated vs ground-truth paths
- draw_frame:        keypoints + tracked-point overlay on a camera image
                     (FrameDrawer::DrawFrame)
"""
from __future__ import annotations

import numpy as np
import torch

from ..geometry import se3

_AGENT_COLORS = ["tab:blue", "tab:orange", "tab:green", "tab:red",
                 "tab:purple", "tab:brown"]


def _mpl():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def plot_map(state, path: str, show_covis: bool = True,
             max_points: int = 20000):
    """Render a MapState to a PNG: xz top-down view (left) + xy view
    (right)."""
    plt = _mpl()

    kf_valid = _np(state.kf_valid)
    mp_valid = _np(state.mp_valid)
    pts = _np(state.mp_pos)[mp_valid]
    mp_agent = _np(state.mp_agent)[mp_valid]
    if len(pts) > max_points:
        sel = np.random.default_rng(0).choice(len(pts), max_points,
                                              replace=False)
        pts, mp_agent = pts[sel], mp_agent[sel]

    _, t_wc = se3.inverse(state.kf_q, state.kf_t)
    centers = _np(t_wc)
    kf_agent = _np(state.kf_agent)
    covis = _np(state.covis)

    fig, axes = plt.subplots(1, 2, figsize=(14, 7))
    for ax, (a, b, la, lb) in zip(axes, [(0, 2, "x", "z"), (0, 1, "x", "y")]):
        for ag in np.unique(mp_agent):
            m = mp_agent == ag
            ax.scatter(pts[m, a], pts[m, b], s=0.5, alpha=0.4,
                       color=_AGENT_COLORS[int(ag) % len(_AGENT_COLORS)])
        if show_covis:
            ii, jj = np.nonzero(np.triu(covis, 1) >= 15)
            for i, j in zip(ii, jj):
                if kf_valid[i] and kf_valid[j]:
                    ax.plot([centers[i, a], centers[j, a]],
                            [centers[i, b], centers[j, b]],
                            color="gray", lw=0.3, alpha=0.5)
        for ag in np.unique(kf_agent[kf_valid]):
            m = kf_valid & (kf_agent == ag)
            ax.plot(centers[m, a], centers[m, b], "s-", ms=3,
                    color=_AGENT_COLORS[int(ag) % len(_AGENT_COLORS)],
                    label=f"agent {ag}")
        ax.set_xlabel(la)
        ax.set_ylabel(lb)
        ax.set_aspect("equal")
        ax.legend(loc="best", fontsize=8)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def plot_trajectories(path: str, named_trajs: dict, gt=None):
    """named_trajs: {label: [N, 3] positions}; gt optional [N, 3]."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(8, 8))
    if gt is not None:
        gt = _np(gt)
        ax.plot(gt[:, 0], gt[:, 2], "k--", lw=1, label="ground truth")
    for i, (label, t) in enumerate(named_trajs.items()):
        t = _np(t)
        ax.plot(t[:, 0], t[:, 2], "-", lw=1.2,
                color=_AGENT_COLORS[i % len(_AGENT_COLORS)], label=label)
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_aspect("equal")
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def draw_frame(img, feats, frame_mp, path: str):
    """Overlay keypoints on a grayscale frame: green = tracked map point,
    blue = untracked keypoint (FrameDrawer convention)."""
    plt = _mpl()
    img = _np(img)
    xy = _np(feats.xy)
    valid = _np(feats.valid)
    tracked = _np(frame_mp) >= 0
    fig, ax = plt.subplots(figsize=(img.shape[1] / 80, img.shape[0] / 80))
    ax.imshow(img, cmap="gray", vmin=0, vmax=255)
    m = valid & ~tracked
    ax.scatter(xy[m, 0], xy[m, 1], s=6, facecolors="none",
               edgecolors="tab:blue", lw=0.8)
    m = valid & tracked
    ax.scatter(xy[m, 0], xy[m, 1], s=8, facecolors="none",
               edgecolors="tab:green", lw=1.0)
    ax.set_axis_off()
    ax.set_title(f"{int(valid.sum())} keypoints, {int(m.sum())} tracked",
                 fontsize=9)
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)
