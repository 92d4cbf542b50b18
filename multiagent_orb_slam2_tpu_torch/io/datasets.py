"""Dataset loaders: TUM RGB-D, KITTI odometry, EuRoC MAV, synthetic.

The port's copy of the JAX package's ``io/datasets.py`` (numpy only; ``cv2``
is imported for image files, never for the synthetic ``.npy`` frames).
Replaces the reference drivers' LoadImages functions
(Examples/Monocular/mono_tum.cc, Examples/Stereo/stereo_kitti.cc:LoadImages,
Examples/MultiAgent/generic_split_seq.cc:399-590, euroc_two_seq.cc) and the
contiguous N-way sequence split of generic_split_seq
(Examples/MultiAgent/generic_split_seq.cc:543-560).

Images load as float32 grayscale [H, W] (0..255). Depth maps load scaled by
the dataset's depth factor.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np


def _imread_gray(path: str) -> np.ndarray:
    if path.endswith(".npy"):
        # synthetic sequences (analysis/make_synth_seq.py) store uint8 npy
        return np.load(path).astype(np.float32)
    import cv2
    img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise FileNotFoundError(path)
    return img.astype(np.float32)


def _imread_depth(path: str, factor: float) -> np.ndarray:
    import cv2
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise FileNotFoundError(path)
    return img.astype(np.float32) / factor


@dataclass
class SequenceItem:
    timestamp: float
    left: str
    right: Optional[str] = None
    depth: Optional[str] = None


@dataclass
class Sequence:
    items: List[SequenceItem]
    depth_factor: float = 5000.0

    def __len__(self):
        return len(self.items)

    def load(self, i: int):
        it = self.items[i]
        left = _imread_gray(it.left)
        right = _imread_gray(it.right) if it.right else None
        depth = _imread_depth(it.depth, self.depth_factor) if it.depth else None
        return left, right, depth

    def timestamps(self):
        return [it.timestamp for it in self.items]

    def split(self, n: int) -> List["Sequence"]:
        """Contiguous N-way split (generic_split_seq.cc:543-560: length /
        remainder distribution; chunks overlap only at junction appearance,
        which is what triggers fusion)."""
        total = len(self.items)
        base = total // n
        rem = total % n
        out, start = [], 0
        for i in range(n):
            size = base + (1 if i < rem else 0)
            out.append(Sequence(self.items[start:start + size],
                                self.depth_factor))
            start += size
        return out


def load_tum_rgbd(root: str, depth_factor: float = 5000.0,
                  max_dt: float = 0.02) -> Sequence:
    """TUM format: rgb.txt + depth.txt with 'timestamp path' rows; nearest
    timestamp association (the reference uses a pre-built associations file)."""
    def read_list(name):
        rows = []
        with open(os.path.join(root, name)) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                ts, path = line.split()[:2]
                rows.append((float(ts), os.path.join(root, path)))
        return rows

    rgb = read_list("rgb.txt")
    depth = read_list("depth.txt")
    dts = np.asarray([d[0] for d in depth])
    items = []
    for ts, path in rgb:
        j = int(np.argmin(np.abs(dts - ts)))
        if abs(dts[j] - ts) <= max_dt:
            items.append(SequenceItem(timestamp=ts, left=path,
                                      depth=depth[j][1]))
    return Sequence(items, depth_factor)


def load_tum_mono(root: str) -> Sequence:
    rows = []
    with open(os.path.join(root, "rgb.txt")) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            ts, path = line.split()[:2]
            rows.append(SequenceItem(timestamp=float(ts),
                                     left=os.path.join(root, path)))
    return Sequence(rows)


def load_kitti_stereo(root: str) -> Sequence:
    """KITTI odometry: image_0/ image_1/ + times.txt."""
    with open(os.path.join(root, "times.txt")) as f:
        times = [float(x) for x in f.read().split()]
    items = []
    for i, ts in enumerate(times):
        items.append(SequenceItem(
            timestamp=ts,
            left=os.path.join(root, "image_0", f"{i:06d}.png"),
            right=os.path.join(root, "image_1", f"{i:06d}.png")))
    return Sequence(items)


def load_kitti_mono(root: str) -> Sequence:
    seq = load_kitti_stereo(root)
    for it in seq.items:
        it.right = None
    return seq


def load_euroc_stereo(root: str, timestamp_file: Optional[str] = None
                      ) -> Sequence:
    """EuRoC: mav0/cam0/data/<ns>.png + cam1; timestamps from the data dir
    (the reference uses external timestamp files; directory listing is
    equivalent for the released sequences)."""
    cam0 = os.path.join(root, "mav0", "cam0", "data")
    cam1 = os.path.join(root, "mav0", "cam1", "data")
    if timestamp_file:
        with open(timestamp_file) as f:
            stamps = [line.strip().split(",")[0] for line in f
                      if line.strip() and not line.startswith("#")]
    else:
        stamps = sorted(os.path.splitext(x)[0] for x in os.listdir(cam0)
                        if x.endswith(".png"))
    items = []
    for s in stamps:
        l = os.path.join(cam0, s + ".png")
        r = os.path.join(cam1, s + ".png")
        if os.path.exists(l) and os.path.exists(r):
            items.append(SequenceItem(timestamp=float(s) * 1e-9, left=l,
                                      right=r))
    return Sequence(items)


def load_euroc_mono(root: str, **kw) -> Sequence:
    seq = load_euroc_stereo(root, **kw)
    for it in seq.items:
        it.right = None
    return seq


def load_synth_stereo(root: str) -> Sequence:
    """Synthetic stereo sequence written by analysis/make_synth_seq.py (of
    either package): left_%05d.npy / right_%05d.npy + times.txt (+
    gt_tum.txt ground truth). Stands in for the unavailable KITTI/EuRoC blobs in the
    at-scale accuracy protocol (SURVEY.md §4)."""
    times = np.atleast_1d(np.loadtxt(os.path.join(root, "times.txt")))
    items = [SequenceItem(timestamp=float(t),
                          left=os.path.join(root, f"left_{i:05d}.npy"),
                          right=os.path.join(root, f"right_{i:05d}.npy"))
             for i, t in enumerate(times)]
    return Sequence(items)


LOADERS = {
    "mono_tum": load_tum_mono,
    "mono_kitti": load_kitti_mono,
    "mono_euroc": load_euroc_mono,
    "stereo_kitti": load_kitti_stereo,
    "stereo_euroc": load_euroc_stereo,
    "stereo_synth": load_synth_stereo,
    "rgbd_tum": load_tum_rgbd,
}
