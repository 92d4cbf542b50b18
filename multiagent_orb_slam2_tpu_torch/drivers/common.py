"""Shared driver plumbing: settings, vocabulary, per-frame timing.

Counterpart of the JAX package's ``drivers/common.py``, without its
compilation cache (XLA only). The vocabulary is the committed asset read by
path (``vocab.bow.DEFAULT_VOCAB``); training one from the sequences is the
last resort. Raw-camera settings get an ``io/rectify.StereoRectifier``.
``write_fusion_stats`` writes the multi-agent drivers' stats.csv.
"""
from __future__ import annotations

import json
import os
import re
import sys
import time

import numpy as np
import torch

from ..config import SlamConfig, Sensor, from_yaml_dict
from ..io import rectify
from ..vocab import bow as bow_mod

SENSOR_OF = {"mono": Sensor.MONOCULAR, "stereo": Sensor.STEREO,
             "rgbd": Sensor.RGBD}


def load_settings(path: str, sensor: int) -> SlamConfig:
    """Load a reference-style YAML settings file (cv::FileStorage syntax) or
    a JSON dict of the same keys."""
    if path.endswith(".json"):
        with open(path) as f:
            d = json.load(f)
    else:
        d = _parse_opencv_yaml(path)
    return from_yaml_dict(d, sensor=sensor)


def metric_depth(cfg: SlamConfig) -> SlamConfig:
    """cfg for depth maps that the dataset loaders have already scaled to
    metres (``io/datasets._imread_depth`` divides by the dataset's factor):
    depth_map_factor 1, so that neither the dataset's factor nor a settings
    file's DepthMapFactor is applied a second time. The reference applies
    the factor once (mDepthMapFactor)."""
    return cfg.replace(depth_map_factor=1.0)


def _parse_opencv_yaml(path: str) -> dict:
    """Minimal parser for the reference's 'Key.Sub: value' YAML files
    (e.g. Examples/Stereo/KITTI00-02.yaml, EuRoC.yaml). Handles scalar
    entries plus `!!opencv-matrix` nodes (rows/cols/data) such as the
    LEFT./RIGHT. rectification blocks."""
    out = {}
    with open(path) as f:
        text = f.read()
    lines = [ln.split("#")[0].rstrip() for ln in text.splitlines()]
    i = 0
    while i < len(lines):
        line = lines[i].strip()
        i += 1
        if not line or line.startswith("%") or ":" not in line:
            continue
        key, _, val = line.partition(":")
        key, val = key.strip(), val.strip()
        if val.startswith("!!opencv-matrix"):
            # collect the indented block
            block = []
            while i < len(lines) and (lines[i].startswith((" ", "\t"))
                                      or not lines[i].strip()):
                block.append(lines[i])
                i += 1
            blob = " ".join(block)
            rows = int(re.search(r"rows:\s*(\d+)", blob).group(1))
            cols = int(re.search(r"cols:\s*(\d+)", blob).group(1))
            data = re.search(r"data:\s*\[([^\]]*)\]", blob).group(1)
            vals = [float(x) for x in data.replace(",", " ").split()]
            out[key] = np.array(vals, dtype=np.float64).reshape(rows, cols)
            continue
        if not val or val.startswith(("[", "{")):
            continue
        try:
            out[key] = float(val)
        except ValueError:
            out[key] = val
    return out


def get_rectifier(settings_path: str, device=torch.device("cuda")):
    """A StereoRectifier on `device` when the settings file carries the
    raw-camera LEFT./RIGHT. K/D/R/P blocks (EuRoC-style); None for
    pre-rectified datasets (KITTI, TUM, the synthetic corridor) and for a
    settings file this parser cannot read, as in the JAX package."""
    if settings_path and settings_path.endswith((".yaml", ".yml")):
        try:
            d = _parse_opencv_yaml(settings_path)
        except Exception:
            return None
        if rectify.StereoRectifier.available(d):
            return rectify.StereoRectifier(d, device=device)
    return None


def get_vocabulary(path: str, sequences=None, cfg: SlamConfig = None,
                   n_frames: int = 30, device=torch.device("cuda")
                   ) -> bow_mod.Vocabulary:
    """Load a vocabulary; fall back to the committed offline asset, then to
    training on the sequences (last resort: a vocabulary trained on 30
    frames of the sequence under test has measurably poor recall; the
    reference always loads its offline-trained ORBvoc.txt)."""
    if path and os.path.exists(path):
        return bow_mod.load_vocabulary(path, device=device)
    if os.path.exists(bow_mod.DEFAULT_VOCAB):
        if path:
            print(f"warning: vocabulary {path} not found; using the "
                  f"bundled asset {bow_mod.DEFAULT_VOCAB}", file=sys.stderr)
        return bow_mod.load_vocabulary(device=device)
    if sequences is None:
        raise FileNotFoundError(f"vocabulary {path} not found and no "
                                "training data given")
    from ..ops import frame as frame_mod
    descs = []
    for seq in sequences:
        step = max(len(seq) // n_frames, 1)
        for i in range(0, len(seq), step):
            left, _, _ = seq.load(i)
            f = frame_mod.extract_frame(left, cfg, device=device)
            descs.append(f.desc[f.valid].cpu().numpy().view(np.uint32))
    vocab = bow_mod.train_vocabulary(np.concatenate(descs), k=10, depth=4,
                                     device=device)
    if path:
        bow_mod.save_vocabulary(vocab, path)
    return vocab


class FrameTimer:
    """Per-frame timing + mean/median printout (the reference drivers print
    'mean tracking time' / 'median tracking time'). On a CUDA device the
    frame ends with a synchronize, so a time is the card's work and not the
    time to queue its launches."""

    def __init__(self, device=None):
        self.device = torch.device(device) if device is not None else None
        self.times = []

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *a):
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.times.append(time.perf_counter() - self._t0)

    def report(self, label="tracking"):
        if not self.times:
            return
        ts = sorted(self.times)
        print(f"median {label} time: {ts[len(ts) // 2] * 1e3:.1f} ms")
        print(f"mean {label} time:   {np.mean(ts) * 1e3:.1f} ms")


def write_fusion_stats(path: str, stats: list):
    """stats.csv with the reference's schema (generic_split_seq.cc: sim3,
    mf, ckf, cmp, mkf, mmp, the cd columns, gba; times in microseconds)."""
    with open(path, "w") as f:
        f.write("sim3,mf,ckf,cmp,mkf,mmp,cd,cdsum,cdmean,cdstdev,cdmed,gba\n")
        for s in stats:
            f.write(f"{s['sim3_ms'] * 1e3:.0f},{s['mf_ms'] * 1e3:.0f},"
                    f"{s['ckf']},{s.get('cmp', 0)},{s.get('mkf', 0)},"
                    f"{s.get('mmp', 0)},{s['cd_ms'] * 1e3:.0f},"
                    f"{s.get('cd_sum_ms', 0) * 1e3:.0f},"
                    f"{s.get('cd_mean_ms', 0) * 1e3:.0f},"
                    f"{s.get('cd_stdev_ms', 0) * 1e3:.0f},"
                    f"{s.get('cd_med_ms', 0) * 1e3:.0f},"
                    f"{s['gba_ms'] * 1e3:.0f}\n")
