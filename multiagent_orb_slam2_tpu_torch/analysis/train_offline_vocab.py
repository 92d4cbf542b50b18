"""Train an offline vocabulary on a held-out synthetic corpus.

Counterpart of the JAX package's ``analysis/train_offline_vocab.py``, which
built the committed asset ``vocab_synth_100k.npz`` (the stand-in for the
reference's offline ORBvoc.txt): the same corpus, many held-out box scenes
(scene seeds from 1000, disjoint from the evaluation seeds 0..4, each with
its own depth, width, height and texture scale) walked with random forward
steps and yaw, the left image of every frame through the port's
``extract_frame`` (ORB, 600 features at 512x288) on ``--device``, then
``vocab.bow.train_vocabulary`` (hierarchical k-medians on the host, seed 7)
and ``save_vocabulary`` in the file layout both packages read.

The output path is required and may not lie inside the JAX package: the
committed asset (``vocab.bow.DEFAULT_VOCAB``) stays the JAX package's.
The corpus is cached only where ``--corpus-cache`` names a file.

  python -m multiagent_orb_slam2_tpu_torch.analysis.train_offline_vocab \\
      -o VOCAB.npz [--scenes 40] [--frames-per-scene 40] [-k 10] \\
      [--depth 5] [--workers 8] [--device cuda]
"""
from __future__ import annotations

import argparse
import multiprocessing
import os
import pathlib
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import torch

from ..config import OrbConfig, Sensor, SlamConfig
from ..geometry import se3
from ..geometry.camera import Intrinsics
from ..io.synthetic import BoxScene
from ..ops import frame as frame_mod
from ..vocab import bow as bow_mod

CAM = Intrinsics(fx=260.0, fy=260.0, cx=256.0, cy=144.0, bf=260.0 * 0.12,
                 width=512, height=288)
CFG = SlamConfig(camera=CAM, sensor=Sensor.STEREO,
                 orb=OrbConfig(n_features=600))
JAX_PACKAGE = pathlib.Path(__file__).resolve().parents[2] \
    / "multiagent_orb_slam2_tpu"
# the JAX script's default corpus cache, which it reads back if present
JAX_CORPUS_CACHE = pathlib.Path("/tmp/vocab_corpus.npy")


def scene_walk(seed: int, frames: int):
    """The scene of `seed` (its parameters drawn first) and the camera
    poses (q_wc, t_wc) of its random walk, from one numpy generator in the
    JAX script's order of draws."""
    rng = np.random.default_rng(seed)
    params = dict(z_far=float(rng.uniform(15, 40)),
                  half_w=float(rng.uniform(1.5, 4.0)),
                  half_h=float(rng.uniform(1.0, 2.5)),
                  tex_scale=float(rng.uniform(60, 200)))
    z, yaw, poses = 1.0, 0.0, []
    for _ in range(frames):
        z = min(z + rng.uniform(0.1, 0.6), params["z_far"] - 2.0)
        yaw += rng.uniform(-0.15, 0.15)
        w = np.array([0.0, yaw, 0.0]) + rng.normal(0, 0.01, 3)
        q = se3.so3_exp_quat(torch.tensor(w, dtype=torch.float32)).numpy()
        t = np.array([rng.uniform(-0.5, 0.5), rng.uniform(-0.3, 0.3), z])
        poses.append((q, t))
    return params, poses


def render_scene(seed: int, frames: int):
    """The walk's left images of scene `seed`, uint8 [frames, H, W]."""
    params, poses = scene_walk(seed, frames)
    scene = BoxScene(seed=seed, **params)
    return np.stack([np.clip(scene.render(CAM, q, t)[0], 0, 255)
                     .astype(np.uint8) for q, t in poses])


def build_corpus(n_scenes: int, frames_per_scene: int, device,
                 seed0: int = 1000, workers: int = 1):
    """The valid ORB descriptors [N, 8] uint32 of every frame of every
    scene, in scene and frame order, and the seconds spent in
    extract_frame (synchronized at each frame on a CUDA device). With
    workers > 1 a pool of that many processes (spawn) renders the scenes;
    the images are the serial ones, bit for bit."""
    device = torch.device(device)
    seeds = [seed0 + s for s in range(n_scenes)]
    if workers > 1:
        pool = ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn"))
        scenes = pool.map(render_scene, seeds,
                          [frames_per_scene] * n_scenes)
    else:
        pool = None
        scenes = (render_scene(s, frames_per_scene) for s in seeds)
    descs, extract_s = [], 0.0
    try:
        for s, images in enumerate(scenes):
            t0 = time.perf_counter()
            for img in images:
                f = frame_mod.extract_frame(img, CFG, device=device)
                descs.append(f.desc[f.valid].cpu().numpy().view(np.uint32))
            extract_s += time.perf_counter() - t0
            print(f"scene {s}: {frames_per_scene} frames", flush=True)
    finally:
        if pool is not None:
            pool.shutdown()
    return np.concatenate(descs), extract_s


def _inside(path: pathlib.Path, root: pathlib.Path) -> bool:
    return path == root or root in path.parents


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-o", "--out", required=True)
    ap.add_argument("--scenes", type=int, default=40)
    ap.add_argument("--frames-per-scene", type=int, default=40)
    ap.add_argument("-k", type=int, default=10)
    ap.add_argument("--depth", type=int, default=5)
    ap.add_argument("--corpus-cache", default="")
    ap.add_argument("--workers", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    out = pathlib.Path(args.out).resolve()
    if _inside(out, JAX_PACKAGE.resolve()):
        raise SystemExit(f"refusing to write {out}: inside the JAX package "
                         f"({JAX_PACKAGE}), whose asset stays as it is")
    cache = pathlib.Path(args.corpus_cache).resolve() \
        if args.corpus_cache else None
    if cache is not None and cache == JAX_CORPUS_CACHE:
        raise SystemExit(f"refusing the corpus cache {cache}: the JAX "
                         f"script's, built by the JAX front end")

    if cache is not None and cache.is_file():
        descs, extract_s = np.load(cache), None
        print(f"loaded cached corpus: {len(descs)} descriptors")
    else:
        t0 = time.perf_counter()
        descs, extract_s = build_corpus(args.scenes, args.frames_per_scene,
                                        args.device, workers=args.workers)
        print(f"corpus: {len(descs)} descriptors from {args.scenes} scenes "
              f"x {args.frames_per_scene} frames in "
              f"{time.perf_counter() - t0:.1f} s, extract_frame "
              f"{extract_s:.1f} s on {args.device}", flush=True)
        if cache is not None:
            np.save(cache, descs)

    t0 = time.perf_counter()
    vocab = bow_mod.train_vocabulary(descs, k=args.k, depth=args.depth,
                                     seed=7, device=args.device)
    train_s = time.perf_counter() - t0
    print(f"trained {args.k}^{args.depth} = {args.k ** args.depth} words in "
          f"{train_s:.1f} s on the host")
    out.parent.mkdir(parents=True, exist_ok=True)
    bow_mod.save_vocabulary(vocab, str(out))
    print(f"saved {out} ({out.stat().st_size / 1e6:.1f} MB)")
    return {"descriptors": int(len(descs)), "extract_s": extract_s,
            "train_s": train_s, "words": args.k ** args.depth}


if __name__ == "__main__":
    main()
