"""Generate a KITTI-length synthetic stereo sequence with a loop revisit.

Counterpart of the JAX package's ``analysis/make_synth_seq.py``, with the
same trajectory (the same numpy draws), camera, scene, settings, file names
and formats, so the two packages' sequences are interchangeable. The
trajectory walks down a ray-cast box corridor (``io/synthetic``, exact
ground truth), turns 180 degrees in place, walks back and turns again at
the start: the final stretch revisits the opening viewpoints, so loop
closure must fire.

Writes left_%05d.npy / right_%05d.npy (uint8), times.txt, gt_tum.txt and
settings.json into the output directory. Rendering is host numpy (about a
third of a second a frame at 512x288); ``--workers N`` renders with a pool
of N processes started with the ``spawn`` method, which is safe in a
process that has already initialised CUDA.

  python -m multiagent_orb_slam2_tpu_torch.analysis.make_synth_seq \\
      -o OUT --seed 0 --frames 660 --workers 8
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from ..geometry.camera import Intrinsics
from ..io.synthetic import BoxScene, _so3_exp_quat


def loop_trajectory(n_frames: int, z_lo: float, z_hi: float, seed: int = 0):
    """Camera-to-world poses: forward along +z, 180-deg turn, return, turn
    back. Returns (q_wc [n,4], t_wc [n,3])."""
    rng = np.random.default_rng(seed)
    # clamp so short sequences (< ~100 frames) still produce positive legs
    n_turn = min(max(n_frames // 14, 24), max(n_frames // 4, 1))
    n_leg = max((n_frames - 2 * n_turn) // 2, 1)
    yaw = []
    zs = []
    # leg out
    zs += list(np.linspace(z_lo, z_hi, n_leg))
    yaw += [0.0] * n_leg
    # turn (in place)
    yaw += list(np.linspace(0.0, np.pi, n_turn))
    zs += list(np.full(n_turn, z_hi))
    # leg back
    zs += list(np.linspace(z_hi, z_lo, n_leg))
    yaw += [np.pi] * n_leg
    # turn back at the start
    rest = n_frames - len(zs)
    yaw += list(np.linspace(np.pi, 2 * np.pi, rest))
    zs += list(np.full(rest, z_lo))

    qs, ts = [], []
    for i in range(n_frames):
        w = np.array([0.0, yaw[i], 0.0]) + rng.normal(0, 0.002, 3)
        q = _so3_exp_quat(w)
        t = np.array([0.35 * np.sin(i * 0.05), 0.15 * np.sin(i * 0.03),
                      zs[i]]) + rng.normal(0, 0.004, 3)
        qs.append(q)
        ts.append(t)
    return np.stack(qs), np.stack(ts)


def camera(width: int = 512, height: int = 288) -> Intrinsics:
    """The generator's camera: fx = fy = 260, a 0.12 m baseline."""
    return Intrinsics(fx=260.0, fy=260.0, cx=width / 2.0, cy=height / 2.0,
                      bf=260.0 * 0.12, width=width, height=height)


# one scene and camera per worker process, set by _init_worker
_scene = None
_cam = None


def _init_worker(seed: int, z_far: float, cam: Intrinsics):
    global _scene, _cam
    _scene = BoxScene(seed=seed, z_far=z_far)
    _cam = cam


def _render(pose):
    return _scene.render_stereo(_cam, *pose)


def render_stereo_frames(seed: int, cam: Intrinsics, q_wc, t_wc,
                         z_far: float = 30.0, workers: int = 1):
    """Yield the float32 stereo pair and the left camera's exact depth
    (left, right, depth) of each pose in ``BoxScene(seed, z_far)``, in
    order. With workers > 1 a pool of that many processes renders (``spawn``
    start method; a worker that fails to start raises BrokenProcessPool);
    the frames are the serial ones, bit for bit."""
    poses = list(zip(q_wc, t_wc))
    if workers > 1:
        with ProcessPoolExecutor(
                workers, mp_context=multiprocessing.get_context("spawn"),
                initializer=_init_worker,
                initargs=(seed, z_far, cam)) as pool:
            yield from pool.map(_render, poses, chunksize=4)
    else:
        _init_worker(seed, z_far, cam)
        for pose in poses:
            yield _render(pose)


def write_sequence(out: str, seed: int, q_wc, t_wc, cam: Intrinsics,
                   fps: float = 10.0, workers: int = 1):
    """Render the poses (q_wc, t_wc) in ``BoxScene(seed, z_far=30)`` and
    write the sequence: frames, times.txt, gt_tum.txt, settings.json."""
    n = len(q_wc)
    os.makedirs(out, exist_ok=True)
    frames = render_stereo_frames(seed, cam, q_wc, t_wc, workers=workers)
    for i, (left, right, _) in enumerate(frames):
        np.save(os.path.join(out, f"left_{i:05d}.npy"),
                np.clip(left, 0, 255).astype(np.uint8))
        np.save(os.path.join(out, f"right_{i:05d}.npy"),
                np.clip(right, 0, 255).astype(np.uint8))
        if i % 100 == 0:
            print(f"rendered {i}/{n}", flush=True)

    np.savetxt(os.path.join(out, "times.txt"), np.arange(n) / fps,
               fmt="%.6f")
    with open(os.path.join(out, "gt_tum.txt"), "w") as f:
        for i in range(n):
            q = q_wc[i]
            row = (i / fps, *t_wc[i], q[1], q[2], q[3], q[0])
            f.write(" ".join(f"{v:.9f}" for v in row) + "\n")
    settings = {
        "Camera.fx": cam.fx, "Camera.fy": cam.fy, "Camera.cx": cam.cx,
        "Camera.cy": cam.cy, "Camera.bf": cam.bf,
        "Camera.width": cam.width, "Camera.height": cam.height,
        "Camera.fps": fps, "ThDepth": 35.0,
        "ORBextractor.nFeatures": 600, "ORBextractor.scaleFactor": 1.2,
        "ORBextractor.nLevels": 8, "ORBextractor.iniThFAST": 20,
        "ORBextractor.minThFAST": 7,
    }
    with open(os.path.join(out, "settings.json"), "w") as f:
        json.dump(settings, f, indent=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-o", "--out", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--frames", type=int, default=660)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=288)
    ap.add_argument("--fps", type=float, default=10.0)
    ap.add_argument("--workers", type=int, default=1)
    args = ap.parse_args(argv)

    q_wc, t_wc = loop_trajectory(args.frames, 1.0, 24.0, seed=args.seed)
    write_sequence(args.out, args.seed, q_wc, t_wc,
                   camera(args.width, args.height), args.fps, args.workers)
    print(f"wrote {args.frames}-frame sequence to {args.out}")


if __name__ == "__main__":
    main()
