#!/usr/bin/env python3
"""K3's live solve (csrc/pcg.cu) taken apart on seeded systems, on the card:

- `path:` lines: the path the launcher takes for a live dimension DL in a
  solve of dimension D (`pcg.path_of`), the cluster blocks it puts to work,
  the resident grid's blocks and capacity;
- `pieces:` lines: one solve's device time by kernel (torch.profiler, ten
  solves averaged: the pass over S that lists the live poses, the list, the
  cluster kernel, the grid kernel; a kernel whose case it is not returns at
  once) beside the solve's time from CUDA events, on systems of K poses
  with n of them live (``chip_smoke.live_system``);
- `tune:` lines: the two constants of the launcher, each setting timed in
  turns on the same system and checked against the default's result: the
  fewest poses a cluster block gets (`mpN`, the launcher's
  kClusterMinPoses) and, where D > 924, the live dimension above which the
  grid takes the system instead of the cluster (`grid`: the grid at any
  live size; the launcher's kClusterMaxWide); where D <= 924 also the
  cluster path on all K poses (`all_poses`, the solve before the live
  pass).

Needs one NVIDIA GPU; about 1 minute.

    python3 tools/torch_k3_live.py
"""
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as smoke  # noqa: E402
from multiagent_orb_slam2_tpu_torch.optim import pcg  # noqa: E402

PATHS = [(48, 48), (384, 384), (654, 654), (660, 660), (666, 666),
         (924, 924), (3072, 0), (3072, 48), (3072, 384), (3072, 600),
         (3072, 606), (1536, 1536), (3072, 2376), (3072, 3072)]
PIECES = [(512, 0), (512, 20), (512, 60), (512, 150), (256, 256),
          (512, 512), (64, 64), (64, 8)]
TUNE = [(512, 10), (512, 20), (512, 40), (512, 60), (512, 100), (512, 150),
        (512, 250), (256, 256), (64, 4), (64, 8), (64, 16), (64, 64), (8, 8)]
ANY_SIZE = 1 << 30


def live_launch(lib, min_poses, cluster_max):
    def launch(S, rhs, Dinv, x0, x, scratch, D, K, n_iters, stream):
        return lib.pcg_launch_live(S, rhs, Dinv, x0, x, scratch, D, K,
                                   n_iters, min_poses, cluster_max, stream)
    return launch


def all_poses(lib):
    def launch(S, rhs, Dinv, x0, x, scratch, D, K, n_iters, stream):
        return lib.pcg_launch_cluster(S, rhs, Dinv, x0, x, D, K, n_iters,
                                      lib.pcg_cluster_blocks(D), stream)
    return launch


def pieces(K, n):
    """Device ms of one solve by kernel, and the solve's ms."""
    from torch.profiler import ProfilerActivity, profile
    S, rhs, Dinv = smoke.live_system(K, n, 7)
    run = pcg._bind_launch(S, rhs, Dinv, 32, torch.zeros_like(rhs))[0]
    ms = smoke.device_ms(run)
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            run()
        torch.cuda.synchronize()
    by_kernel = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        if t is None:
            t = getattr(e, "cuda_time_total", 0)
        for name in ("pcg_live_rows", "pcg_live_compact", "pcg_cluster",
                     "pcg_live_grid"):
            if name in e.key and t:
                by_kernel[name] = by_kernel.get(name, 0.0) + t / 10 / 1e3
    return {"K": K, "live": n, "ms": ms, "kernels_ms": by_kernel,
            "kernels_sum_ms": sum(by_kernel.values())}


def tune(lib, K, n):
    """Each setting timed in turns (forward, then backward) on one seeded
    system, its result held against the default launcher's."""
    S, rhs, Dinv = smoke.live_system(K, n, 11)
    x0 = torch.zeros_like(rhs)
    ref = pcg.pcg_solve(S, rhs, Dinv, 32, x0)
    variants = {f"mp{m}": live_launch(lib, m, ANY_SIZE)
                for m in (1, 4, 8, 16, 1000)}
    if 6 * K > 924 and 6 * n > 120:
        variants["grid"] = live_launch(lib, 4, 0)
    if 6 * K <= 924:
        variants["all_poses"] = all_poses(lib)
    runs, row = {}, {"K": K, "live": n}
    for key, launch in variants.items():
        run, x = pcg._bind_launch(S, rhs, Dinv, 32, x0, launch=launch)
        run()
        torch.cuda.synchronize()
        row[f"{key}_err"] = float((x - ref).abs().max()
                                  / ref.abs().max().clamp_min(1e-30))
        runs[key] = run
    times = {key: [] for key in runs}
    for key in list(runs) + list(runs)[::-1]:
        times[key].append(smoke.device_ms(runs[key]))
    row.update({key: min(t) for key, t in times.items()})
    return row


def main():
    if not torch.cuda.is_available():
        raise SystemExit("torch_k3_live.py needs a CUDA device")
    print(smoke.card_line())
    smoke.cuda_build.load_libraries(["pcg"])
    lib = pcg.load_kernel()
    for D, DL in PATHS:
        print("path: " + json.dumps({
            "D": D, "DL": DL, "path": pcg.path_of(D, DL),
            "cluster_blocks": lib.pcg_live_cluster_blocks(D, DL)}))
    print("path: " + json.dumps({
        "resident_blocks": lib.pcg_resident_blocks(),
        "resident_cap_K512": lib.pcg_resident_cap(512),
        "resident_cap_K256": lib.pcg_resident_cap(256)}))
    for K, n in PIECES:
        print("pieces: " + json.dumps(pieces(K, n)))
    for K, n in TUNE:
        print("tune: " + json.dumps(tune(lib, K, n)))
    print(smoke.card_line())


if __name__ == "__main__":
    main()
