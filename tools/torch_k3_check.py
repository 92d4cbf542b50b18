#!/usr/bin/env python3
"""K3 (csrc/pcg.cu) held against its plain version as ``chip_smoke.py``
holds it, without the rest of that script: on the reduced camera systems of
its synthetic builds (D = 48, 384, 1536, 3072, every pose live; where
D > 924 the earlier grid design with float32 row sums is timed beside it),
the cluster path's other sizes (D = 654, 924), the seeded systems that reach
each path of the live solve (D = 3072 with an eighth of the poses live,
D = 1536 and 3072 all live, an all-inert system), then on the first local
BA of the monocular path over the corridor's first 60 frames (the
well-conditioned system on which the residual reaches float32's floor).
Every ``pcg:`` line carries the live poses, the path, the earlier design's
time in turns and the residual's readings (the kernel's, the plain
version's, the plain version's worst under eight reorderings of the pose
blocks, the float64 solution rounded to float32). Needs one NVIDIA GPU;
about 4 minutes.

    python3 tools/torch_k3_check.py
"""
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as smoke  # noqa: E402


def main():
    if not torch.cuda.is_available():
        raise SystemExit("torch_k3_check.py needs a CUDA device")
    print(smoke.card_line())
    smoke.cuda_build.load_libraries(["pose_opt", "ba_prep", "pcg"])
    for name, log in smoke.cuda_build.build_logs.items():
        used = [ln.strip() for ln in log.splitlines()
                if "Used" in ln or "spill" in ln]
        print(f"ptxas {name}: " + " | ".join(used))
    smoke.check_pcg_live_systems()
    smoke.check_pcg_cluster_sizes()
    _, systems = smoke.check_prep_kernel()
    smoke.check_pcg_kernel(systems)
    del systems
    torch.cuda.empty_cache()
    frames, _, t_gt = smoke.render_corridor(smoke.N_FRAMES_BA)
    smoke.drive_mono(frames, t_gt, smoke.bow_mod.load_vocabulary())
    print("k3 check: ok")


if __name__ == "__main__":
    main()
