#!/usr/bin/env python3
"""K3 (csrc/pcg.cu) held against its plain version as ``chip_smoke.py``
holds it, without the rest of that script: on the reduced camera systems of
its synthetic builds (D = 48, 384 on the cluster path, 1536, 3072 on the
grid path, where the grid path's earlier design with float32 row sums is
timed beside it), then on the first local BA of the monocular path over the
corridor's first 60 frames (the well-conditioned system on which the
residual reaches float32's floor). Every ``pcg:`` line carries the
residual's readings (the kernel's, the plain version's, the plain
version's worst under eight reorderings of the pose blocks, the float64
solution rounded to float32). Needs one NVIDIA GPU; about 3 minutes.

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
    _, systems = smoke.check_prep_kernel()
    smoke.check_pcg_kernel(systems)
    del systems
    torch.cuda.empty_cache()
    frames, _, t_gt = smoke.render_corridor(smoke.N_FRAMES_BA)
    smoke.drive_mono(frames, t_gt, smoke.bow_mod.load_vocabulary())
    print("k3 check: ok")


if __name__ == "__main__":
    main()
