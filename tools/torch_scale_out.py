#!/usr/bin/env python3
"""The scale-out phase of ``chip_smoke.py`` without the rest of that script:
the benchmark's global BA (256, 65536, 8) point-sharded by
``parallel/dist_ba`` over 1 rank (NCCL, this process), 2 and 4 ranks
(spawned, sharing card 0 on gloo) and, where the machine has two or more
cards, NCCL with one rank per card (up to 4); one ``multichip_step`` and
``multichip_frontend`` on the (2, 2) mesh (the front end on 4 frames of the
corridor, rendered here); K1, K2 and K3 held against their plain versions on
the phase's problems. Prints the ``scale-out:`` lines. About 2 minutes.

    python3 tools/torch_scale_out.py
"""
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as smoke  # noqa: E402


def main():
    if not torch.cuda.is_available():
        raise SystemExit("torch_scale_out.py needs a CUDA device")
    print(smoke.card_line())
    smoke.cuda_build.load_libraries(["pose_opt", "ba_prep", "pcg"])
    frames, _, _ = smoke.render_corridor(max(smoke.FRONTEND_FRAMES) + 1)
    step_inputs = smoke.frontend_inputs(frames)
    del frames
    smoke.scale_out(step_inputs)
    print("scale-out check: ok")


if __name__ == "__main__":
    main()
