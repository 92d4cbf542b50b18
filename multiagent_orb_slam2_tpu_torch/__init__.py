"""PyTorch / CUDA port of the multi-agent visual SLAM engine.

Sits beside ``multiagent_orb_slam2_tpu`` (the JAX reference) with the same
sub-packages and file names, so the counterpart of a module is found at the
same relative path. It imports ``torch`` and ``numpy`` only.

What is ported so far: single-agent stereo tracking and mapping without
local bundle adjustment (``System.track_stereo`` -> ``ops.frame.extract_frame``
-> ``runtime.steps.track_frame_step`` -> ``runtime.steps.
keyframe_pipeline_step``), with the pose-only optimizer as a hand-written
CUDA kernel for sm_90a (``csrc/pose_opt.cu``, bound in ``optim/pose_opt.py``).
Entry points run on the CUDA device unless the caller passes another one.

Geometry runs in strict float32: nothing here enables TF32, because a
reduced-precision matmul on world coordinates (tens of metres, structure at
millimetres) corrupts the whole pipeline.
"""

__version__ = "0.1.0"
