"""PyTorch / CUDA port of the multi-agent visual SLAM engine.

Sits beside ``multiagent_orb_slam2_tpu`` (the JAX reference) with the same
sub-packages and file names, so the counterpart of a module is found at the
same relative path. It imports ``torch`` and ``numpy`` only.

What is ported so far: single-agent stereo tracking and mapping with local
bundle adjustment and keyframe culling (``System.track_stereo`` ->
``ops.frame.extract_frame`` -> ``runtime.steps.track_frame_step`` ->
``runtime.steps.keyframe_pipeline_step`` -> ``runtime.steps.local_ba_step``
-> ``optim.ba.ba_solve_fast``), and loop closing with place recognition
(``vocab``, ``runtime.loop_closing``: keyframe database, Sim3 RANSAC and
refinement, essential graph, global BA). The three kernels of that path are
hand-written CUDA for sm_90a: the pose-only optimizer (``csrc/pose_opt.cu``,
bound in ``optim/pose_opt.py``), the Schur preparation of bundle adjustment
(``csrc/ba_prep.cu``, ``optim/ba_prep.py``) and its preconditioned
conjugate-gradient solver (``csrc/pcg.cu``, ``optim/pcg.py``). Entry points
run on the CUDA device unless the caller passes another one.

Geometry runs in strict float32: nothing here enables TF32, because a
reduced-precision matmul on world coordinates (tens of metres, structure at
millimetres) corrupts the whole pipeline.
"""

__version__ = "0.1.0"
