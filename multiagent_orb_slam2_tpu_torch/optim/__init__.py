"""Nonlinear least squares: reprojection residuals, the pose-only optimizer
and bundle adjustment (Schur preparation, one-hot assembly, preconditioned
CG); each CUDA kernel has its plain PyTorch version beside it."""
