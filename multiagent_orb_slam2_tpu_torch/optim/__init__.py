"""Nonlinear least squares: reprojection residuals and the pose-only
optimizer (plain PyTorch version + CUDA kernel)."""
