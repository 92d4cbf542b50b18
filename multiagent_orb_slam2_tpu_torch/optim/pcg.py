"""Preconditioned conjugate gradients on the reduced camera system.

Counterpart of the JAX package's ``ba_kernels.pcg_solve_pallas``. Two
implementations of one function:

- the CUDA kernel ``csrc/pcg.cu`` (replaces the Pallas TPU kernel inside
  ``optim/ba_kernels.py::pcg_solve_pallas``): the whole fixed-length solve in
  one cooperative launch, for every D = 6K (no size above which it gives way
  to another solver); see the source's header for what bounds it;
- ``ba_kernels.pcg_solve``, the plain PyTorch version (``_pcg_solve_plain``
  here).

``pcg_solve`` dispatches on the matrix's device only: a CUDA tensor goes to
the kernel (or raises), a CPU tensor to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from .ba_kernels import pcg_solve as _pcg_solve_plain


def pcg_solve(S_dense, rhs_flat, block_diag_inv, n_iters: int = 48, x0=None):
    """n_iters block-Jacobi preconditioned CG iterations on S x = rhs.

    S_dense [D, D] symmetric positive definite, rhs [D], block_diag_inv
    [K, 6, 6] (inverses of S's diagonal pose blocks), D = 6K, optional warm
    start x0 [D]. Returns x [D]."""
    if S_dense.is_cuda:
        return _pcg_solve_cuda(S_dense, rhs_flat, block_diag_inv, n_iters, x0)
    return _pcg_solve_plain(S_dense, rhs_flat, block_diag_inv, n_iters, x0)


pcg_solve.launches = 0   # kernel launches so far (plain int)

_lib = None


def load_kernel():
    """Build (first use) and load csrc/pcg.cu; returns the ctypes library
    with argument types set."""
    global _lib
    if _lib is None:
        from ..utils.cuda_build import load_library
        lib = load_library("pcg")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.pcg_launch.argtypes = [p] * 6 + [i, i, i, p]
        lib.pcg_launch.restype = i
        lib.pcg_scratch_floats.argtypes = [i]
        lib.pcg_scratch_floats.restype = i
        lib.pcg_grid_blocks.argtypes = [i]
        lib.pcg_grid_blocks.restype = i
        lib.pcg_barrier_chain.argtypes = [p, p, i, i, p]
        lib.pcg_barrier_chain.restype = i
        _lib = lib
    return _lib


def _check(name, t, shape, device):
    if t.device != device:
        raise ValueError(f"pcg_solve: {name} is on {t.device}, "
                         f"expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"pcg_solve: {name} is {t.dtype}, expected float32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"pcg_solve: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    t = t.contiguous()
    if t.data_ptr() % 16:
        t = t.clone()        # the kernel reads rows of S 16 bytes at a time
    return t


def _pcg_solve_cuda(S, rhs, Dinv, n_iters, x0):
    lib = load_kernel()
    dev = S.device
    D = S.shape[0]
    K = Dinv.shape[0]
    if D != 6 * K:
        raise ValueError(f"pcg_solve: D = {D} is not 6 * K = {6 * K}")
    S = _check("S_dense", S, (D, D), dev)
    rhs = _check("rhs_flat", rhs, (D,), dev)
    Dinv = _check("block_diag_inv", Dinv, (K, 6, 6), dev)
    if x0 is not None:
        x0 = _check("x0", x0, (D,), dev)
    x = torch.empty(D, dtype=torch.float32, device=dev)
    scratch = torch.empty(lib.pcg_scratch_floats(D), dtype=torch.float32,
                          device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.pcg_launch(S.data_ptr(), rhs.data_ptr(), Dinv.data_ptr(),
                             0 if x0 is None else x0.data_ptr(), x.data_ptr(),
                             scratch.data_ptr(), D, K, int(n_iters), stream)
    pcg_solve.launches += 1
    if err != 0:
        raise RuntimeError(f"pcg kernel launch failed: CUDA error {err}")
    return x
