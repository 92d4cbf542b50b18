"""Preconditioned conjugate gradients on the reduced camera system.

Counterpart of the JAX package's ``ba_kernels.pcg_solve_pallas``. Two
implementations of one function:

- the CUDA kernel ``csrc/pcg.cu`` (replaces the Pallas TPU kernel inside
  ``optim/ba_kernels.py::pcg_solve_pallas``): the whole fixed-length solve in
  one launch, for every D = 6K (no size above which it gives way to another
  solver). Two paths inside the C launcher, chosen by D alone: where S fits
  the shared memory of one thread-block cluster (8 blocks up to D = 660, the
  local BA's D = 384 among them; 16 blocks up to D = 924) it is loaded there
  once and the loop never touches global memory; larger D stream S from L2
  through a cooperative grid. See the
  source's header for what bounds each;
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


def cluster_rows(D: int, n_blocks: int):
    """Rows of S each block of the cluster path owns: [(first, end), ...],
    as csrc/pcg.cu deals them (the library's ``pcg_cluster_blocks(D)`` says
    how many blocks the launcher takes for a dimension, 0 for the grid path).

    The K = D / 6 poses are dealt in contiguous runs whose lengths differ by
    at most one (longer runs first), and a block owns all six rows of each of
    its poses, because the owner of a pose applies its 6x6 preconditioner
    block. Every row is owned exactly once; a block may own none."""
    if D <= 0 or D % 6:
        raise ValueError(f"D = {D} is not a positive multiple of 6")
    K = D // 6
    base, rem = divmod(K, n_blocks)
    first = [b * base + min(b, rem) for b in range(n_blocks + 1)]
    return [(6 * first[b], 6 * first[b + 1]) for b in range(n_blocks)]


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
        lib.pcg_launch_grid.argtypes = [p] * 6 + [i, i, i, p]
        lib.pcg_launch_grid_f32rows.argtypes = [p] * 6 + [i, i, i, p]
        lib.pcg_launch_cluster.argtypes = [p] * 5 + [i, i, i, i, p]
        lib.pcg_scratch_floats.argtypes = [i]
        lib.pcg_grid_blocks.argtypes = [i]
        lib.pcg_cluster_blocks.argtypes = [i]
        lib.pcg_cluster_smem_bytes.argtypes = [i, i]
        lib.pcg_barrier_chain.argtypes = [p, p, i, i, p]
        lib.pcg_barrier_chain_grid.argtypes = [p, p, i, i, p]
        lib.pcg_barrier_chain_cluster.argtypes = [p, i, i, p]
        for fn in (lib.pcg_launch, lib.pcg_launch_grid,
                   lib.pcg_launch_grid_f32rows, lib.pcg_launch_cluster,
                   lib.pcg_scratch_floats,
                   lib.pcg_grid_blocks, lib.pcg_cluster_blocks,
                   lib.pcg_barrier_chain, lib.pcg_barrier_chain_grid,
                   lib.pcg_barrier_chain_cluster):
            fn.restype = i
        lib.pcg_cluster_smem_bytes.restype = ctypes.c_longlong
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


def _bind_launch(S, rhs, Dinv, n_iters, x0, launch=None):
    """Check the inputs, allocate the output and return (run, x). run()
    launches the kernel on these buffers on the current stream and does
    nothing else, so a timing script can call it back to back; `launch`
    (such a script's choice) stands in for ``pcg_launch`` and takes the same
    arguments."""
    lib = load_kernel()
    launch = launch or lib.pcg_launch
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

    def run():
        with torch.cuda.device(dev):
            err = launch(S.data_ptr(), rhs.data_ptr(), Dinv.data_ptr(),
                         0 if x0 is None else x0.data_ptr(), x.data_ptr(),
                         scratch.data_ptr(), D, K, int(n_iters),
                         torch.cuda.current_stream().cuda_stream)
        pcg_solve.launches += 1
        if err != 0:
            raise RuntimeError(f"pcg kernel launch failed: CUDA error {err}")

    return run, x


def _pcg_solve_cuda(S, rhs, Dinv, n_iters, x0, launch=None):
    run, x = _bind_launch(S, rhs, Dinv, n_iters, x0, launch)
    run()
    return x
