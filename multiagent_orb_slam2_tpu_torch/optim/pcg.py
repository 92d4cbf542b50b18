"""Preconditioned conjugate gradients on the reduced camera system.

Counterpart of the JAX package's ``ba_kernels.pcg_solve_pallas``. Two
implementations of one function:

- the CUDA kernel ``csrc/pcg.cu`` (replaces the Pallas TPU kernel inside
  ``optim/ba_kernels.py::pcg_solve_pallas``): the whole fixed-length solve on
  the device with no host read, for every D = 6K. It solves only the poses
  the solve moves: one pass over S lists the live poses (a pose is inert
  where its rows of S are zero outside its own 6x6 block and its block of
  r0 = rhs - S x0 is zero; ``live_poses`` is that test in plain PyTorch), and
  the live system S[live, live] takes the path its dimension DL selects,
  decided on the device: a thread-block cluster that holds it in shared
  memory (DL <= 924; 600 where D > 924), a cooperative grid that holds it in the shared memory
  of all SMs (``pcg_resident_cap``), or that grid streaming the live rows
  from L2. Rows of S p are summed in float64 where the full D exceeds 924,
  in float32 below. See the source's header;
- ``ba_kernels.pcg_solve``, the plain PyTorch version (``_pcg_solve_plain``
  here), on the whole system.

``pcg_solve`` dispatches on the matrix's device only: a CUDA tensor goes to
the kernel (or raises), a CPU tensor to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from ..utils.torch_ops import first_true_indices
from .ba_kernels import pcg_solve as _pcg_solve_plain

# D from which the kernel sums every row of S p in float64 (the plain
# version's rows_f64), whatever path the live system takes
ROWS_F64_FROM = 925


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
    """Rows of a system of dimension D (all poses, or the live ones) each
    block of the cluster path owns: [(first, end), ...], as csrc/pcg.cu deals
    them (the library's ``pcg_cluster_blocks(D)`` says how many blocks such a
    system needs, 0 where it is too large for the cluster path, and
    ``pcg_live_cluster_blocks`` how many a solve puts to work on it).

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


def live_poses(S_dense, rhs_flat, block_diag_inv, x0=None):
    """The poses a solve of S x = rhs moves, as the kernel lists them:
    (poses [K] int32, the live poses ascending and then zeros; count [1]
    int32). Pose k is inert where its six rows of S are exactly zero outside
    its own 6x6 diagonal block and its block of r0 = rhs - S x0 (r0 = rhs
    without a warm start; each row of S x0 summed in float64 and rounded
    once where D > 924, as the kernel does) is exactly zero; every other
    pose is live. block_diag_inv gives K only: the test is on S and r0."""
    K = block_diag_inv.shape[0]
    D = 6 * K
    pose = torch.arange(D, device=S_dense.device) // 6
    coupled = ((S_dense != 0) & (pose[:, None] != pose[None, :])).any(dim=1)
    r0 = rhs_flat
    if x0 is not None:
        if D >= ROWS_F64_FROM:
            r0 = rhs_flat - (S_dense.double() @ x0.double()).float()
        else:
            r0 = rhs_flat - S_dense @ x0
    live = (coupled | (r0 != 0)).reshape(K, 6).any(dim=1)
    return (first_true_indices(live, K, 0).to(torch.int32),
            live.sum(dtype=torch.int32).reshape(1))


def scratch_live(scratch, D: int):
    """(poses [K] int32, count [1] int32): the live list a kernel launch left
    in its scratch (``_bind_launch``'s ``run.scratch``), as views."""
    at = load_kernel().pcg_live_offset(D)
    K = D // 6
    ints = scratch[at:at + K + 1].view(torch.int32)
    return ints[:K], ints[K:K + 1]


PATHS = {0: "none", 1: "cluster", 2: "resident", 3: "stream"}


def path_of(D: int, DL: int) -> str:
    """The path a live system of dimension DL takes in a kernel solve of
    dimension D: "none" (DL = 0: x = x0), "cluster", "resident" (the grid
    holding the live rows in shared memory) or "stream" (the grid streaming
    them from L2)."""
    code = load_kernel().pcg_path(D, DL)
    if code not in PATHS:
        raise RuntimeError(f"pcg_path({D}, {DL}) failed: {code}")
    return PATHS[code]


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
        lib.pcg_launch_live.argtypes = [p] * 6 + [i, i, i, i, i, p]
        lib.pcg_launch_grid.argtypes = [p] * 6 + [i, i, i, p]
        lib.pcg_launch_grid_f32rows.argtypes = [p] * 6 + [i, i, i, p]
        lib.pcg_launch_cluster.argtypes = [p] * 5 + [i, i, i, i, p]
        lib.pcg_scratch_floats.argtypes = [i]
        lib.pcg_live_offset.argtypes = [i]
        lib.pcg_grid_blocks.argtypes = [i]
        lib.pcg_resident_blocks.argtypes = []
        lib.pcg_resident_cap.argtypes = [i]
        lib.pcg_cluster_blocks.argtypes = [i]
        lib.pcg_live_cluster_blocks.argtypes = [i, i]
        lib.pcg_cluster_smem_bytes.argtypes = [i, i]
        lib.pcg_path.argtypes = [i, i]
        lib.pcg_barrier_chain_grid.argtypes = [p, p, i, i, p]
        lib.pcg_barrier_chain_resident.argtypes = [p, p, i, i, p]
        lib.pcg_barrier_chain_cluster.argtypes = [p, i, i, p]
        for fn in (lib.pcg_launch, lib.pcg_launch_live, lib.pcg_launch_grid,
                   lib.pcg_launch_grid_f32rows, lib.pcg_launch_cluster,
                   lib.pcg_scratch_floats, lib.pcg_live_offset,
                   lib.pcg_grid_blocks, lib.pcg_resident_blocks,
                   lib.pcg_resident_cap, lib.pcg_cluster_blocks,
                   lib.pcg_live_cluster_blocks,
                   lib.pcg_path,
                   lib.pcg_barrier_chain_grid,
                   lib.pcg_barrier_chain_resident,
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
    arguments. run.scratch is the launch's scratch (``scratch_live`` reads
    the live list a launch left there)."""
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

    run.scratch = scratch
    return run, x


def _pcg_solve_cuda(S, rhs, Dinv, n_iters, x0, launch=None):
    run, x = _bind_launch(S, rhs, Dinv, n_iters, x0, launch)
    run()
    return x
