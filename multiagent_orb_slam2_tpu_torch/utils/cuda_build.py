"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and becomes one shared
library ``build/<name>_<hash>.so`` at the repository root, where <hash>
covers the source text, the headers beside it (``csrc/*.cuh``) and the
compiler flags (``NVCC_FLAGS`` and the source's own ``SOURCE_FLAGS``), so
an edit rebuilds. The build
happens at first use and never falls back: a failure raises with nvcc's
output. Several sources are compiled by concurrent nvcc processes.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# The Schur preparation rounds as its plain version's tensor ops do, which
# never fuse a multiply into an add: where float32 leaves a residual or a
# damped 3x3 inverse mostly rounding (a point a decimetre from a camera far
# from the origin, a point seen once), the kernel and its plain version
# still agree.
SOURCE_FLAGS = {"ba_prep": ("-fmad=false",)}

_loaded: dict[str, ctypes.CDLL] = {}
build_seconds: dict[str, float] = {}
build_logs: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels of this package "
                       "are compiled at first use and need the CUDA toolkit")


def _target(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    flags = " ".join(NVCC_FLAGS + SOURCE_FLAGS.get(name, ()))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + flags.encode()).hexdigest()[:16]
    return src, BUILD_DIR / f"{name}_{digest}.so"


def load_libraries(names) -> dict[str, ctypes.CDLL]:
    """Build (all missing ones at once) and load the named kernels."""
    pending = []
    for name in names:
        if name in _loaded:
            continue
        src, lib = _target(name)
        proc = None
        if not lib.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib.with_suffix(f".{os.getpid()}.tmp.so")
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, *SOURCE_FLAGS.get(name, ()), "-o",
                 str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        pending.append((name, lib, proc, time.perf_counter()))
    for name, lib, proc, t0 in pending:
        if proc is not None:
            out, _ = proc.communicate()
            build_seconds[name] = time.perf_counter() - t0
            build_logs[name] = out
            tmp = lib.with_suffix(f".{os.getpid()}.tmp.so")
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on csrc/{name}.cu (exit {proc.returncode}):"
                    f"\n{out}")
            os.replace(tmp, lib)
        _loaded[name] = ctypes.CDLL(str(lib))
    return {n: _loaded[n] for n in names}


def load_library(name: str) -> ctypes.CDLL:
    return load_libraries([name])[name]
