"""ctypes binding for the native prefetching frame loader (native/loader.cc).

Counterpart of the JAX package's ``io/native_loader.py``, over the same
library, ``native/libframeloader.so`` at the repository root (``make -C
native``). Worker threads decode images ahead of the tracker; frames arrive
in order through a bounded queue. Where the library has not been built the
loader decodes each frame with cv2 when it is asked for (host image
decoding, as in the JAX package).
"""
from __future__ import annotations

import ctypes
import os
from typing import List, Optional

import numpy as np

_LIB_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                         "..", "native", "libframeloader.so")
_lib = None


def _load_lib():
    global _lib
    if _lib is None and os.path.exists(_LIB_PATH):
        lib = ctypes.CDLL(_LIB_PATH)
        lib.loader_create.restype = ctypes.c_void_p
        lib.loader_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64, ctypes.c_int,
            ctypes.c_int64, ctypes.c_float]
        lib.loader_next.restype = ctypes.c_int64
        lib.loader_next.argtypes = [
            ctypes.c_void_p,
            np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS"),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32)]
        lib.loader_destroy.restype = None
        lib.loader_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


def available() -> bool:
    return _load_lib() is not None


class PrefetchLoader:
    """In-order frame stream with background native decode.

    depth_scale > 0 reads 16-bit depth images and divides them by it
    (metres for a TUM factor of 5000); else grayscale images (0..255)."""

    def __init__(self, paths: List[str], n_threads: int = 2,
                 queue_cap: int = 8, depth_scale: float = 0.0,
                 max_pixels: int = 4096 * 4096):
        self.paths = list(paths)
        self._buf = np.empty(max_pixels, np.float32)
        self._depth_scale = depth_scale
        self._lib = _load_lib()
        self._h = None
        self._i = 0
        if self._lib is not None:
            arr = (ctypes.c_char_p * len(self.paths))(
                *[p.encode() for p in self.paths])
            self._h = self._lib.loader_create(arr, len(self.paths),
                                              n_threads, queue_cap,
                                              depth_scale)

    def next(self) -> Optional[np.ndarray]:
        """Next frame as float32 [H, W], or None at end of sequence."""
        if self._lib is not None:
            h = ctypes.c_int32()
            w = ctypes.c_int32()
            n = self._lib.loader_next(self._h, self._buf, len(self._buf),
                                      ctypes.byref(h), ctypes.byref(w))
            if n == -1:
                return None
            if n < 0:
                raise IOError(f"native loader error {n}")
            return self._buf[:n].reshape(h.value, w.value).copy()
        # no native library: decode this frame now
        if self._i >= len(self.paths):
            return None
        import cv2
        p = self.paths[self._i]
        self._i += 1
        depth = self._depth_scale > 0
        img = cv2.imread(p, cv2.IMREAD_UNCHANGED if depth
                         else cv2.IMREAD_GRAYSCALE)
        if img is None:
            raise FileNotFoundError(p)
        img = img.astype(np.float32)
        return img / self._depth_scale if depth else img

    def close(self):
        if self._lib is not None and self._h:
            self._lib.loader_destroy(self._h)
            self._h = None

    def __del__(self):
        if getattr(self, "_h", None):
            self.close()
