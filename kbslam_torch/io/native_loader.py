"""ctypes binding for the native prefetching PNG frame loader: the port's
own copy of kbslam/io/native_loader.py, equal to it below this
docstring.

Builds native/libframeloader.so (at the repository root) on first use
with g++ and libpng; falls back to a PIL-based decoder with the same
interface when the toolchain or library is unavailable.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import List, Optional, Tuple

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_SO_PATH = os.path.abspath(os.path.join(_NATIVE_DIR, "build", "libframeloader.so"))

_lib = None


def _build_and_load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    try:
        if not os.path.exists(_SO_PATH):
            subprocess.run(["make", "-C", os.path.abspath(_NATIVE_DIR)],
                           check=True, capture_output=True)
        lib = ctypes.CDLL(_SO_PATH)
    except Exception:
        return None
    lib.fl_create.restype = ctypes.c_void_p
    lib.fl_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.fl_next.restype = ctypes.c_int
    lib.fl_next.argtypes = [ctypes.c_void_p,
                            ctypes.POINTER(ctypes.c_uint8),
                            ctypes.POINTER(ctypes.c_uint16)]
    lib.fl_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def native_available() -> bool:
    return _build_and_load() is not None


class NativeFrameLoader:
    """Ordered prefetching loader over (rgb_path, depth_path) lists."""

    def __init__(self, rgb_paths: List[str], depth_paths: List[str],
                 height: int, width: int, ring_capacity: int = 8,
                 n_threads: int = 2):
        assert len(rgb_paths) == len(depth_paths)
        self.h, self.w = height, width
        self.n = len(rgb_paths)
        self._lib = _build_and_load()
        self._i = 0
        if self._lib is not None:
            enc_r = [p.encode() for p in rgb_paths]
            enc_d = [p.encode() for p in depth_paths]
            arr_r = (ctypes.c_char_p * self.n)(*enc_r)
            arr_d = (ctypes.c_char_p * self.n)(*enc_d)
            self._fl = self._lib.fl_create(arr_r, arr_d, self.n, height, width,
                                           ring_capacity, n_threads)
        else:  # PIL fallback
            self._fl = None
            self._rgb_paths = rgb_paths
            self._depth_paths = depth_paths

    def next(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Returns (rgb [H,W,3] u8, depth [H,W] u16) or None at end."""
        if self._fl is not None:
            rgb = np.empty((self.h, self.w, 3), np.uint8)
            depth = np.empty((self.h, self.w), np.uint16)
            rc = self._lib.fl_next(
                self._fl,
                rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                depth.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
            )
            if rc == -1:
                return None
            if rc == -2:
                raise IOError("native frame decode failed")
            return rgb, depth
        if self._i >= self.n:
            return None
        from PIL import Image

        rgb = np.asarray(Image.open(self._rgb_paths[self._i]))[..., :3]
        depth = np.asarray(Image.open(self._depth_paths[self._i])).astype(np.uint16)
        self._i += 1
        return np.ascontiguousarray(rgb), depth

    def close(self):
        if self._fl is not None and self._lib is not None:
            self._lib.fl_destroy(self._fl)
            self._fl = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
