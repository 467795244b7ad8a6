"""The native PNG decoder and frame prefetcher (`native/data_loader.cpp`),
bound with ctypes (counterpart of `qsp_slam_tpu/data/native_loader.py`).

The library is compiled at first use with the host C++ compiler (`$CXX`,
else `g++`) into `_build/libqsp_loader-<hash of the source>.so` inside
this package, so an edited source never loads a stale build; a compiler
that is missing or fails raises.  The decoder declines PNG features it
does not implement (palette, Adam7) by returning None, and only then do
callers read that file with PIL, whose gray conversion it matches bit for
bit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "data_loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
MAX_PIXELS = 2048 * 1536  # covers TUM 640x480 and KITTI 1242x376

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def shared_library(source: Path, stem: str, libs: tuple = ()) -> Path:
    """The path of `source` compiled into `_build/lib<stem>-<hash>.so`,
    compiled first (portable flags, `$CXX` or `g++`) if it is not there.
    Raises when the compiler fails."""
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:12]
    out = BUILD_DIR / f"lib{stem}-{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp), str(source), *libs]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building {source.name} failed:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded decoder library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(shared_library(SOURCE, "qsp_loader", ("-lz", "-lpthread"))))
            f_p, i_p = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)
            lib.ql_load_png.restype = ctypes.c_int
            lib.ql_load_png.argtypes = [ctypes.c_char_p, ctypes.c_float, f_p, ctypes.c_int, i_p, i_p]
            lib.ql_pool_create.restype = ctypes.c_void_p
            lib.ql_pool_create.argtypes = [ctypes.c_int, ctypes.c_int]
            lib.ql_pool_destroy.restype = None
            lib.ql_pool_destroy.argtypes = [ctypes.c_void_p]
            lib.ql_pool_submit.restype = None
            lib.ql_pool_submit.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p,
                                           ctypes.c_char_p, ctypes.c_float]
            lib.ql_pool_wait.restype = ctypes.c_int
            lib.ql_pool_wait.argtypes = [ctypes.c_void_p, ctypes.c_int64, f_p, f_p, i_p, i_p, ctypes.c_int]
            _lib = lib
        return _lib


def load_png(path: str, scale: float = 1.0) -> Optional[np.ndarray]:
    """Decode a PNG to float32 gray (RGB by PIL's integer luminance
    formula), times `scale`; None when the decoder declines the file."""
    lib = library()
    buf = np.empty(MAX_PIXELS, np.float32)
    w, h = ctypes.c_int(0), ctypes.c_int(0)
    rc = lib.ql_load_png(path.encode(), ctypes.c_float(scale),
                         buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), MAX_PIXELS,
                         ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        return None
    return buf[: w.value * h.value].reshape(h.value, w.value).copy()


class FramePrefetcher:
    """Decodes (gray, depth) frame pairs on the library's worker pool, up to
    `lookahead` frames ahead of the consumer.  `get(pos)` takes positions
    in order and returns None where the decoder declined a file."""

    def __init__(self, pairs: list[tuple[str, str]], depth_scale: float,
                 threads: int = 2, lookahead: int = 4):
        self._lib = library()
        self.pairs = pairs
        self.depth_scale = depth_scale
        self.lookahead = lookahead
        self._submitted = 0
        self._gray = np.empty(MAX_PIXELS, np.float32)
        self._depth = np.empty(MAX_PIXELS, np.float32)
        self._pool = self._lib.ql_pool_create(threads, MAX_PIXELS)
        self._fill(0)

    def _fill(self, upto: int) -> None:
        while self._submitted < len(self.pairs) and self._submitted <= upto + self.lookahead:
            rgb, dep = self.pairs[self._submitted]
            self._lib.ql_pool_submit(self._pool, self._submitted, rgb.encode(), dep.encode(),
                                     ctypes.c_float(self.depth_scale))
            self._submitted += 1

    def get(self, pos: int):
        if self._pool is None:
            raise RuntimeError("FramePrefetcher is closed")
        self._fill(pos)
        if pos >= self._submitted:
            return None
        fp = ctypes.POINTER(ctypes.c_float)
        w, h = ctypes.c_int(0), ctypes.c_int(0)
        rc = self._lib.ql_pool_wait(self._pool, pos, self._gray.ctypes.data_as(fp),
                                    self._depth.ctypes.data_as(fp), ctypes.byref(w),
                                    ctypes.byref(h), MAX_PIXELS)
        self._fill(pos + 1)
        if rc != 0:
            return None
        n = w.value * h.value
        return (self._gray[:n].reshape(h.value, w.value).copy(),
                self._depth[:n].reshape(h.value, w.value).copy())

    def close(self) -> None:
        if self._pool is not None:
            self._lib.ql_pool_destroy(self._pool)
            self._pool = None
