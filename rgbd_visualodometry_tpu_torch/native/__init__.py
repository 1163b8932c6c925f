"""Native runtime components (C++): prefetching RGB-D dataset loader and
timestamp association, loaded via ctypes.

The port's own copy of ``rgbd_visualodometry_tpu/native`` (``src/`` is
byte-equal; ``tests/test_torch_tum.py`` holds the two together).  The
shared library is built with ``g++`` at first use into the package's
gitignored ``_build/`` directory, named by a hash of the source and the
flags, and written under a temporary name first, so processes that build
at once never load a half-written file.  ``available()`` reports whether
the toolchain and libpng are present, so callers can fall back to the
Python decoder (:mod:`rgbd_visualodometry_tpu_torch.io.png`);
``build_error()`` says why it is not.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading

import numpy as np

_SRC = pathlib.Path(__file__).resolve().parent / "src" / "dataloader.cpp"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")
_LOCK = threading.Lock()
_LIB = None
_ERROR: str | None = None  # why the build or load failed, once it has


def _lib_path() -> pathlib.Path:
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libvoloader_{h.hexdigest()[:16]}.so"


def _build() -> str:
    out = _lib_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(
            ["g++", *CXX_FLAGS, str(_SRC), "-lpng", "-lz", "-o", str(tmp)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed ({proc.returncode}): {proc.stderr.strip()[-2000:]}")
        os.replace(tmp, out)
    return str(out)


def _load():
    global _LIB, _ERROR
    with _LOCK:
        if _LIB is not None or _ERROR is not None:
            return _LIB
        try:
            lib = ctypes.CDLL(_build())
        except (OSError, RuntimeError) as e:  # no g++, no libpng, or an unloadable library
            _ERROR = str(e)
            return None
        lib.vo_loader_open.restype = ctypes.c_void_p
        lib.vo_loader_open.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.vo_loader_next.restype = ctypes.c_int
        lib.vo_loader_next.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint16),
            ctypes.c_int, ctypes.c_int,
        ]
        lib.vo_loader_close.restype = None
        lib.vo_loader_close.argtypes = [ctypes.c_void_p]
        lib.vo_associate.restype = ctypes.c_int
        lib.vo_associate.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int,
            ctypes.POINTER(ctypes.c_double), ctypes.c_int,
            ctypes.c_double, ctypes.c_double,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        _LIB = lib
        return _LIB


def available() -> bool:
    return _load() is not None


def build_error() -> str | None:
    """Why the native library is unavailable (None if it loaded or was not
    tried yet)."""
    _load()
    return _ERROR


class NativeLoader:
    """Prefetching decoder for (rgb, depth) PNG pairs, in order.

    Replaces the synchronous per-frame ``cv::imread`` pair of the reference
    main loop (``app/run_vo.cpp:91-92``) with background decode.
    """

    def __init__(self, rgb_paths, depth_paths, width: int, height: int,
                 prefetch: int = 8, workers: int = 4):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native loader unavailable: {_ERROR}")
        if len(rgb_paths) != len(depth_paths):
            raise ValueError(f"{len(rgb_paths)} rgb paths but {len(depth_paths)} depth paths")
        self._lib = lib
        self._n = len(rgb_paths)
        self._w, self._h = width, height
        enc_r = [p.encode() for p in rgb_paths]
        enc_d = [p.encode() for p in depth_paths]
        arr_r = (ctypes.c_char_p * self._n)(*enc_r)
        arr_d = (ctypes.c_char_p * self._n)(*enc_d)
        self._handle = lib.vo_loader_open(arr_r, arr_d, self._n, prefetch, workers)

    def __iter__(self):
        try:
            while True:
                rgb = np.empty((self._h, self._w, 3), np.uint8)
                depth = np.empty((self._h, self._w), np.uint16)
                idx = self._lib.vo_loader_next(
                    self._handle,
                    rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                    depth.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
                    self._w, self._h,
                )
                if idx == -1:
                    return
                if idx < 0:
                    raise IOError(f"native loader error code {idx}")
                yield idx, rgb, depth
        finally:
            self.close()

    def close(self):
        if self._handle:
            self._lib.vo_loader_close(self._handle)
            self._handle = None


def native_associate(first, second, offset: float = 0.0, max_difference: float = 0.02):
    """C++ version of the greedy timestamp association; same contract as
    :func:`rgbd_visualodometry_tpu_torch.io.tum.associate`."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_ERROR}")
    t1 = np.ascontiguousarray(list(first), np.float64)
    t2 = np.ascontiguousarray(list(second), np.float64)
    cap = min(len(t1), len(t2))
    out_i = np.empty(cap, np.int32)
    out_j = np.empty(cap, np.int32)
    n = lib.vo_associate(
        t1.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(t1),
        t2.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(t2),
        offset, max_difference,
        out_i.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        out_j.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
    )
    return [(int(out_i[k]), int(out_j[k])) for k in range(n)]
