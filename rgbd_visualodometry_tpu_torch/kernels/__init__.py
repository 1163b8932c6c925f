"""Build, binding and launch counters of the port's hand-written CUDA kernels.

The sources in ``rgbd_visualodometry_tpu_torch/csrc/*.cu`` are compiled at
first use by ``nvcc`` for ``sm_90a`` into one shared library with a plain C
interface, under ``rgbd_visualodometry_tpu_torch/_build/`` (named by a hash
of the sources, so an edited source is rebuilt), and loaded with ctypes.
Pointers and the current CUDA stream pass as ``c_void_p``.  Every C entry
point returns ``cudaGetLastError()`` after its launch; a nonzero code
raises.  Nothing here is imported or built until a kernel is launched on a
CUDA tensor, so the package imports on machines without CUDA.

Each :class:`Kernel` counts its launches in ``launches``: the one place the
count grows is :meth:`Kernel.launch`, right after the launch succeeded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of the build in this process (None: not built)


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    for cand in (
        os.environ.get("NVCC"),
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or NVCC to build the kernels")


def library_path() -> pathlib.Path:
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"librgbdvo_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> pathlib.Path:
    """Compile the kernels (if this source set was not built yet) and load
    the library.  Returns its path."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return pathlib.Path(_lib._name)
        t0 = time.perf_counter()
        path = library_path()
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
            if verbose:
                cmd.insert(1, "--ptxas-options=-v")
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
            if verbose:
                print(proc.stdout + proc.stderr)
            os.replace(tmp, path)
        lib = ctypes.CDLL(str(path))
        for k in KERNELS:
            fn = getattr(lib, k.symbol)
            fn.argtypes = k.argtypes
            fn.restype = ctypes.c_int
        lib.rgbdvo_error_string.argtypes = [ctypes.c_int]
        lib.rgbdvo_error_string.restype = ctypes.c_char_p
        _lib = lib
        build_seconds = time.perf_counter() - t0
        return path


class Kernel:
    """One C entry point of the library and its launch count."""

    def __init__(self, name: str, symbol: str, argtypes, source: str, replaces: str):
        self.name = name
        self.symbol = symbol
        self.argtypes = argtypes
        self.source = source
        self.replaces = replaces
        self.launches = 0

    def launch(self, *args) -> None:
        """Launch on the current stream; tensors pass as their data pointers."""
        import torch

        build()
        conv = []
        for a in args:
            conv.append(a.data_ptr() if isinstance(a, torch.Tensor) else a)
        conv.append(torch.cuda.current_stream().cuda_stream)
        err = getattr(_lib, self.symbol)(*conv)
        if err != 0:
            msg = _lib.rgbdvo_error_string(err).decode()
            raise RuntimeError(f"kernel {self.name} failed to launch: {msg} ({err})")
        self.launches += 1


_P = ctypes.c_void_p
_I = ctypes.c_int

FAST_NMS = Kernel(
    "fast_nms", "rgbdvo_fast_nms", [_P, _P, _I, _I, _P],
    source="rgbd_visualodometry_tpu_torch/csrc/fast_nms.cu",
    replaces="rgbd_visualodometry_tpu/ops/pallas_fast.py:30",
)
HAMMING_NN = Kernel(
    "hamming_nn", "rgbdvo_hamming_nn", [_P, _P, _P, _I, _I, _P, _P, _P],
    source="rgbd_visualodometry_tpu_torch/csrc/hamming_nn.cu",
    replaces="rgbd_visualodometry_tpu/ops/pallas_match.py:152",
)
HAMMING_MATRIX = Kernel(
    "hamming_matrix", "rgbdvo_hamming_matrix", [_P, _P, _I, _I, _P, _P],
    source="rgbd_visualodometry_tpu_torch/csrc/hamming_nn.cu",
    replaces="rgbd_visualodometry_tpu/ops/pallas_match.py:64",
)
KERNELS = (FAST_NMS, HAMMING_NN, HAMMING_MATRIX)


def reset_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def counts() -> dict[str, int]:
    return {k.name: k.launches for k in KERNELS}
