"""Build, binding and launch counters of the port's hand-written CUDA kernels.

The sources in ``rgbd_visualodometry_tpu_torch/csrc/*.cu`` are compiled at
first use by ``nvcc`` for ``sm_90a`` - one ``nvcc`` per source, all started
together, then one link - into one shared library with a plain C
interface, under ``rgbd_visualodometry_tpu_torch/_build/`` (named by a hash
of the sources, so an edited source is rebuilt), and loaded with ctypes.
Pointers and the current CUDA stream pass as ``c_void_p``.  Every C entry
point returns ``cudaGetLastError()`` after its launch; a nonzero code
raises.  Nothing here is imported or built until a kernel is launched on a
CUDA tensor, so the package imports on machines without CUDA.

Each :class:`Kernel` counts its launches in ``launches``: the one place the
count grows is :meth:`Kernel.launch`, right after the launch succeeded.

K1 and K2 take a leading stream axis, and their wrappers are
``torch.library`` custom ops whose vmap rule folds the vmapped axis into it
(:func:`fold_streams`), so ``torch.func.vmap`` over S streams makes one
launch where a loop would make S (``parallel/mesh.py``).
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
    "-Xcompiler", "-fPIC",
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
            nvcc = _nvcc()
            objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in _sources()]
            compiles = []
            for src, obj in zip(_sources(), objs):
                cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                if verbose:
                    cmd.insert(1, "--ptxas-options=-v")
                compiles.append(subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            logs = [(proc.communicate()[0], proc.returncode) for proc in compiles]
            link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
                                  capture_output=True, text=True) if all(rc == 0 for _, rc in logs) else None
            for obj in objs:
                obj.unlink(missing_ok=True)
            failed = [(out, rc) for out, rc in logs if rc != 0]
            if link is not None and link.returncode != 0:
                failed.append((link.stdout + link.stderr, link.returncode))
            if failed:
                raise RuntimeError("nvcc failed:\n" + "\n".join(f"({rc}) {out}" for out, rc in failed))
            if verbose:
                print("".join(out for out, _ in logs))
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
        self._fn = None  # the bound C entry point, once the library is loaded

    def launch(self, *args) -> None:
        """Launch on the current stream; tensors pass as their data pointers."""
        import torch

        fn = self._fn
        if fn is None:  # first launch: build and bind (under the lock)
            build()
            fn = self._fn = getattr(_lib, self.symbol)
        conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
        conv.append(torch.cuda.current_stream().cuda_stream)
        err = fn(*conv)
        if err != 0:
            msg = _lib.rgbdvo_error_string(err).decode()
            raise RuntimeError(f"kernel {self.name} failed to launch: {msg} ({err})")
        self.launches += 1


_P = ctypes.c_void_p
_I = ctypes.c_int

FAST_NMS = Kernel(
    "fast_nms", "rgbdvo_fast_nms_pyramid", [_P, _I, _I, _P],
    source="rgbd_visualodometry_tpu_torch/csrc/fast_nms.cu",
    replaces="rgbd_visualodometry_tpu/ops/pallas_fast.py:30",
)
HAMMING_NN = Kernel(
    "hamming_nn", "rgbdvo_hamming_nn", [_P, _P, _P, _I, _I, _I, _P, _P, _P],
    source="rgbd_visualodometry_tpu_torch/csrc/hamming_nn.cu",
    replaces="rgbd_visualodometry_tpu/ops/pallas_match.py:152",
)
HAMMING_MATRIX = Kernel(
    "hamming_matrix", "rgbdvo_hamming_matrix", [_P, _P, _I, _I, _P, _P],
    source="rgbd_visualodometry_tpu_torch/csrc/hamming_nn.cu",
    replaces="rgbd_visualodometry_tpu/ops/pallas_match.py:64",
)
KERNELS = (FAST_NMS, HAMMING_NN, HAMMING_MATRIX)


def fold_streams(x, dim, batch_size: int):
    """A vmap rule's input -> the kernel's stream axis: the vmapped axis
    ``dim`` (None: an unbatched input, expanded) moved in front of the
    input's own leading stream axis and merged with it, ``[B * S, ...]``."""
    x = x.expand(batch_size, *x.shape) if dim is None else x.movedim(dim, 0)
    return x.reshape(-1, *x.shape[2:])


def reset_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def counts() -> dict[str, int]:
    return {k.name: k.launches for k in KERNELS}
