"""Replay a function of CUDA tensors from a captured CUDA graph, one per
shape: the port's counterpart of the JAX package's reuse of one compiled
executable per shape, for the relaxation's launch-heavy stages.

An eager stage of the relaxation issues thousands of small launches from
Python (the pose-graph solve's vmapped Jacobians, the Jacobi sweeps of
every Horn fit) and holds the interpreter lock for each; on the async
worker thread that starves the frame loop on the main thread.  A replay
is a few host calls.

:func:`replayed` calls ``fn(*args, **kw)``.  A key is the device, ``fn``,
the shapes and dtypes of ``args`` and the values of ``kw``.  The first
call at a key runs ``fn`` eagerly, so a one-off call (an offline relax)
costs what it did; the second captures a graph and replays it, and every
later call replays it.  Inside :func:`deferred` (the async relax worker)
a call at a key without a graph always runs eagerly and leaves the key to
:func:`capture_deferred`, which the thread that owns the worker calls once
the worker is done: no capture runs beside the frame loop, where a
device-wide synchronise on another thread would be refused.  For the
same reason no thread captures while another is inside :func:`deferred`:
a key whose second call falls there runs eagerly once more and is
captured at its next call after the worker.  ``fn`` must read its tensors only from ``args``, take no
decision on their values on the host and return a tensor or a tuple of
tensors; a replay returns clones of the captured outputs on the caller's
stream, equal to the eager call to the bit (``chip_smoke.py`` holds it).
The graphs live as long as the process, as a compile cache does.

Besides the relaxation's stages, the tracking step's pose rounds
(``ops.pnp.ransac_pnp``, ``ops.lm.refine_pose``) go through
:func:`maybe_replayed`: thousands of launches each, on every frame.  Under
``torch.func.vmap`` (``MultiStreamVO``'s step) a CUDA call goes on to the
vmap rule of :class:`_Vmapped`, which replays the vmapped body
(:func:`vmapped`) on the plain ``[S, ...]`` tensors below the vmap.

:func:`tally` sums the host-int counts each function's calls leave here:
``calls``, of which ``eager`` ran eagerly at a key without a graph,
``captures`` captured one and ``replays`` replayed one.
"""

from __future__ import annotations

import collections
import contextlib
import threading

import torch
from torch.utils import _pytree as pytree


def _warm(stream: torch.cuda.Stream) -> None:
    """Create this thread's cuBLAS and cuSOLVER handles and their workspace
    on ``stream`` before a capture there, which may not create them."""
    with torch.cuda.stream(stream):
        eye = torch.eye(2, device=stream.device)
        L, _ = torch.linalg.cholesky_ex(eye @ eye)
        torch.cholesky_solve(torch.bmm(eye[None], eye[None])[0], L)


class _Captured:
    """``fn`` at one key captured as one CUDA graph: its static inputs and
    outputs, and the event after the last caller read the outputs."""

    def __init__(self, fn, args, kw):
        dev = args[0].device
        cur = torch.cuda.current_stream(dev)
        self.inputs = [a.clone() for a in args]
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(cur)
        _warm(stream)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(stream):
            self.graph.capture_begin(capture_error_mode="thread_local")
            try:
                self.outputs = fn(*self.inputs, **kw)
            finally:
                self.graph.capture_end()
        cur.wait_stream(stream)
        self.read = cur.record_event()

    def __call__(self, args):
        cur = torch.cuda.current_stream(self.inputs[0].device)
        cur.wait_event(self.read)  # the last caller's replay and reads are done
        for static, a in zip(self.inputs, args):
            static.copy_(a)
        self.graph.replay()
        out = pytree.tree_map(torch.clone, self.outputs)
        self.read = cur.record_event()
        return out


_graphs: dict = {}  # key -> _Captured
_tallies: dict = collections.defaultdict(collections.Counter)  # body -> its calls' counts (module docstring)
_bodies: dict = {}  # a vmapped body (vmapped()) -> the body it vmaps
_vmapped: dict = {}  # (body, in_dims) -> torch.func.vmap(body, in_dims)
_seen: set = set()  # keys run eagerly once outside deferred()
_deferred: dict = {}  # key -> (fn, [(shape, dtype, device)], kw), run eagerly inside deferred()
_lock = threading.Lock()  # one capture at a time in a process, one caller at a time per graph
_local = threading.local()
_deferring = 0  # threads inside deferred(): no capture beside them


@contextlib.contextmanager
def deferred():
    """Calls of :func:`replayed` in this thread, at a key without a graph,
    run eagerly and leave the capture to :func:`capture_deferred`; no
    other thread captures until it ends."""
    global _deferring
    with _lock:  # a capture in progress elsewhere ends before this thread launches
        _deferring += 1
    _local.deferred = True
    try:
        yield
    finally:
        _local.deferred = False
        with _lock:
            _deferring -= 1


def replayed(fn, *args: torch.Tensor, **kw):
    """``fn(*args, **kw)`` on CUDA tensors: eager at a new key, captured at
    its second call, replayed from then on (module docstring)."""
    key = (fn, args[0].device, tuple((a.shape, a.dtype) for a in args), tuple(sorted(kw.items())))
    with _lock:
        counts = _tallies[_bodies.get(fn, fn)]
        counts["calls"] += 1
        if key not in _graphs:
            if getattr(_local, "deferred", False):
                _deferred.setdefault(key, (fn, [(a.shape, a.dtype, a.device) for a in args], kw))
            elif key in _seen and not _deferring:
                _graphs[key] = _Captured(fn, args, kw)
                counts["captures"] += 1
                return _graphs[key](args)
            else:
                _seen.add(key)
        if key in _graphs:
            counts["replays"] += 1
            return _graphs[key](args)
        counts["eager"] += 1
    return fn(*args, **kw)


def _eager(fn, args, kw):
    """``fn(*args, **kw)``, counted as an eager call of its body."""
    with _lock:
        counts = _tallies[_bodies.get(fn, fn)]
        counts["calls"] += 1
        counts["eager"] += 1
    return fn(*args, **kw)


def _batched(a: torch.Tensor) -> bool:
    return torch._C._functorch.is_batchedtensor(a)


def maybe_replayed(fn, *args: torch.Tensor, **kw):
    """``fn(*args, **kw)``, from a captured graph where every tensor of
    ``args`` is a CUDA tensor: :func:`replayed`, or under ``torch.func.vmap``
    the vmapped body replayed below the vmap (:class:`_Vmapped`).  On other
    devices ``fn`` runs eagerly."""
    if not all(a.is_cuda for a in args):
        return _eager(fn, args, kw)
    if any(_batched(a) for a in args):
        return _Vmapped.apply(fn, kw, *args)
    return replayed(fn, *args, **kw)


def vmapped(fn, in_dims: tuple):
    """``torch.func.vmap(fn, in_dims=in_dims)``, one object per key, so that
    :func:`replayed` keys its graphs on it."""
    key = (fn, in_dims)
    with _lock:
        if key not in _vmapped:
            _vmapped[key] = vfn = torch.func.vmap(fn, in_dims=in_dims)
            _bodies[vfn] = fn
        return _vmapped[key]


class _Vmapped(torch.autograd.Function):
    """``fn(*args, **kw)`` called under ``torch.func.vmap``.  Its vmap rule
    receives the tensors of the level below, ``[S, ...]`` at their
    ``in_dims``, and runs :func:`vmapped` ``(fn, in_dims)`` on them: from a
    captured graph (:func:`replayed`) where they are plain CUDA tensors,
    else eagerly (still batched: a vmap inside another; or not on CUDA).
    Its outputs are batched at dimension 0."""

    @staticmethod
    def forward(fn, kw, *args):
        return fn(*args, **kw)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, fn, kw, *args):
        vfn = vmapped(fn, tuple(in_dims[2:]))
        if all(a.is_cuda and not _batched(a) for a in args):
            return replayed(vfn, *args, **kw), 0
        return _eager(vfn, args, kw), 0


def tally(*fns) -> collections.Counter:
    """The counts (module docstring) of the calls of ``fns`` so far in this
    process, their vmapped bodies' included, summed: host ints."""
    with _lock:
        return sum((_tallies[fn] for fn in fns), collections.Counter())


def capture_deferred() -> None:
    """Capture the graphs of the keys that ran eagerly inside
    :func:`deferred`, on this thread (its inputs are placeholders: a
    capture reads no values)."""
    with _lock:
        pending = list(_deferred.items())
        _deferred.clear()
        for key, (fn, specs, kw) in pending:
            if key not in _graphs:
                _graphs[key] = _Captured(fn, [torch.zeros(s, dtype=d, device=dev) for s, d, dev in specs], kw)
