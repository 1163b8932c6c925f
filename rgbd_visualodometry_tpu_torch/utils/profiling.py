"""The program's own trace spans, and torch.profiler traces.

Counterpart of ``rgbd_visualodometry_tpu/utils/profiling.py``.  Replaces the
reference's ``boost::timer::cpu_timer`` per-frame print
(``app/run_vo.cpp:104-109``) with:

- :func:`span` and :func:`spanned` - the named ranges ``vo.*`` that the
  program opens where each layer's work runs (``vo.step``, ``vo.orb``,
  ``vo.pose_round``, ``vo.ba``, ...).  While a torch profiler records on
  this thread (``torch.profiler.profile``, ``emit_nvtx``), a span is a
  range in its trace, on the same clock as the device's operations; at
  any other time it costs one check.  A span never synchronises;
- :func:`torch_trace` - a context manager around ``torch.profiler``
  writing a Chrome/Perfetto trace (``trace.json``) that holds those spans,
  the host ops and, with CUDA, the device's kernels.
"""

from __future__ import annotations

import contextlib
import functools
import os

import torch
from torch._C._profiler import _RecordFunctionFast

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager: while a torch profiler records, a range named
    ``name`` in its trace; else one shared null context.

    The range is a function-scope record (a ``cpu_op`` in the trace, as an
    aten op is), not a ``record_function`` user annotation: the profiler
    mirrors the innermost user annotation around each kernel onto the
    device's timeline, so a user annotation here would re-label the device
    timeline of any tool that annotates its own calls into the program."""
    if torch.autograd._profiler_enabled():
        return _RecordFunctionFast(name)
    return _OFF


def spanned(name: str):
    """Decorator: the function's whole call is the span ``name``."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return inner

    return wrap


@contextlib.contextmanager
def torch_trace(out_dir: str):
    """Profile the block with ``torch.profiler`` (host ops and the
    program's spans, and device kernels when CUDA is available) and write
    ``out_dir/trace.json`` on exit; yields that path."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "trace.json")
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)
