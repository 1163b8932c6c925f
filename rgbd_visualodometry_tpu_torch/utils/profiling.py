"""Per-stage wall timing and torch.profiler traces.

Counterpart of ``rgbd_visualodometry_tpu/utils/profiling.py``.  Replaces the
reference's ``boost::timer::cpu_timer`` per-frame print
(``app/run_vo.cpp:104-109``) with:

- :class:`StageTimer` - named wall-clock sections that wait for the CUDA
  device (``torch.cuda.synchronize``, where the JAX package calls
  ``jax.block_until_ready``) when the stage's result holds a CUDA tensor,
  so the numbers mean device time and not launch latency; on the CPU a
  stage only reads the clock;
- :func:`torch_trace` - a context manager around ``torch.profiler``
  writing a Chrome/perfetto trace (``trace.json``) for op-level analysis.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch
from torch.utils import _pytree as pytree


def _sync(target) -> None:
    devices = {x.device for x in pytree.tree_leaves(target) if isinstance(x, torch.Tensor) and x.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)


class StageTimer:
    """Accumulate wall time per named stage.

    Usage::

        t = StageTimer()
        with t.stage("track") as h:
            h["result"] = step(...)  # waited for on exit
        print(t.summary())
    """

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, block_on=None):
        t0 = time.perf_counter()
        holder = {}
        try:
            yield holder
        finally:
            target = holder.get("result", block_on)
            if target is not None:
                _sync(target)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name}: {total * 1e3:.1f} ms total, {total / n * 1e3:.2f} ms/call (n={n})")
        return "\n".join(lines)


@contextlib.contextmanager
def torch_trace(out_dir: str):
    """Profile the block with ``torch.profiler`` (host ops, and device
    kernels when CUDA is available) and write ``out_dir/trace.json`` on
    exit; yields that path."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "trace.json")
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)
