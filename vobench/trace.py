"""The traced window: spans around the program's functions, the profiler, and
the reduction of its events to what the per-layer readers read.

A span is a ``torch.profiler.record_function`` range named
``vobench.<span>`` that :class:`Spans` puts around a function of the port by
replacing the module attribute the port calls it through (for instance
``rgbd_visualodometry_tpu_torch.ops.orb.extract``).  Which spans exist is
data: each per-layer reader (``vobench/metrics/<metric>.py``) names the
spans it reads in its ``SPANS``.  A span does not synchronise.  Its stage
time runs from its start on the host to the later of its end on the host
and the end of the last device operation launched inside it (the
profiler's host and device events share one clock), so a stage reads the
same work whether it is bound by its launches or by the device.
"""

from __future__ import annotations

import bisect
import dataclasses
import importlib

import numpy as np
import torch

PREFIX = "vobench."
WINDOW = PREFIX + "window"
ENTRY = PREFIX + "entry"
# runtime calls that launch work on the device (a graph launch counts one)
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaLaunchCooperativeKernel", "cudaGraphLaunch", "cuGraphLaunch")


class Spans:
    """``record_function`` ranges around functions of the program.

    ``targets`` maps a span name to ``(module, attribute)`` or ``(module,
    attribute, facts)``, where ``facts(args, kwargs)`` returns a small dict
    of host-side facts about the call (its shapes), kept in call order for
    the calls made while :attr:`recording`."""

    def __init__(self, targets: dict):
        self.targets = targets
        self.facts = {name: [] for name in targets}
        self.recording = False
        self._saved = []

    def install(self) -> None:
        for name, target in self.targets.items():
            mod = importlib.import_module(target[0])
            orig = getattr(mod, target[1])
            facts = target[2] if len(target) > 2 else None
            setattr(mod, target[1], self._wrap(name, orig, facts))
            self._saved.append((mod, target[1], orig))

    def _wrap(self, name, orig, facts):
        label = PREFIX + name

        def wrapper(*args, **kwargs):
            if self.recording and facts is not None:
                self.facts[name].append(facts(args, kwargs))
            with torch.profiler.record_function(label):
                return orig(*args, **kwargs)

        return wrapper

    def restore(self) -> None:
        for mod, attr, orig in reversed(self._saved):
            setattr(mod, attr, orig)
        self._saved.clear()


@dataclasses.dataclass
class Span:
    host_s: float  # the span's own host duration
    stage_s: float  # start to the later of its end and its last launched device op's end
    device_s: float  # summed durations of the device ops launched inside it
    facts: dict


@dataclasses.dataclass
class TraceData:
    steps: int  # entry calls in the traced window
    window_s: float
    busy_s: float  # union of the device ops' intervals inside the window
    spans: dict  # span name -> [Span] in call order
    launch_calls: int
    kernel_counts: dict  # device kernel name -> count
    breakdown: dict


def _union(starts: np.ndarray, ends: np.ndarray):
    """Merged ``[start, end)`` intervals of a set of intervals."""
    if starts.size == 0:
        return starts, ends
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], np.maximum.accumulate(ends[order])
    new = np.ones(s.size, bool)
    new[1:] = s[1:] > e[:-1]
    idx = np.flatnonzero(new)
    return s[idx], np.append(e[idx[1:] - 1], e[-1])


def reduce(events, facts: dict) -> TraceData:
    """The profiler's events of one traced window -> :class:`TraceData`."""
    ann, cpu, rt, dev = [], [], [], []
    cuda = torch.autograd.DeviceType.CUDA
    for e in events:
        name = e.name()
        if e.device_type() == cuda:
            if name.startswith(PREFIX):  # a span mirrored on the device's timeline
                continue
            linked = e.linked_correlation_id() if hasattr(e, "linked_correlation_id") else 0
            dev.append((e.start_ns(), e.end_ns(), e.correlation_id(), name, linked))
        elif name.startswith(PREFIX):
            ann.append((e.start_ns(), e.end_ns(), e.start_thread_id(), name))
        elif name.startswith("cu") and not name.startswith("cudnn"):
            rt.append((e.start_ns(), e.start_thread_id(), e.correlation_id(), name))
        else:
            cpu.append((e.start_ns(), e.end_ns(), e.start_thread_id(), name))
    win = [a for a in ann if a[3] == WINDOW]
    if len(win) != 1:
        raise RuntimeError(f"the trace holds {len(win)} {WINDOW} ranges")
    w0, w1, main, _ = win[0]

    dev_start = np.array([d[0] for d in dev], np.int64)
    dev_end = np.array([d[1] for d in dev], np.int64)
    inside = (dev_end > w0) & (dev_start < w1)
    u0, u1 = _union(np.clip(dev_start[inside], w0, w1), np.clip(dev_end[inside], w0, w1))
    busy_ns = int((u1 - u0).sum())

    # a device op names the runtime call that launched it by a correlation
    # id: its own or its linked one, whichever this torch fills in
    launched = {r[2] for r in rt}
    key = 2 if sum(d[2] in launched for d in dev) >= sum(d[4] in launched for d in dev) else 4
    by_corr = {}
    for i, d in enumerate(dev):
        by_corr.setdefault(d[key], []).append(i)
    rt_main = sorted((r[0], r[2], r[3]) for r in rt if r[1] == main)
    rt_ts = [r[0] for r in rt_main]
    launch_calls = sum(1 for r in rt_main if w0 <= r[0] <= w1 and r[2] in LAUNCH_CALLS)

    spans: dict = {}
    seen: dict = {}
    for a0, a1, tid, name in sorted(ann):
        if tid != main or not name.startswith(PREFIX) or name == WINDOW or not (w0 <= a0 <= w1):
            continue
        short = name[len(PREFIX):]
        k = seen.get(short, 0)
        seen[short] = k + 1
        end, device_ns = a1, 0
        for j in range(bisect.bisect_left(rt_ts, a0), bisect.bisect_right(rt_ts, a1)):
            for i in by_corr.get(rt_main[j][1], ()):
                end = max(end, int(dev_end[i]))
                device_ns += int(dev_end[i] - dev_start[i])
        f = facts.get(short, [])
        spans.setdefault(short, []).append(Span(host_s=(a1 - a0) / 1e9, stage_s=(end - a0) / 1e9,
                                                device_s=device_ns / 1e9, facts=f[k] if k < len(f) else {}))

    kernel_counts: dict = {}
    per_name: dict = {}
    for d, ok in zip(dev, inside):
        if ok:
            kernel_counts[d[3]] = kernel_counts.get(d[3], 0) + 1
            per_name[d[3]] = per_name.get(d[3], 0) + (d[1] - d[0])
    device_ops = [[n[:160], t / 1e9] for n, t in sorted(per_name.items(), key=lambda kv: -kv[1])[:10]]
    gap_s = np.concatenate([[w0], u1]) if u1.size else np.array([w0])
    gap_e = np.concatenate([u0, [w1]]) if u0.size else np.array([w1])
    gaps = sorted(zip(gap_e - gap_s, gap_s, gap_e), reverse=True)[:10]
    host = [c for c in cpu + ann if c[2] == main and c[3] != WINDOW]
    h0 = np.array([c[0] for c in host], np.int64)
    h1 = np.array([c[1] for c in host], np.int64)
    idle_gaps = []
    for length, g0, g1 in gaps:
        if length <= 0:
            continue
        mid = (g0 + g1) // 2
        hit = np.flatnonzero((h0 <= mid) & (h1 >= mid))
        span = [host[i][3][len(PREFIX):] for i in sorted(hit, key=lambda i: h0[i]) if host[i][3].startswith(PREFIX)]
        op = host[hit[np.argmax(h0[hit])]][3] if hit.size else "host loop"
        idle_gaps.append([f"{span[-1] if span else 'harness'}: {op}"[:160], int(length) / 1e9])
    return TraceData(steps=seen.get("entry", 0), window_s=(w1 - w0) / 1e9, busy_s=busy_ns / 1e9, spans=spans,
                     launch_calls=launch_calls, kernel_counts=kernel_counts,
                     breakdown={"device_ops": device_ops, "idle_gaps": idle_gaps})


def dropped(trace: TraceData, launched: dict) -> list:
    """The kernels whose launch counters (``kernels.counts()`` over the
    window) the profiler's events of that name fall short of by more than
    2%: a window that lost events."""
    out = []
    for name, n in launched.items():
        if n <= 0:
            continue
        seen = sum(c for k, c in trace.kernel_counts.items() if name in k)
        if abs(seen - n) > n // 50:
            out.append(f"{name}: {seen} profiled of {n} launched")
    return out
