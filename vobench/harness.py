"""One run of one cell: set-up, warm-up, the measured window, the traced
window, the check against the reference, and the result line.

Everything that belongs to one configuration, traffic mix, cell or metric
is data that this module finds by name:

- ``BENCHMARK.json`` (beside the ``vobench`` folder): the cell's
  configuration, traffic mix and metrics;
- ``vobench/configs/<config>.json``: the port entry it drives
  (``VisualOdometry`` or ``MultiStreamVO``) and its ``VOConfig`` settings;
- ``vobench/traffic/<mix>.json``: streams, sweep, ring period, warm-up, read
  lag, the check's samples and the traced window's length;
- ``vobench/limits/<cell>.json``: the limit of each compared number;
- ``vobench/metrics/<metric>.py``: one reader per metric, ``read(run)``
  returning the metric or None (then the metric is left out), with the
  spans it reads in ``SPANS``.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import importlib.util
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from vobench import check, frames, trace  # noqa: E402

# top-level module names the process may not hold once the window has closed
BANNED = ("jax", "jaxlib", "flax", "rgbd_visualodometry_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    here: pathlib.Path  # the vobench folder the data files came from


def load_cell(name: str, here: pathlib.Path = HERE) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its data files."""
    bench = json.loads((here.parent / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json (have {', '.join(cells)})")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((here.parent / conf["file"]).read_text())
    traffic = json.loads((here / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((here / "limits" / f"{name}.json").read_text())

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return Cell(name=name, chips=int(w["chips"]), config=config, traffic=traffic, limits=limits,
                end_to_end=mine(bench["end_to_end"]), per_layer=mine(bench["per_layer"]), here=here)


def load_reader(metric: str, here: pathlib.Path = HERE):
    path = here / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location("vobench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def card_readings() -> dict:
    """``nvidia-smi``'s power limit and SM clock of the first card."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit,clocks.sm", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
        limit, clock = (float(x) for x in out.stdout.strip().splitlines()[0].split(","))
        return {"power_limit_w": limit, "sm_clock_mhz": clock}
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return {}


# ---------------------------------------------------------------------------
# the program's entries
# ---------------------------------------------------------------------------


class HostRecord:
    """A step's record on its way to the host: a non-blocking copy into
    pinned memory and an event on CUDA (as ``mesh._HostRecord``), the
    tensor itself on the CPU."""

    def __init__(self, packed: torch.Tensor):
        if packed.device.type == "cuda":
            self.host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
            self.host.copy_(packed, non_blocking=True)
            self.done = torch.cuda.Event()
            self.done.record()
        else:
            self.host, self.done = packed, None

    def numpy(self) -> np.ndarray:
        if self.done is not None:
            self.done.synchronize()
        return self.host.numpy()


class FleetEntry:
    """``MultiStreamVO``: one batched step for every stream; the harness
    reads each step's ``[S, 32]`` record with the traffic's lag."""

    batched = True

    def __init__(self, cfg, streams: int, seed: int, device):
        from rgbd_visualodometry_tpu_torch.parallel import MultiStreamVO, mesh
        from rgbd_visualodometry_tpu_torch.pipeline.frontend import FrameInput

        self.frame_input = FrameInput
        self.vo = MultiStreamVO(cfg, streams, device=device, seed=seed)
        self.program_lag = mesh.BA_LAG
        self.pending: collections.deque = collections.deque()
        self.submitted = 0

    def initial_state(self):
        return self.vo.states

    def submit(self, frame, timestamp: float, sampler) -> None:
        sampler.context = self.submitted - self.program_lag
        self.pending.append(HostRecord(self.vo.step(self.frame_input(*frame)).packed))
        self.submitted += 1

    def in_flight(self) -> int:
        return len(self.pending)

    def decided(self) -> int:
        """Records whose BA decision the program has taken (it reads each
        record ``BA_LAG`` steps late)."""
        return max(self.submitted - self.program_lag, 0)

    def read_one(self, sampler) -> np.ndarray:
        return self.pending.popleft().numpy()

    def capture(self, sampler) -> None:
        vo = self.vo
        compute, update, ba = vo._compute, vo._update, vo._ba

        def compute_w(states, frames_):
            sampler.before_compute(states)
            inter = compute(states, frames_)
            sampler.on_compute(inter)
            return inter

        def update_w(states, inter):
            states, packed = update(states, inter)
            sampler.on_update(states)
            return states, packed

        def ba_w(states, kf, pred):
            sampler.before_ba(states, kf, pred)
            new = ba(states, kf, pred)
            sampler.on_ba(new)
            return new

        vo._compute, vo._update, vo._ba = compute_w, update_w, ba_w

    def release(self) -> None:
        pass


class SingleEntry:
    """``VisualOdometry``: ``process_async`` per frame and ``drain`` with the
    traffic's lag, as ``VisualOdometry.run`` drives it."""

    batched = False

    def __init__(self, cfg, streams: int, seed: int, device):
        from rgbd_visualodometry_tpu_torch.pipeline import frontend
        from rgbd_visualodometry_tpu_torch.pipeline.system import VisualOdometry

        self.vo = VisualOdometry(cfg, seed=seed, device=device)
        self.frame_input = frontend.FrameInput
        self.fields = frontend.StepOutput._FIELDS
        self.enable_ba = bool(cfg.enable_local_optimization)
        self.submitted = 0
        self._read = 0
        self._saved = []

    def initial_state(self):
        return self.vo.state

    def submit(self, frame, timestamp: float, sampler) -> None:
        self.vo.process_async(self.frame_input(*frame), timestamp=timestamp)
        self.submitted += 1

    def in_flight(self) -> int:
        return self.submitted - len(self.vo.results)

    def decided(self) -> int:
        return len(self.vo.results)

    def read_one(self, sampler) -> np.ndarray:
        sampler.context = self._read
        if len(self.vo.results) <= self._read:
            self.vo.drain(self.in_flight() - 1)
        r = self.vo.results[self._read]
        self._read += 1
        rec = np.zeros((1, 32), np.float32)
        rec[0, 0:7], rec[0, 7:14] = r.pose_c_w, r.pose_w_c
        rec[0, self.fields["tracked"]] = r.tracked
        rec[0, self.fields["fsm"]] = r.fsm
        rec[0, self.fields["is_keyframe"]] = r.is_keyframe
        rec[0, self.fields["needs_ba"]] = r.is_keyframe and self.enable_ba
        for k, v in r.stats.items():
            rec[0, self.fields[k]] = v
        return rec

    def capture(self, sampler) -> None:
        from rgbd_visualodometry_tpu_torch.pipeline import backend, frontend

        compute, update, ba_step = frontend.track_compute, frontend.apply_updates, backend.ba_step

        def compute_w(cfg, camera, state, frame, shard=None):
            sampler.before_compute(state)
            inter = compute(cfg, camera, state, frame, shard)
            sampler.on_compute(inter)
            return inter

        def update_w(cfg, camera, state, it, shard=None):
            state, out = update(cfg, camera, state, it, shard)
            sampler.on_update(state)
            return state, out

        def ba_w(cfg, camera, state, kf_slot, shard=None):
            dev = state.kf_pose.device
            sampler.before_ba(state, torch.tensor(int(kf_slot), device=dev), torch.tensor(True, device=dev))
            new, out = ba_step(cfg, camera, state, kf_slot, shard)
            sampler.on_ba(new)
            return new, out

        self._saved = [(frontend, "track_compute", compute), (frontend, "apply_updates", update),
                       (backend, "ba_step", ba_step)]
        frontend.track_compute, frontend.apply_updates, backend.ba_step = compute_w, update_w, ba_w

    def release(self) -> None:
        for mod, attr, fn in self._saved:
            setattr(mod, attr, fn)
        self._saved = []


ENTRIES = {"MultiStreamVO": FleetEntry, "VisualOdometry": SingleEntry}


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Window:
    setup_s: float
    length_s: float
    frames_read: int  # stream-frames whose record reached the host in the window
    attempted: int
    failed: int
    latencies_s: list


@dataclasses.dataclass
class Run:
    cell: Cell
    streams: int
    window: Window
    trace: trace.TraceData | None


def _sample_times(rng, n: int, seconds: float, share: float) -> list:
    return sorted(float(t) for t in rng.uniform(0.0, share * seconds, n))


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device="cuda", t_process: float | None = None,
             control: bool = False) -> dict:
    """One run: returns the result line's object (and, with ``control``,
    the control's numbers under ``"control"``)."""
    t_process = time.perf_counter() if t_process is None else t_process
    from rgbd_visualodometry_tpu_torch import kernels
    from rgbd_visualodometry_tpu_torch.config import VOConfig

    device = torch.device(device)
    tr = cell.traffic
    S = int(tr["streams"])
    entry_cls = ENTRIES[cell.config["entry"]]
    cfg = VOConfig().replace(**cell.config["settings"])
    camera = dict(width=cfg.image_width, height=cfg.image_height, fx=cfg.camera_fx, fy=cfg.camera_fy,
                  cx=cfg.camera_cx, cy=cfg.camera_cy, depth_scale=cfg.camera_depth_scale)
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFFFFFFFFFF, 0x7E57])
    chk = tr["check"]
    n_rows = min(int(chk["sample_streams"]), S)
    rows = [int(q * S // n_rows + rng.integers(0, max(S // n_rows, 1))) for q in range(n_rows)]

    readers = [load_reader(m["name"], cell.here) for m in (cell.per_layer if traced else [])]
    spans = trace.Spans({k: v for r in readers for k, v in getattr(r, "SPANS", {}).items()})
    spans.install()
    entry = None
    try:
        ring = frames.Ring(seed, tr, camera, device)
        entry = entry_cls(cfg, S, seed, device)
        sampler = check.Sampler(torch.tensor(rows, device=device) if entry.batched else None)
        sampler.init = sampler.take_all(check.leaves(entry.initial_state()))
        entry.capture(sampler)
        records: list = []
        lag = int(tr["read_lag"])

        def submit(i):
            entry.submit(ring.frame(i, entry.batched), ring.timestamp(i), sampler)

        # warm-up: every shape the window uses (a BA dispatch among them),
        # then drain, so the window starts with nothing in flight
        for i in range(int(tr["warmup"])):
            submit(i)
            while entry.in_flight() > lag:
                records.append(entry.read_one(sampler))
        while entry.in_flight():
            records.append(entry.read_one(sampler))
        if device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        card_before = card_readings() if device.type == "cuda" else {}

        track_at = _sample_times(rng, int(chk["track_samples"]), seconds, 0.9)
        # early in the window: a traced run spends some of it reading its trace,
        # and a batched BA comes only every ba_min_frame_gap + 1 steps
        ba_at = _sample_times(rng, int(chk["ba_samples"]), seconds, 0.2) if cfg.enable_local_optimization else []
        tcfg = tr["trace"]
        gap = int(cfg.ba_min_frame_gap)
        tracer = Tracer(spans, kernels, tcfg, gap, bool(cfg.enable_local_optimization)) if traced else None

        start = int(tr["warmup"])
        t_call: dict = {}
        lat, window_frames, untracked = [], 0, 0
        i = start
        # no collector pass inside the window: what set-up left is frozen
        gc.collect()
        gc.freeze()
        gc.disable()
        setup_s = time.perf_counter() - t_process
        t0 = time.perf_counter()
        while True:
            now = time.perf_counter() - t0
            if now >= seconds:
                break
            while track_at and track_at[0] <= now:
                track_at.pop(0)
                sampler.track_step = i
            while ba_at and ba_at[0] <= now:
                ba_at.pop(0)
                sampler.ba_armed += 1
            if tracer is not None:
                tracer.before(len(sampler.dispatches))
            t_call[i] = time.perf_counter()
            with tracer.entry() if tracer is not None else contextlib.nullcontext():
                submit(i)
            while entry.in_flight() > lag:
                rec = entry.read_one(sampler)
                j = len(records)
                records.append(rec)
                if j >= start:
                    lat.append(time.perf_counter() - t_call[j])
                    window_frames += S
                    untracked += int(np.sum(rec[:, check.REC["tracked"]] <= 0.5))
            if tracer is not None:
                tracer.after(len(sampler.dispatches))
            i += 1
        length = time.perf_counter() - t0
        gc.enable()
        gc.unfreeze()
        attempted = (i - start) * S
        while entry.in_flight():  # still in flight at the close: neither counted nor failed
            records.append(entry.read_one(sampler))
        if device.type == "cuda":
            torch.cuda.synchronize()
        if tracer is not None:
            tracer.close()
        card_after = card_readings() if device.type == "cuda" else {}
        memory_peak = int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0
        sample_frames = {step: tuple(x.index_select(0, sampler.rows).clone() if entry.batched else x[None].clone()
                                     for x in ring.frame(step, entry.batched)[:2]) + (ring.frame(step, False)[2].clone(),)
                         for step in sampler.track}
    finally:
        gc.enable()
        gc.unfreeze()
        if entry is not None:
            entry.release()
        spans.restore()

    window = Window(setup_s=setup_s, length_s=length, frames_read=window_frames, attempted=attempted,
                    failed=untracked, latencies_s=lat)
    batched = entry.batched
    decided = entry.decided()
    # the program's state is freed before the reference runs
    del entry, ring
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = check.Reference(cell.config["settings"], device)
    got = check.evaluate(ref, sampler, sample_frames, rows, seed, batched, records, decided, gap, control=control)
    correct, shown = check.verdict(got["numbers"], cell.limits, bool(cfg.enable_local_optimization),
                                   got["track_samples"], got["ba_samples"])

    run = Run(cell=cell, streams=S, window=window, trace=tracer.data if tracer is not None else None)
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = load_reader(m["name"], cell.here).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                "count": 1, "memory_peak_bytes": memory_peak,
                "card_before": card_before, "card_after": card_after}
    result = {"correct": correct, "attempted": attempted, "failed": window.failed, "metrics": metrics,
              "device": dev_info}
    if traced and tracer.data is not None:
        dev_info["busy_s"] = tracer.data.busy_s
        dev_info["window_s"] = tracer.data.window_s
        result["breakdown"] = tracer.data.breakdown
    if control:
        result["control"] = got["control"]
    result["readings"] = got["numbers"]
    result["checks"] = shown
    return result


class Tracer:
    """The traced window inside the measured one: it opens once at least
    ``gap - 1`` steps have passed since the last BA dispatch (at once if
    there is no BA), and closes after ``min_steps`` steps that saw a BA
    dispatch (where the cell has BA), or after ``max_steps``.  A window
    whose profiler events fall short of the launch counters is taken again,
    three times at most; then the run fails."""

    def __init__(self, spans: trace.Spans, kernels, tcfg: dict, gap: int, has_ba: bool):
        self.spans, self.kernels = spans, kernels
        self.min_steps, self.max_steps = int(tcfg["min_steps"]), int(tcfg["max_steps"])
        self.gap, self.has_ba = gap, has_ba
        self.prof = None
        self.data = None
        self.attempts = 0
        self.steps = 0
        self.since_ba = 0
        self.last_dispatches = None
        self._range = None

    def before(self, dispatches: int) -> None:
        if self.last_dispatches is not None and dispatches > self.last_dispatches:
            self.since_ba = 0
        self.last_dispatches = dispatches
        if self.data is not None or self.prof is not None:
            return
        if self.since_ba >= self.gap - 1 or not self.has_ba:
            self._open(dispatches)

    def _open(self, dispatches: int) -> None:
        from torch.profiler import ProfilerActivity, profile

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self._range = torch.profiler.record_function(trace.WINDOW)
        self._range.__enter__()
        self.counts0 = self.kernels.counts()
        self.d0 = dispatches
        self.steps = 0
        for v in self.spans.facts.values():
            v.clear()
        self.spans.recording = True

    def entry(self):
        return torch.profiler.record_function(trace.ENTRY) if self.prof is not None else contextlib.nullcontext()

    def after(self, dispatches: int) -> None:
        self.since_ba += 1
        if self.prof is None:
            return
        self.steps += 1
        saw = dispatches > self.d0 or not self.has_ba
        if (self.steps >= self.min_steps and saw) or self.steps >= self.max_steps:
            self._close()

    def _close(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._range.__exit__(None, None, None)
        self.spans.recording = False
        launched = {k: v - self.counts0.get(k, 0) for k, v in self.kernels.counts().items()}
        self.prof.__exit__(None, None, None)
        data = trace.reduce(self.prof.profiler.kineto_results.events(), self.spans.facts)
        self.prof = None
        self.attempts += 1
        lost = trace.dropped(data, launched)
        if not lost:
            self.data = data
            return
        print(f"vobench: traced window {self.attempts} lost events ({'; '.join(lost)}): {data.steps} steps, "
              f"{sum(data.kernel_counts.values())} device ops, {data.launch_calls} launch calls", file=sys.stderr)
        if self.attempts >= 3:
            raise RuntimeError("the profiler lost events in 3 traced windows: " + "; ".join(lost))

    def close(self) -> None:
        if self.prof is not None:
            self._close()
        if self.data is None:
            raise RuntimeError("the traced window did not close inside the measured one")


def banned_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))
