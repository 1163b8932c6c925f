"""The port's benchmark program: full-resolution VO throughput on one card.

    python3 -m rgbd_visualodometry_tpu_torch.bench [--baseline PATH] [--window-log PATH]

Counterpart of the repository's root ``bench.py``, with its workloads, its
protocol and its output line.  The workload is the synthetic fr1-class
sequence (``_make_frames``: 640x480 RGB-D at fr1 intrinsics, a textured
plane, a constant drift with yaw), tracked with 500 ORB features over 8
levels.  Three phases run in this order, each a fixed number of passes on
a fresh VO, each pass 3 timed windows after ``WARMUP_FRAMES`` warm-up
frames:

1. ``FULL_VO_STREAMS`` streams of full VO (local BA) in one
   ``MultiStreamVO``, ``PASSES_HEADLINE`` passes of 3 x 15 steps; only if
   it runs out of device memory, ``FULL_VO_FALLBACK`` streams;
2. single-stream full VO, ``VisualOdometry`` with BA in its drain,
   ``PASSES_HEADLINE`` passes of 3 x ``MEASURE_FRAMES`` frames;
3. ``TRACKING_STREAMS`` streams of tracking only, 1 pass.

A phase's value is the median over its passes of each pass's best window
(frames, or stream-frames, per second); ``best`` is the best window of
all.  Every window of every pass is appended to the window log
(``bench_out/bench_windows_torch.jsonl`` under the repository, or
``--window-log``) with the card's name, power limit and SM clock.  After
each phase the cumulative JSON line is printed (and, on stderr, the
phase's windows, its K1 and K2 launch counts and its wall time); the last
line on stdout, also printed from the SIGTERM and SIGALRM handlers, is the
result::

    {"metric": ..., "value": N, "unit": "frames/sec/chip", "vs_baseline": N,
     "vs_strongest_twin": N, "best": N, "median": N, "passes": N}

``vs_baseline`` divides by the measured twin of the reference
(``baseline/measured.json``: full VO, or frontend only for the tracking
phase), ``vs_strongest_twin`` by its frontend-only rate.  ``BENCH_BUDGET_S``
(environment, default 1500 s) arms an alarm 20 s before it runs out, and
the single-stream and tracking phases are skipped when less than 240 s and
180 s of it remain.

Frames are rendered before any timing, in a pool of worker processes, and
staged on the card; each window closes on ``torch.cuda.synchronize()``
after the VO's last drain, then (multistream) a host copy of the last
record.  Not carried over from ``bench.py``: ``calibrate_timer``, which
guards against a TPU runtime whose ``block_until_ready`` returned at
enqueue (a synchronise waits for the card), and the XLA compilation
cache, which has no counterpart here.

Its entry points run on the CUDA device and raise without one; tests pass
``device="cpu"``.  It imports torch and numpy, and no module of the JAX
package.
"""

from __future__ import annotations

import argparse
import gc
import json
import multiprocessing
import os
import signal
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

from rgbd_visualodometry_tpu_torch import kernels
from rgbd_visualodometry_tpu_torch.config import VOConfig
from rgbd_visualodometry_tpu_torch.io import synthetic
from rgbd_visualodometry_tpu_torch.parallel import MultiStreamVO
from rgbd_visualodometry_tpu_torch.pipeline.frontend import StepOutput
from rgbd_visualodometry_tpu_torch.pipeline.system import VisualOdometry, open_device

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINE_PATH = os.path.join(_REPO, "baseline", "measured.json")
WINDOW_LOG = os.path.join(_REPO, "bench_out", "bench_windows_torch.jsonl")

WARMUP_FRAMES = 12
MEASURE_FRAMES = 60
# the batched phases stage every step on the card first, so their windows
# are shorter: 3 x 15 steps, each window holding exactly one BA dispatch
# under multistream_cfg's ba_min_frame_gap=14
MS_MEASURE_FRAMES = 45
TRACKING_STREAMS = 32
FULL_VO_STREAMS = 72
FULL_VO_FALLBACK = 64  # only when the 72-stream phase runs out of memory
PASSES_HEADLINE = 5
PASSES_SECONDARY = 2
BENCH_BUDGET_S = 1500.0
SINGLE_MIN_BUDGET_S = 240.0  # budget left below which a phase is skipped
TRACKING_MIN_BUDGET_S = 180.0

_TRAJECTORY = dict(step_t=(0.012, 0.002, 0.0), step_r=(0.0, 0.0, 0.003))
_FPS = 30.0  # synthetic.generate_sequence's frame rate
# a render worker spends about as long importing the package as rendering
# a few dozen frames: a stream is split over workers in chunks of no fewer
_MIN_CHUNK_FRAMES = 16


def load_baseline(path: str = BASELINE_PATH) -> dict:
    """The twin's measured rates: ``{"full_vo": fps, "frontend_only": fps}``."""
    with open(path, encoding="utf-8") as f:
        measured = json.load(f)
    return {k: float(measured[k]["fps_mean"]) for k in ("full_vo", "frontend_only")}


def _scene(cfg, seed: int) -> synthetic.SyntheticScene:
    return synthetic.SyntheticScene(
        width=cfg.image_width, height=cfg.image_height,
        fx=cfg.camera_fx, fy=cfg.camera_fy, cx=cfg.camera_cx, cy=cfg.camera_cy,
        seed=seed,
    )


def _make_frames(cfg, n, seed=0):
    """``n`` frames of stream ``seed``: the synthetic textured plane, a
    constant-velocity drift with yaw."""
    return synthetic.generate_sequence(n, scene=_scene(cfg, seed), **_TRAJECTORY)


def _render_job(job) -> None:
    """Worker: frames ``lo``..``hi - 1`` of ``_make_frames(cfg, n, seed)``
    into column ``seed`` of the arrays in ``directory``."""
    cfg, n, seed, lo, hi, directory = job
    out = {k: np.load(os.path.join(directory, f"{k}.npy"), mmap_mode="r+") for k in ("rgb", "depth", "timestamp", "T_c_w")}
    scene = _scene(cfg, seed)
    poses = synthetic.orbit_trajectory(n, **_TRAJECTORY)
    for i in range(lo, hi):
        f = scene.render(poses[i], timestamp=i / _FPS)
        out["rgb"][i, seed], out["depth"][i, seed] = f.rgb, f.depth
        out["timestamp"][i, seed], out["T_c_w"][i, seed] = f.timestamp, f.T_c_w
    for a in out.values():
        a.flush()


def render_streams(cfg, n_streams: int, n_frames: int, directory: str) -> dict:
    """``_make_frames(cfg, n_frames, seed=s)`` for every stream ``s``,
    rendered by a pool of worker processes straight into ``.npy`` files in
    ``directory`` (no frame passes through a pipe).  Returns them as
    copy-on-write memory maps, step first: ``rgb [T, S, H, W, 3]``,
    ``depth [T, S, H, W]``, ``timestamp [T, S]``, ``T_c_w [T, S, 7]``."""
    T, S, H, W = n_frames, n_streams, cfg.image_height, cfg.image_width
    for name, dtype, shape in (("rgb", np.uint8, (T, S, H, W, 3)), ("depth", np.uint16, (T, S, H, W)),
                               ("timestamp", np.float64, (T, S)), ("T_c_w", np.float64, (T, S, 7))):
        np.lib.format.open_memmap(os.path.join(directory, f"{name}.npy"), "w+", dtype, shape).flush()
    workers = os.cpu_count() or 1
    # split a stream's frames when the streams are fewer than the workers
    chunks = max(1, min(-(-workers // S), T // _MIN_CHUNK_FRAMES))
    bounds = [(T * c // chunks, T * (c + 1) // chunks) for c in range(chunks)]
    jobs = [(cfg, T, s, lo, hi, directory) for s in range(S) for lo, hi in bounds if hi > lo]
    with multiprocessing.get_context("spawn").Pool(min(workers, len(jobs))) as pool:
        pool.map(_render_job, jobs)
    return {k: np.load(os.path.join(directory, f"{k}.npy"), mmap_mode="c") for k in ("rgb", "depth", "timestamp", "T_c_w")}


def single_stream_cfg(cfg):
    """The config of the single-stream phase: the pools sized to the
    fr1-class deployment (the measured baseline makes ~10k map points over
    240 frames) instead of the defaults' 64k, as the batched phases."""
    return cfg.replace(
        max_mappoints=16384, max_keyframes=128, max_obs_per_mappoint=8,
        ba_max_points=1024, ba_max_poses=8,
        pnp_max_points=512,
        triangulation_batch=128,
        ransac_hypotheses=64,
    )


def multistream_cfg(cfg, full_vo: bool = False):
    """The config of the batched phases: :func:`single_stream_cfg`'s
    capacities, matching from the packed pool, local BA only with
    ``full_vo``, and then one batched solve at most every 15 steps
    (``ba_min_frame_gap`` 14: the baseline's 16 solves over 240 frames)."""
    return cfg.replace(
        max_mappoints=16384, max_keyframes=128, max_obs_per_mappoint=8,
        ba_max_points=1024, ba_max_poses=8,
        pnp_max_points=512,
        packed_matching=True,
        triangulation_batch=128,
        ransac_hypotheses=64,
        enable_local_optimization=full_vo,
        ba_min_frame_gap=max(cfg.ba_min_frame_gap, 14) if full_vo else cfg.ba_min_frame_gap,
    )


def card() -> str:
    """``nvidia-smi``'s name, power limit and SM clock of the first card."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e!r}"
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else f"nvidia-smi failed ({out.returncode})"


def _log_windows(phase: str, windows, path: str = WINDOW_LOG, extra: dict | None = None) -> None:
    """Append every measured window of every pass to the window log."""
    rec = {
        "time": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "phase": phase,
        "windows_fps": [[round(w, 2) for w in p] for p in windows],
        "card": card(),
    }
    if extra:
        rec.update(extra)
    try:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "a", encoding="utf-8") as f:
            f.write(json.dumps(rec) + "\n")
    except OSError as e:  # the log must never fail the bench
        print(f"[bench] window log {path}: {e!r}", file=sys.stderr)


def _summarize(phase: str, windows, path: str = WINDOW_LOG) -> dict:
    """``windows`` = [[fps per window] per pass] -> the phase's numbers."""
    _log_windows(phase, windows, path)
    per_pass = [max(p) for p in windows]
    return {
        "median": float(statistics.median(per_pass)),
        "best": float(max(per_pass)),
        "passes": len(per_pass),
        "windows": windows,
    }


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench_single(cfg, repeats: int = PASSES_HEADLINE, device="cuda", window_log: str = WINDOW_LOG) -> dict:
    """Single-stream full VO: ``VisualOdometry`` on :func:`single_stream_cfg`,
    each frame enqueued and the records read back 6 frames late, local BA
    inside that drain; ``repeats`` passes, each on a fresh VO."""
    device = open_device(device)
    scfg = single_stream_cfg(cfg)
    n = WARMUP_FRAMES + 3 * MEASURE_FRAMES
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        seq = render_streams(scfg, 1, n, tmp)
        print(f"[bench] rendered {n} frames in {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
        vo = VisualOdometry(scfg, device=device)
        # stage every frame on the card before timing: the reference's frame
        # timer also leaves image loading out (app/run_vo.cpp:91-109)
        staged = [(vo.put_frame(seq["rgb"][i, 0], seq["depth"][i, 0], seq["timestamp"][i, 0]),
                   float(seq["timestamp"][i, 0])) for i in range(n)]
        del seq
    _sync(device)
    windows = []
    for rep in range(max(1, repeats)):
        if rep:
            del vo
            vo = VisualOdometry(scfg, device=device)
        for f, ts in staged[:WARMUP_FRAMES]:
            vo.process_async(f, timestamp=ts)
        vo.drain(0)
        _sync(device)
        pass_windows = []
        for window in range(3):
            lo = WARMUP_FRAMES + window * MEASURE_FRAMES
            t0 = time.perf_counter()
            for f, ts in staged[lo : lo + MEASURE_FRAMES]:
                vo.process_async(f, timestamp=ts)
                vo.drain(6)
            vo.drain(0)
            _sync(device)
            pass_windows.append(MEASURE_FRAMES / (time.perf_counter() - t0))
        tracked = sum(r.tracked for r in vo.results)
        if tracked != n:
            raise AssertionError(f"tracking failed: {tracked}/{n}")
        windows.append(pass_windows)
    return _summarize("single-stream full VO", windows, window_log)


def bench_multistream(cfg, n_streams: int, full_vo: bool = False, repeats: int = PASSES_SECONDARY,
                      device="cuda", window_log: str = WINDOW_LOG) -> dict:
    """``n_streams`` independent streams in one ``MultiStreamVO`` (each
    its own sequence, seed ``s``), on :func:`multistream_cfg`; with
    ``full_vo`` the batched local BA of the streams that asked for it.  Every batch is staged on the
    card first; ``repeats`` passes over them, each on a fresh VO."""
    device = open_device(device)
    mcfg = multistream_cfg(cfg, full_vo=full_vo)
    n = WARMUP_FRAMES + MS_MEASURE_FRAMES
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        seq = render_streams(mcfg, n_streams, n, tmp)
        print(f"[bench] rendered {n_streams} streams x {n} frames in {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)
        vo = MultiStreamVO(mcfg, n_streams=n_streams, device=device)
        batches = [vo.put_batch(seq["rgb"][i], seq["depth"][i], seq["timestamp"][i]) for i in range(n)]
        del seq
    _sync(device)
    n_meas = MS_MEASURE_FRAMES // 3
    tracked = StepOutput._FIELDS["tracked"]
    windows = []
    for rep in range(max(1, repeats)):
        if rep:  # never two sets of states alive at once
            del vo, out, records
            vo = MultiStreamVO(mcfg, n_streams=n_streams, device=device)
        records = []
        for fb in batches[:WARMUP_FRAMES]:
            out = vo.step(fb)
            records.append(out.packed)
        vo.finish()
        _sync(device)
        out.packed.cpu()
        pass_windows = []
        for window in range(3):
            lo = WARMUP_FRAMES + window * n_meas
            t0 = time.perf_counter()
            for fb in batches[lo : lo + n_meas]:
                out = vo.step(fb)
                records.append(out.packed)
            vo.finish()
            _sync(device)
            out.packed.cpu()  # the window's last record on the host
            pass_windows.append(n_streams * n_meas / (time.perf_counter() - t0))
        lost = int((torch.stack(records)[..., tracked] <= 0.5).sum())
        if lost:
            raise AssertionError(f"{lost} of {len(records) * n_streams} stream-frames lost tracking")
        windows.append(pass_windows)
    mode = "full VO" if full_vo else "tracking"
    return _summarize(f"{n_streams}-stream batched {mode}", windows, window_log)


class _Reporter:
    """Holds completed phases; prints the cumulative best-so-far JSON line
    (the best phase by ``vs_baseline``)."""

    def __init__(self, frontend_fps: float):
        self.frontend_fps = frontend_fps
        self.phases = []  # (ratio, summary, mode label)

    def add(self, summary, divisor, label):
        self.phases.append((summary["median"] / divisor, summary, label))
        self.emit()

    def emit(self) -> bool:
        if not self.phases:
            return False
        ratio, phase, mode = max(self.phases, key=lambda c: c[0])
        print(json.dumps({
            "metric": f"synthetic fr1-class 640x480 tracking FPS/chip ({mode})",
            "value": round(phase["median"], 2),
            "unit": "frames/sec/chip",
            "vs_baseline": round(ratio, 2),
            # the reference's backend rides a second CPU core, so its
            # frontend-only rate bounds any fair full-VO twin
            "vs_strongest_twin": round(phase["median"] / self.frontend_fps, 2),
            "best": round(phase["best"], 2),
            "median": round(phase["median"], 2),
            "passes": phase["passes"],
        }), flush=True)
        return True


def main(argv=None, device="cuda") -> int:
    ap = argparse.ArgumentParser(prog="python3 -m rgbd_visualodometry_tpu_torch.bench", description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", default=BASELINE_PATH, help="the twin's measured rates (baseline/measured.json)")
    ap.add_argument("--window-log", default=WINDOW_LOG, help="JSON lines file every measured window is appended to")
    args = ap.parse_args(argv)
    t_start = time.monotonic()
    budget = float(os.environ.get("BENCH_BUDGET_S", BENCH_BUDGET_S))
    device = open_device(device)
    baseline = load_baseline(args.baseline)
    cfg = VOConfig()  # fr1 defaults: 640x480, 500 features, 8 levels
    reporter = _Reporter(baseline["frontend_only"])

    def remaining() -> float:
        return budget - (time.monotonic() - t_start)

    def bail(signum, frame):
        print(f"[bench] signal {signum}: emitting best-so-far JSON", file=sys.stderr, flush=True)
        had = reporter.emit()
        for p in multiprocessing.active_children():  # a render pool in flight
            p.terminate()
        os._exit(0 if had else 1)

    signal.signal(signal.SIGTERM, bail)
    signal.signal(signal.SIGALRM, bail)
    # ~20 s of headroom to flush before an outer kill lands
    signal.alarm(max(int(budget) - 20, 30))
    print(f"[bench] {card() if device.type == 'cuda' else device}; torch {torch.__version__}; "
          f"budget {budget:.0f} s", file=sys.stderr, flush=True)

    def run(tag, fn, divisor, label) -> bool:
        t0 = time.monotonic()
        kernels.reset_counts()
        got = fn()
        print(f"[bench] {tag}: median {got['median']:.2f} / best {got['best']:.2f} FPS over {got['passes']} passes, "
              f"windows {got['windows']}, kernel launches {kernels.counts()}, phase {time.monotonic() - t0:.1f} s "
              f"({remaining():.0f} s budget left)", file=sys.stderr, flush=True)
        reporter.add(got, divisor, label)
        return True

    # phase 1 (headline): 72-stream full VO; 64 streams only on OOM
    full_vo_ok, oom = False, False
    try:
        full_vo_ok = run(f"{FULL_VO_STREAMS}-stream full VO",
                         lambda: bench_multistream(cfg, FULL_VO_STREAMS, full_vo=True, repeats=PASSES_HEADLINE,
                                                   device=device, window_log=args.window_log),
                         baseline["full_vo"], f"{FULL_VO_STREAMS}-stream batched full VO")
    except torch.OutOfMemoryError:
        print(f"[bench] {FULL_VO_STREAMS}-stream full VO ran out of device memory:", file=sys.stderr)
        traceback.print_exc()
        oom = True
    except Exception:
        print(f"[bench] {FULL_VO_STREAMS}-stream full VO failed:", file=sys.stderr)
        traceback.print_exc()
    if oom:  # out of the handler: its traceback no longer holds the batches
        gc.collect()
        torch.cuda.empty_cache()
        try:
            full_vo_ok = run(f"{FULL_VO_FALLBACK}-stream full VO",
                             lambda: bench_multistream(cfg, FULL_VO_FALLBACK, full_vo=True, repeats=PASSES_SECONDARY,
                                                       device=device, window_log=args.window_log),
                             baseline["full_vo"], f"{FULL_VO_FALLBACK}-stream batched full VO")
        except Exception:
            print("[bench] fallback failed too:", file=sys.stderr)
            traceback.print_exc()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # phase 2: single-stream full VO
    if remaining() > SINGLE_MIN_BUDGET_S:
        try:
            run("single-stream full VO", lambda: bench_single(cfg, device=device, window_log=args.window_log),
                baseline["full_vo"], "single-stream full VO")
        except Exception:
            print("[bench] single-stream failed:", file=sys.stderr)
            traceback.print_exc()
            if not full_vo_ok:
                raise
    else:
        print(f"[bench] skipping single-stream phase (budget: {remaining():.0f} s left)", file=sys.stderr)

    # phase 3: batched tracking (the frontend-only comparison)
    if remaining() > TRACKING_MIN_BUDGET_S:
        try:
            run(f"{TRACKING_STREAMS}-stream tracking",
                lambda: bench_multistream(cfg, TRACKING_STREAMS, full_vo=False, repeats=1, device=device,
                                          window_log=args.window_log),
                baseline["frontend_only"], f"{TRACKING_STREAMS}-stream batched tracking")
        except Exception:
            print("[bench] tracking phase failed:", file=sys.stderr)
            traceback.print_exc()
    else:
        print(f"[bench] skipping tracking phase (budget: {remaining():.0f} s left)", file=sys.stderr)

    signal.alarm(0)
    print(f"[bench] total {time.monotonic() - t_start:.1f} s", file=sys.stderr, flush=True)
    return 0 if reporter.emit() else 1


if __name__ == "__main__":
    sys.exit(main())
