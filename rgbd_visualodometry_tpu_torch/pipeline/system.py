"""Host-side orchestrator: the user-facing ``VisualOdometry`` object.

Counterpart of ``rgbd_visualodometry_tpu/pipeline/system.py`` (the object
wiring and main loop of ``app/run_vo.cpp:72-128``).  ``process_async``
enqueues one tracking step on the device and returns; results are read
back with a configurable lag by ``drain``, one copy of the packed record
per frame.  ``run`` tracks a sequence, writes the TUM trajectory of
tracked frames and stops on LOST unless relocalization is on.

Local bundle adjustment (``enable_local_optimization``) runs as in the
reference: when a keyframe's lagged record asks for it, ``backend.ba_step``
optimizes the newest state, after the steps still in flight ("latest
keyframe wins", ``backend.h:33-37``), at most once every
``ba_min_frame_gap`` frames.  Online loop closure (``relax_every_kf``) and
the viewer are not ported and raise at construction.
"""

from __future__ import annotations

import collections
import json
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from rgbd_visualodometry_tpu_torch import mapstate
from rgbd_visualodometry_tpu_torch.camera import Camera
from rgbd_visualodometry_tpu_torch.io.trajectory import TrajectoryWriter
from rgbd_visualodometry_tpu_torch.mapstate import LOST
from rgbd_visualodometry_tpu_torch.pipeline import backend
from rgbd_visualodometry_tpu_torch.pipeline import frontend as frontend_mod

_STATS = (
    "num_candidates", "num_matches", "num_inliers", "num_final_inliers",
    "num_new_mappoints", "num_triangulated", "num_keyframes", "num_mappoints",
    "kf_overflow", "num_dropped_mappoints",
)


def open_device(device) -> torch.device:
    """:func:`mapstate.resolve_device`, with TF32 turned off on CUDA: full
    float32 for the resize matmuls and the plain Hamming check."""
    device = mapstate.resolve_device(device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


@dataclass
class FrameResult:
    timestamp: float
    tracked: bool
    fsm: int
    is_keyframe: bool
    pose_w_c: np.ndarray  # [7] (qw qx qy qz tx ty tz)
    pose_c_w: np.ndarray
    stats: dict = field(default_factory=dict)
    step_seconds: float = 0.0


class VisualOdometry:
    """Usage::

        vo = VisualOdometry(cfg)  # on the CUDA device; device="cpu" for the CPU
        for rgb, depth, t in frames:
            res = vo.process(rgb, depth, t)
    """

    def __init__(self, cfg, seed: int = 0, device="cuda"):
        if cfg.enable_viewer:
            raise NotImplementedError("viewer: see ROADMAP")
        if cfg.relax_every_kf:
            raise NotImplementedError("online loop closure (relax_every_kf): see ROADMAP")
        self.device = open_device(device)
        self.cfg = cfg
        self.camera = Camera.from_config(cfg)
        self.state = mapstate.init_state(cfg, seed, self.device)
        self.enable_backend = bool(cfg.enable_local_optimization)
        self.time_base: Optional[float] = None
        self.results: list[FrameResult] = []
        self._pending: collections.deque = collections.deque()
        self._frames_since_ba = 1 << 30
        self.ba_dispatches = 0  # local BA solves run

    def put_frame(self, rgb: np.ndarray, depth: np.ndarray, timestamp: float) -> frontend_mod.FrameInput:
        """Stage one frame on the device; the staged timestamp is the offset
        from the first staged frame (float32 keeps it exact)."""
        if self.time_base is None:
            self.time_base = float(timestamp)
        return frontend_mod.frame_input(rgb, depth, float(timestamp) - self.time_base, self.device)

    def process_async(self, rgb, depth=None, timestamp=None):
        """Enqueue one frame: numpy ``(rgb, depth, timestamp)`` or a staged
        :class:`FrameInput` with its host ``timestamp``."""
        t0 = time.perf_counter()
        if isinstance(rgb, frontend_mod.FrameInput):
            frame = rgb
            if timestamp is None:
                timestamp = float(frame.timestamp) + (self.time_base or 0.0)
        else:
            frame = self.put_frame(rgb, depth, timestamp)
        self.state, out = frontend_mod.track_step(self.cfg, self.camera, self.state, frame)
        self._pending.append((float(timestamp), out, time.perf_counter() - t0))

    def _materialize(self, ts: float, out, dispatch_s: float) -> FrameResult:
        o = out.packed.cpu().numpy()  # one host copy of the record
        f = frontend_mod.StepOutput._FIELDS
        self._frames_since_ba += 1
        if self.enable_backend and o[f["needs_ba"]] > 0.5 and self._frames_since_ba > self.cfg.ba_min_frame_gap:
            self.state, _ = backend.ba_step(self.cfg, self.camera, self.state, int(o[f["kf_slot"]]))
            self._frames_since_ba = 0
            self.ba_dispatches += 1
        res = FrameResult(
            timestamp=ts,
            tracked=bool(o[f["tracked"]] > 0.5),
            fsm=int(o[f["fsm"]]),
            is_keyframe=bool(o[f["is_keyframe"]] > 0.5),
            pose_w_c=o[7:14].copy(),
            pose_c_w=o[0:7].copy(),
            stats={k: int(o[f[k]]) for k in _STATS},
            step_seconds=dispatch_s,
        )
        self.results.append(res)
        return res

    def drain(self, keep_lag: int = 0) -> Optional[FrameResult]:
        last = None
        while len(self._pending) > keep_lag:
            last = self._materialize(*self._pending.popleft())
        return last

    def process(self, rgb: np.ndarray, depth: np.ndarray, timestamp: float) -> FrameResult:
        self.process_async(rgb, depth, timestamp)
        return self.drain(0)

    @property
    def lost(self) -> bool:
        return bool(self.results) and self.results[-1].fsm == LOST

    def map_snapshot(self) -> dict:
        """Host copy of the live map: alive mappoints ``[n, 3]``, valid
        keyframe poses ``[k, 7]`` and the keyframe count."""
        s = self.state
        return dict(
            mappoints=s.mp_pos[s.mp_alive].cpu().numpy(),
            keyframe_poses=s.kf_pose[s.kf_valid].cpu().numpy(),
            num_keyframes=int(s.num_kf),
        )

    def run(self, frames, trajectory_path: Optional[str] = None, verbose: bool = False,
            lag: int = 3, stats_path: Optional[str] = None):
        """Track ``(rgb, depth, timestamp)`` frames (``run_vo.cpp:89-117``):
        stream the TUM poses of tracked frames, stop on LOST unless
        relocalization is enabled."""
        writer = TrajectoryWriter(trajectory_path) if trajectory_path else None
        stats_f = open(stats_path, "w", encoding="utf-8") if stats_path else None
        written = 0

        def flush(keep_lag):
            nonlocal written
            self.drain(keep_lag)
            for res in self.results[written:]:
                if verbose:
                    s = res.stats
                    print(f"t={res.timestamp:.3f} fsm={res.fsm} kf={int(res.is_keyframe)} "
                          f"match={s['num_matches']} inlier={s['num_inliers']} map={s['num_mappoints']}")
                if stats_f:
                    stats_f.write(json.dumps(dict(
                        timestamp=res.timestamp, tracked=res.tracked, fsm=res.fsm,
                        is_keyframe=res.is_keyframe, step_seconds=res.step_seconds, **res.stats,
                    )) + "\n")
                write_ok = res.tracked or self.cfg.compat_write_untracked_poses
                if writer and write_ok and res.fsm != LOST:
                    writer.write(res.timestamp, res.pose_w_c)
            written = len(self.results)

        stop_on_lost = not self.cfg.enable_relocalization
        try:
            for rgb, depth, ts in frames:
                self.process_async(rgb, depth, ts)
                flush(lag)
                if stop_on_lost and self.lost:
                    break
            flush(0)
        finally:
            if writer:
                writer.close()
            if stats_f:
                stats_f.close()
        return self.results
