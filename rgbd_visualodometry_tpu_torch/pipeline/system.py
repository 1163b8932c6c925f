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
``ba_min_frame_gap`` frames.  ``counters()`` reports the BA work done.

A frame's work is traced from inside: while a torch profiler records,
``process_async`` is the span ``vo.step``, the record's read ``vo.readback``
and BA ``vo.ba``, with the spans of the layers below inside them
(``utils.profiling.span``).

Loop closure (``pipeline/globalopt.py``): ``global_relax`` relaxes the
whole keyframe graph and deforms the map with it.  With
``relax_every_kf = N`` the run loop relaxes every N keyframes and once more
at run close; after each acting relaxation every materialized pose moves
with its reference keyframe and the trajectory file is rewritten.  With
``relax_async`` (the default) the relaxation is computed from a clone of
the state on a worker thread, at most one in flight, and applied to the
live state when it is done.  On CUDA the worker enqueues on a stream of
its own, ordered after the clone and before the apply by events, so
neither thread's blocking host reads wait for the other's kernels, and it
replays the relaxation's launch-heavy stages from captured CUDA graphs
(``ops.replay``), so that it holds the interpreter lock for little of the
frame loop's time.

With ``enable_viewer`` the live viewer (``viz.MapViewer``, the reference's
render thread ``viewer.cpp:34-54``) is fed from the lagged drain: a
keypoint overlay per frame, and every ``viewer_map_every`` frames a map
render (where matplotlib imports) and the interactive ``map.html``, which
``run`` writes once more at its end.
"""

from __future__ import annotations

import collections
import json
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from rgbd_visualodometry_tpu_torch import mapstate
from rgbd_visualodometry_tpu_torch.camera import Camera
from rgbd_visualodometry_tpu_torch.io.trajectory import TrajectoryWriter
from rgbd_visualodometry_tpu_torch.mapstate import LOST
from rgbd_visualodometry_tpu_torch.ops import replay, se3
from rgbd_visualodometry_tpu_torch.pipeline import backend, globalopt
from rgbd_visualodometry_tpu_torch.pipeline import frontend as frontend_mod
from rgbd_visualodometry_tpu_torch.utils.profiling import span, spanned

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

    # this process holds the whole map; ``parallel.ShardedMapVO`` sets its
    # rank's block of the pool (a ``ops.collectives.MapShard``)
    shard = None

    def __init__(self, cfg, seed: int = 0, device="cuda"):
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
        self._ba_lm_steps = torch.zeros((), dtype=torch.int64, device=self.device)  # their LM steps taken
        self.num_auto_relaxes = 0  # online loop closures (relax_every_kf)
        # async loop-closure worker (cfg.relax_async): at most one in flight
        self._relax_thread: Optional[threading.Thread] = None
        self._relax_result: Optional[globalopt.Relaxation] = None
        self._relax_exc: Optional[BaseException] = None
        self._relax_done_event: Optional[torch.cuda.Event] = None  # CUDA: the worker's last op
        self._viewer = None
        self._viewer_frame = 0
        if cfg.enable_viewer:
            from rgbd_visualodometry_tpu_torch.viz import MapViewer

            self._viewer = MapViewer(cfg.viewer_dir)

    def put_frame(self, rgb: np.ndarray, depth: np.ndarray, timestamp: float) -> frontend_mod.FrameInput:
        """Stage one frame on the device; the staged timestamp is the offset
        from the first staged frame (float32 keeps it exact)."""
        if self.time_base is None:
            self.time_base = float(timestamp)
        return frontend_mod.frame_input(rgb, depth, float(timestamp) - self.time_base, self.device)

    @spanned("vo.step")
    def process_async(self, rgb, depth=None, timestamp=None, rgb_ref=None):
        """Enqueue one frame: numpy ``(rgb, depth, timestamp)`` or a staged
        :class:`FrameInput` with its host ``timestamp``.  With the viewer on,
        ``rgb_ref`` is the image its overlay draws on: by default the numpy
        ``rgb``, or a staged frame's device copy, read back when the lagged
        drain materializes the frame."""
        t0 = time.perf_counter()
        if isinstance(rgb, frontend_mod.FrameInput):
            frame = rgb
            if timestamp is None:
                timestamp = float(frame.timestamp) + (self.time_base or 0.0)
        else:
            frame = self.put_frame(rgb, depth, timestamp)
        if rgb_ref is None and self._viewer is not None:
            rgb_ref = frame.rgb if isinstance(rgb, frontend_mod.FrameInput) else rgb
        self.state, out = frontend_mod.track_step(self.cfg, self.camera, self.state, frame, self.shard)
        self._pending.append((float(timestamp), out, time.perf_counter() - t0, rgb_ref))

    def _materialize(self, ts: float, out, dispatch_s: float, rgb_ref=None) -> FrameResult:
        with span("vo.readback"):
            o = out.packed.cpu().numpy()  # one host copy of the record
        f = frontend_mod.StepOutput._FIELDS
        self._frames_since_ba += 1
        if self.enable_backend and o[f["needs_ba"]] > 0.5 and self._frames_since_ba > self.cfg.ba_min_frame_gap:
            self.state, ba = backend.ba_step(self.cfg, self.camera, self.state, int(o[f["kf_slot"]]), self.shard)
            self._frames_since_ba = 0
            self.ba_dispatches += 1
            self._ba_lm_steps += ba.lm_steps
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
        if self._viewer is not None and out.viewer is not None and rgb_ref is not None:
            v = out.viewer.cpu().numpy()
            img = rgb_ref.cpu().numpy() if isinstance(rgb_ref, torch.Tensor) else np.asarray(rgb_ref)
            self._viewer.render_overlay(img, v[:, :2], v[:, 2] > 0.5, name=f"frame_{self._viewer_frame:05d}.png")
            if self._viewer_frame % max(self.cfg.viewer_map_every, 1) == 0:
                traj = np.asarray([r.pose_w_c[4:7] for r in self.results if r.tracked])
                self._viewer.maybe_render_map(self.map_snapshot(), trajectory=traj, name=f"map_{self._viewer_frame:05d}.png")
                # map.html is rewritten in place, so a browser tab on it
                # follows a long run
                self.export_map_html()
            self._viewer_frame += 1
        return res

    def drain(self, keep_lag: int = 0) -> Optional[FrameResult]:
        last = None
        while len(self._pending) > keep_lag:
            last = self._materialize(*self._pending.popleft())
        return last

    def process(self, rgb: np.ndarray, depth: np.ndarray, timestamp: float) -> FrameResult:
        self.process_async(rgb, depth, timestamp)
        return self.drain(0)

    def counters(self) -> dict:
        """Local BA's work since construction, as host ints: dispatches,
        streams solved and kept (one each a dispatch here), the LM
        iterations run for the kept streams and those whose step was taken.
        Reads the device once; the step path never calls it."""
        n = self.ba_dispatches
        return dict(ba_dispatches=n, ba_streams_solved=n, ba_streams_kept=n,
                    ba_lm_iterations=2 * self.cfg.ba_iterations * n, ba_lm_steps=int(self._ba_lm_steps))

    @property
    def lost(self) -> bool:
        return bool(self.results) and self.results[-1].fsm == LOST

    def map_snapshot(self) -> dict:
        """Host copy of the live map: alive mappoints ``[n, 3]``, valid
        keyframe poses ``[k, 7]`` and the keyframe count."""
        s = self.whole_state()
        return dict(
            mappoints=s.mp_pos[s.mp_alive].cpu().numpy(),
            keyframe_poses=s.kf_pose[s.kf_valid].cpu().numpy(),
            num_keyframes=int(s.num_kf),
        )

    def whole_state(self) -> mapstate.VOState:
        """The whole map state: ``state`` itself here, the ranks' blocks
        gathered in ``parallel.ShardedMapVO`` (a collective there)."""
        return self.state

    def _agree(self, compute) -> Optional[globalopt.Relaxation]:
        """The relaxation every rank applies: ``compute()`` here.  In
        ``parallel.ShardedMapVO`` rank 0 alone calls it and broadcasts the
        result, and a failure there raises on every rank."""
        return compute()

    @property
    def _relaxes(self) -> bool:
        """Whether this process computes the relaxation (rank 0 of a
        ``parallel.ShardedMapVO``; the others take its result)."""
        return self.shard is None or self.shard.rank == 0

    def _relax_done(self, thread: threading.Thread) -> bool:
        """Whether the async relaxation in flight has finished (on every
        rank, in ``parallel.ShardedMapVO``)."""
        return not thread.is_alive()

    def run(self, frames, trajectory_path: Optional[str] = None, verbose: bool = False,
            lag: int = 3, stats_path: Optional[str] = None):
        """Track ``(rgb, depth, timestamp)`` frames (``run_vo.cpp:89-117``):
        stream the TUM poses of tracked frames, stop on LOST unless
        relocalization is enabled, and relax online every
        ``relax_every_kf`` keyframes."""
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
                        is_keyframe=res.is_keyframe, **res.stats,
                    )) + "\n")
                write_ok = res.tracked or self.cfg.compat_write_untracked_poses
                if writer and write_ok and res.fsm != LOST:
                    writer.write(res.timestamp, res.pose_w_c)
            written = len(self.results)

        stop_on_lost = not self.cfg.enable_relocalization
        auto_n = int(self.cfg.relax_every_kf or 0)
        use_async = bool(auto_n and self.cfg.relax_async)
        kf_at_last_relax = 0

        def relax_done(rep):
            if rep.kf_ts.size and writer:
                writer.rewrite(self._trajectory_entries())
            if verbose:
                print(f"auto relax #{self.num_auto_relaxes}: {rep.num_loop_edges} loop + "
                      f"{rep.num_appearance_edges} appearance edges, "
                      f"max correction {rep.max_correction_m * 100:.2f} cm")

        def auto_relax():
            # synchronous: the frames in flight tracked against the pre-relax
            # map, so they are materialized (and corrected) first; a relax
            # without loop evidence is a no-op (require_loop)
            flush(0)
            rep = self.global_relax(loop_gap_s=self.cfg.relax_loop_gap_s, require_loop=True)
            self.num_auto_relaxes += 1
            if rep.kf_ts.size:
                self._apply_relax_correction(rep)
            relax_done(rep)

        try:
            for rgb, depth, ts in frames:
                self.process_async(rgb, depth, ts)
                flush(lag)
                if auto_n:
                    kf_seen = sum(int(r.is_keyframe) for r in self.results)
                    if kf_seen - kf_at_last_relax >= auto_n:
                        if not use_async:
                            kf_at_last_relax = kf_seen
                            auto_relax()
                        elif self._relax_thread is None:  # one in flight at most
                            kf_at_last_relax = kf_seen
                            self._start_async_relax()
                    if use_async:
                        rlx = self._finish_async_relax()
                        if rlx is not None:
                            relax_done(rlx.report)
                if stop_on_lost and self.lost:
                    break
            flush(0)
            if auto_n:
                if use_async:
                    rlx = self._finish_async_relax(wait=True)
                    if rlx is not None:
                        relax_done(rlx.report)
                # one final relaxation closes a loop completed after the last
                # cadence point
                auto_relax()
        finally:
            if use_async and self._relax_thread is not None:
                # only on an error path: never leak the worker past the run;
                # a relaxation it finishes is applied as on the normal path,
                # and its own failure is dropped so the run's error surfaces
                try:
                    rlx = self._finish_async_relax(wait=True)
                    if rlx is not None:
                        relax_done(rlx.report)
                except Exception:
                    pass
            if writer:
                writer.close()
            if stats_f:
                stats_f.close()
            if self._viewer is not None:
                self.export_map_html()
        return self.results

    def _trajectory_entries(self):
        """(timestamp, pose_w_c) rows under the run loop's write filter."""
        return [
            (r.timestamp, r.pose_w_c)
            for r in self.results
            if (r.tracked or self.cfg.compat_write_untracked_poses) and r.fsm != LOST
        ]

    def _apply_relax_correction(self, report) -> None:
        """Move every materialized frame result rigidly with its reference
        keyframe's relaxation delta (``globalopt.correct_trajectory``)."""
        if report.kf_ts.size == 0 or not self.results:
            return
        ts = np.asarray([r.timestamp for r in self.results]) - (self.time_base or 0.0)
        poses = np.asarray([r.pose_w_c for r in self.results], np.float32)
        new_w_c = globalopt.correct_trajectory(report, ts, poses)
        new_c_w = se3.inverse(torch.from_numpy(new_w_c)).numpy()
        for r, pw, pc in zip(self.results, new_w_c, new_c_w):
            r.pose_w_c = pw
            r.pose_c_w = pc

    def _start_async_relax(self) -> None:
        """Start ``compute_relaxation`` on a clone of the state on a worker
        thread; the frame loop keeps tracking.  At most one relaxation is in
        flight ("latest wins", ``backend.h:33-37``): the run loop starts
        one only when none is.  The clone is enqueued on the main thread,
        before any of the worker's ops.

        On CUDA the worker runs on its own stream: it waits for an event
        recorded after the clone, every snapshot tensor is recorded on its
        stream (the caching allocator then keeps the memory until the
        worker's reads are done), and it records ``_relax_done_event`` after
        its last op for :meth:`_finish_async_relax`.  It replays the
        relaxation's captured graphs (``ops.replay``) and captures none:
        a stage it meets at a new shape runs eagerly and is captured by
        :meth:`_finish_async_relax`, on this thread."""
        snapshot = pytree.tree_map(torch.clone, self.whole_state())
        cfg, relaxes = self.cfg, self._relaxes
        stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        if stream is not None:
            cloned = torch.cuda.current_stream(self.device).record_event()
            for x in pytree.tree_leaves(snapshot):
                x.record_stream(stream)
            done = self._relax_done_event = torch.cuda.Event()

        def compute():
            if relaxes:
                self._relax_result = globalopt.compute_relaxation(
                    snapshot, cfg, loop_gap_s=cfg.relax_loop_gap_s, require_loop=True
                )

        def worker():
            try:
                if stream is None:
                    compute()
                    return
                with torch.cuda.stream(stream), replay.deferred():
                    stream.wait_event(cloned)
                    try:
                        compute()
                    finally:
                        done.record(stream)
            except BaseException as e:  # re-raised on the main thread by _finish_async_relax
                self._relax_exc = e

        self._relax_thread = threading.Thread(target=worker, daemon=True, name="vo-relax")
        self._relax_thread.start()

    def _finish_async_relax(self, wait: bool = False):
        """If the relaxation in flight is done (or ``wait``), apply it to the
        live state (``globalopt.apply_relaxation``) and correct the
        materialized results.  Returns the ``globalopt.Relaxation`` consumed,
        else None."""
        t = self._relax_thread
        if t is None or (not wait and not self._relax_done(t)):
            return None
        t.join()
        self._relax_thread = None
        exc, rlx = self._relax_exc, self._relax_result
        self._relax_exc = self._relax_result = None
        if self._relax_done_event is not None:
            # the frame loop's stream takes the worker's results only after
            # its last op, and keeps their memory until its own uses are done
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(self._relax_done_event)
            self._relax_done_event = None
            if rlx is not None:
                for x in (rlx.delta_w, rlx.snap_valid, rlx.snap_ts, rlx.ref_delta_w):
                    x.record_stream(stream)
            replay.capture_deferred()  # here, where no other thread launches

        def result():
            if exc is not None:
                raise exc
            return rlx

        rlx = self._agree(result)
        self.num_auto_relaxes += 1
        if rlx is not None and rlx.report.kf_ts.size:
            self.state = globalopt.apply_relaxation(self.state, rlx)
            self._apply_relax_correction(rlx.report)
        return rlx

    def export_map_html(self, edges=None, name: str = "map.html"):
        """(Re-)write the interactive 3D map, with optional loop-constraint
        segments (``RelaxReport.loop_pairs_w``) in green.  Returns its path;
        None (and writes nothing) unless the viewer is on."""
        if self._viewer is None:
            return None
        traj = np.asarray([r.pose_w_c[4:7] for r in self.results if r.tracked])
        return self._viewer.export_html(self.map_snapshot(), trajectory=traj, edges=edges, name=name)

    def global_relax(self, **kwargs):
        """Loop-closure relaxation of the whole map (``globalopt.relax_map``
        keyword arguments): relaxes every keyframe and deforms mappoints and
        the tracking reference with their anchor keyframes, so it is safe to
        call mid-run and keep tracking.  Returns a ``globalopt.RelaxReport``;
        ``globalopt.correct_trajectory`` applies it to per-frame poses
        (frame timestamps minus ``time_base``)."""
        whole = self.whole_state()
        rlx = self._agree(lambda: globalopt.compute_relaxation(whole, self.cfg, **kwargs))
        self.state = globalopt.apply_relaxation(self.state, rlx)
        return rlx.report
