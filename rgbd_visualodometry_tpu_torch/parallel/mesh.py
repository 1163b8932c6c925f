"""S independent RGB-D streams tracked as one batched step on one device.

Counterpart of ``MultiStreamVO`` in ``rgbd_visualodometry_tpu/parallel/
mesh.py:49-215`` on a single device.  The per-stream state gets a leading
stream axis (:func:`mapstate.stack_states`) and the single-stream step runs
under ``torch.func.vmap``, as the JAX package ``vmap``s it: every tensor op
of the step is issued once for all streams, and kernels K1 (``fast_nms``)
and K2 (``hamming_nn``) launch once per batch step for every stream, through
their custom ops' vmap rules (``kernels.fold_streams``).  A loop over the
streams would issue each of the ~31k launches of a frame S times.

As in the JAX package the step is two calls, ``track_compute`` and then
``apply_updates``, and the optional local BA is one vmapped ``ba_step`` whose
result every leaf takes only for the streams that asked for it (``pred``).
The host reads each step's ``[S, 32]`` record once, three steps late, and
dispatches BA when a stream inserted a keyframe, at most once every
``ba_min_frame_gap`` steps for the whole batch.

A device mesh has no single-card meaning: there is no ``make_mesh`` and no
``mesh`` argument.  Streams over several cards, ``ShardedMapVO`` and the
sharded matcher are not ported (ROADMAP item 12b).
"""

from __future__ import annotations

import collections
import functools
from typing import Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from rgbd_visualodometry_tpu_torch import mapstate
from rgbd_visualodometry_tpu_torch import random as vo_random
from rgbd_visualodometry_tpu_torch.camera import Camera
from rgbd_visualodometry_tpu_torch.pipeline import backend
from rgbd_visualodometry_tpu_torch.pipeline import frontend as frontend_mod
from rgbd_visualodometry_tpu_torch.pipeline.system import open_device

BA_LAG = 3  # steps between a record and the host's read of it (mesh.py:116)


class MultiStreamVO:
    """Track ``n_streams`` independent sequences in one batched step::

        vo = MultiStreamVO(cfg, n_streams=72)  # on the CUDA device; device="cpu" for the CPU
        for rgb, depth, ts in batches:  # [S, H, W, 3], [S, H, W], [S]
            out = vo.step(rgb, depth, ts)  # StepOutput, packed [S, 32]
        vo.finish()

    Stream ``s`` starts from ``init_state`` with the key
    ``fold_in(PRNGKey(seed), s)``.
    """

    def __init__(self, cfg, n_streams: int, device="cuda", seed: int = 0):
        if n_streams < 1:
            raise ValueError(f"n_streams must be >= 1, got {n_streams}")
        self.device = open_device(device)
        self.cfg = cfg
        self.n_streams = n_streams
        self.camera = Camera.from_config(cfg)
        base = vo_random.PRNGKey(seed, self.device)
        self.states = mapstate.stack_states([
            mapstate.init_state(cfg, 0, self.device).replace(rng=vo_random.fold_in(base, s))
            for s in range(n_streams)
        ])
        self._compute = torch.func.vmap(functools.partial(frontend_mod.track_compute, cfg, self.camera))
        self._update = torch.func.vmap(functools.partial(_apply_updates_packed, cfg, self.camera))
        self.enable_backend = bool(cfg.enable_local_optimization)
        self._ba = torch.func.vmap(functools.partial(_masked_ba, cfg, self.camera))
        # per-stream absolute-time origin: the device sees float32 offsets
        self.time_base: Optional[np.ndarray] = None
        self._ba_pending: collections.deque = collections.deque()
        self._frames_since_ba = 1 << 30
        self.ba_dispatches = 0  # batched BA solves run

    def put_batch(self, rgb: np.ndarray, depth: np.ndarray, timestamps) -> frontend_mod.FrameInput:
        """Stage one ``[S, ...]`` frame batch on the device; the staged
        timestamps are offsets from each stream's first staged stamp."""
        ts = np.asarray(timestamps, np.float64)
        if ts.shape != (self.n_streams,):
            raise ValueError(f"expected {self.n_streams} timestamps, got shape {ts.shape}")
        if self.time_base is None:
            self.time_base = ts
        return frontend_mod.frame_input(rgb, depth, ts - self.time_base, self.device)

    def step(self, rgb, depth=None, timestamps=None) -> frontend_mod.StepOutput:
        """One tracking step for all streams: numpy ``rgb [S, H, W, 3]``,
        ``depth [S, H, W]``, ``timestamps [S]``, or a staged
        :class:`FrameInput` from :meth:`put_batch`.  Returns the batched
        :class:`StepOutput` (``packed [S, 32]``)."""
        frames = rgb if isinstance(rgb, frontend_mod.FrameInput) else self.put_batch(rgb, depth, timestamps)
        inter = self._compute(self.states, frames)
        self.states, packed = self._update(self.states, inter)
        out = frontend_mod.StepOutput(packed=packed)
        if self.enable_backend:
            self._ba_pending.append(_HostRecord(out.packed))
            self._drain_ba(BA_LAG)
        return out

    def _drain_ba(self, keep_lag: int) -> None:
        """Read the lagged records (one host copy of ``[S, 32]`` each, no
        other leaf) and dispatch the masked BA when a stream inserted a
        keyframe and the last dispatch is more than ``ba_min_frame_gap``
        steps back (the reference backend's coalescing, backend.cpp:8-17)."""
        f = frontend_mod.StepOutput._FIELDS
        while len(self._ba_pending) > keep_lag:
            o = self._ba_pending.popleft().numpy()
            needs = o[:, f["needs_ba"]] > 0.5
            self._frames_since_ba += 1
            if needs.any() and self._frames_since_ba > self.cfg.ba_min_frame_gap:
                kf = torch.from_numpy(o[:, f["kf_slot"]].astype(np.int64)).to(self.device)
                self.states = self._ba(self.states, kf, torch.from_numpy(needs).to(self.device))
                self._frames_since_ba = 0
                self.ba_dispatches += 1

    def finish(self) -> None:
        """Run the BA dispatches still due (call once after the last step)."""
        if self.enable_backend:
            self._drain_ba(0)

    def aggregate_metrics(self, out: frontend_mod.StepOutput) -> dict:
        """Counters reduced over the streams of one step's output."""
        return dict(
            tracked_fraction=float(out.tracked.float().mean()),
            mean_inliers=float(out.num_inliers.float().mean()),
            total_mappoints=int(out.num_mappoints.sum()),
        )


def _apply_updates_packed(cfg, camera, state, inter):
    """``apply_updates`` returning its record's tensor: vmap takes no None
    (``StepOutput.viewer``) in an output."""
    state, out = frontend_mod.apply_updates(cfg, camera, state, inter)
    return state, out.packed


def _masked_ba(cfg, camera, state, kf, pred):
    """``ba_step`` on one stream whose result every leaf takes only where
    ``pred`` (mesh.py:125-129)."""
    new_state, _ = backend.ba_step(cfg, camera, state, kf)
    return pytree.tree_map(lambda a, b: torch.where(pred, a, b), new_state, state)


class _HostRecord:
    """A step's ``[S, 32]`` record on its way to the host: on CUDA a
    non-blocking copy into pinned memory, started at once, so the lagged
    read rarely waits; on the CPU the tensor itself."""

    def __init__(self, packed: torch.Tensor):
        if packed.device.type == "cuda":
            self._host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
            self._host.copy_(packed, non_blocking=True)
            self._done = torch.cuda.Event()
            self._done.record()
        else:
            self._host, self._done = packed, None

    def numpy(self) -> np.ndarray:
        if self._done is not None:
            self._done.synchronize()
        return self._host.numpy()
