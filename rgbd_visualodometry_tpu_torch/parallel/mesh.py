"""Streams and the map over one device or the ranks of a process group.

Counterpart of ``rgbd_visualodometry_tpu/parallel/mesh.py``.  A
``torch.distributed`` process group (:func:`open_group`) takes the place of
the JAX device mesh, and ``ops.collectives`` the place of the
collectives XLA inserts.

**MultiStreamVO** (``mesh.py:49-215``) on one device: the per-stream state gets a leading
stream axis (:func:`mapstate.stack_states`) and the single-stream step runs
under ``torch.func.vmap``, as the JAX package ``vmap``s it: every tensor op
of the step is issued once for all streams, and kernels K1 (``fast_nms``)
and K2 (``hamming_nn``) launch once per batch step for every stream, through
their custom ops' vmap rules (``kernels.fold_streams``).  A loop over the
streams would issue each of the ~31k launches of a frame S times.

As in the JAX package the step is two calls, ``track_compute`` and then
``apply_updates``.  The optional local BA differs: the JAX package solves
every stream and keeps the result only where a stream asked for it
(``pred``); here a dispatch gathers the streams that asked, runs one
vmapped ``ba_step`` over just those (a lone one beside a copy of itself:
a batch of one rounds otherwise), and writes their results back, so no
solve is thrown away.  The host reads each step's ``[S, 32]`` record once,
three steps late, and dispatches BA when a stream inserted a keyframe, at
most once every ``ba_min_frame_gap`` steps for the whole batch; the rows to
gather come from that host copy, so a dispatch reads nothing back from the
device.  ``counters()`` reports how many streams the dispatches solved and
kept, and the LM steps taken.

With ``group``, rank ``r`` of ``W`` owns streams ``[r S / W, (r + 1) S / W)``
(``mesh.py:90-104``): it holds only their states and runs the same batched
step on them.  ``step`` still takes the whole ``[S, ...]`` batch and returns
the whole ``[S, 32]`` record (one all-reduce), so the BA dispatch decision
reads every rank's streams and ``ba_dispatches`` and every stream's result
are those of one process running all S.

**ShardedMapVO** (``mesh.py:238-284``): one stream whose map-point pool is
split over the ranks: rank ``r`` holds the contiguous block
``[r C / W, (r + 1) C / W)`` of every pool leaf (:func:`map_partition_specs`)
and a replica of the rest.  The step is the single-stream step with the
rank's :class:`collectives.MapShard`; kernel K2 runs on the local
``[C / W, 8]`` rows.  **sharded_match_descriptors** (``mesh.py:287-331``)
is its matcher on its own.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from rgbd_visualodometry_tpu_torch import mapstate
from rgbd_visualodometry_tpu_torch import random as vo_random
from rgbd_visualodometry_tpu_torch.camera import Camera
from rgbd_visualodometry_tpu_torch.ops import matching
from rgbd_visualodometry_tpu_torch.ops import collectives
from rgbd_visualodometry_tpu_torch.pipeline import backend
from rgbd_visualodometry_tpu_torch.pipeline import frontend as frontend_mod
from rgbd_visualodometry_tpu_torch.pipeline import globalopt
from rgbd_visualodometry_tpu_torch.pipeline.system import VisualOdometry, open_device
from rgbd_visualodometry_tpu_torch.utils.profiling import spanned

BA_LAG = 3  # steps between a record and the host's read of it (mesh.py:116)


def open_group(backend_name: str, init_method: str, world_size: int, rank: int):
    """Join a ``torch.distributed`` process group and return it: the port's
    stand-in for ``make_mesh``.  ``backend_name`` is ``"gloo"`` (CPU or
    CUDA tensors) or ``"nccl"`` (CUDA tensors, one device per rank);
    ``init_method`` a ``tcp://host:port`` or ``file://path`` address.
    Raises where the backend is not available; it changes neither the
    backend nor the current device (with NCCL, the caller selects each
    rank's device first)."""
    if not dist.is_available() or not dist.is_backend_available(backend_name):
        raise RuntimeError(f"torch.distributed backend {backend_name!r} is not available")
    dist.init_process_group(backend_name, init_method=init_method, world_size=world_size, rank=rank)
    return dist.group.WORLD


class MultiStreamVO:
    """Track ``n_streams`` independent sequences in one batched step::

        vo = MultiStreamVO(cfg, n_streams=72)  # on the CUDA device; device="cpu" for the CPU
        for rgb, depth, ts in batches:  # [S, H, W, 3], [S, H, W], [S]
            out = vo.step(rgb, depth, ts)  # StepOutput, packed [S, 32]
        vo.finish()

    Stream ``s`` starts from ``init_state`` with the key
    ``fold_in(PRNGKey(seed), s)``.  With ``group`` (:func:`open_group`), this
    rank tracks streams ``streams.start`` to ``streams.stop - 1``; every rank
    calls ``step`` with the whole batch.
    """

    def __init__(self, cfg, n_streams: int, device="cuda", seed: int = 0, group=None):
        if n_streams < 1:
            raise ValueError(f"n_streams must be >= 1, got {n_streams}")
        self.device = open_device(device)
        self.cfg = cfg
        self.n_streams = n_streams
        self.camera = Camera.from_config(cfg)
        if group is None:
            self.shard, self.streams = None, range(n_streams)
        else:
            self.shard = collectives.MapShard.of(group, n_streams, self.device)
            self.streams = range(self.shard.offset, self.shard.offset + self.shard.local_size)
        base = vo_random.PRNGKey(seed, self.device)
        self.states = mapstate.stack_states([
            mapstate.init_state(cfg, 0, self.device).replace(rng=vo_random.fold_in(base, s))
            for s in self.streams
        ])
        self._compute = torch.func.vmap(functools.partial(frontend_mod.track_compute, cfg, self.camera))
        self._update = torch.func.vmap(functools.partial(_apply_updates_packed, cfg, self.camera))
        self.enable_backend = bool(cfg.enable_local_optimization)
        self._solve = torch.func.vmap(functools.partial(_ba_one, cfg, self.camera))
        self._kept_rows: Optional[torch.Tensor] = None  # the next ``_ba`` call's rows, from the host's record
        # per-stream absolute-time origin: the device sees float32 offsets
        self.time_base: Optional[np.ndarray] = None
        self._ba_pending: collections.deque = collections.deque()
        self._frames_since_ba = 1 << 30
        self.ba_dispatches = 0  # batched BA solves run
        self.ba_streams_solved = 0  # streams gathered into a solve (this rank's)
        self.ba_streams_kept = 0  # streams whose result the state kept (this rank's)
        self._ba_lm_steps = torch.zeros(len(self.streams), dtype=torch.int64, device=self.device)

    def put_batch(self, rgb: np.ndarray, depth: np.ndarray, timestamps) -> frontend_mod.FrameInput:
        """Stage one ``[S, ...]`` frame batch on the device (this rank's
        streams of it); the staged timestamps are offsets from each stream's
        first staged stamp."""
        ts = np.asarray(timestamps, np.float64)
        if ts.shape != (self.n_streams,):
            raise ValueError(f"expected {self.n_streams} timestamps, got shape {ts.shape}")
        if self.time_base is None:
            self.time_base = ts
        own = slice(self.streams.start, self.streams.stop)
        return frontend_mod.frame_input(rgb[own], depth[own], (ts - self.time_base)[own], self.device)

    @spanned("vo.step")
    def step(self, rgb, depth=None, timestamps=None) -> frontend_mod.StepOutput:
        """One tracking step for all streams: numpy ``rgb [S, H, W, 3]``,
        ``depth [S, H, W]``, ``timestamps [S]``, or a staged
        :class:`FrameInput` from :meth:`put_batch`.  Returns the batched
        :class:`StepOutput` (``packed [S, 32]``), every rank's streams."""
        frames = rgb if isinstance(rgb, frontend_mod.FrameInput) else self.put_batch(rgb, depth, timestamps)
        inter = self._compute(self.states, frames)
        self.states, packed = self._update(self.states, inter)
        if self.shard is not None:
            (packed,) = collectives.all_gather_blocks(self.shard, packed)
            packed = packed.reshape(self.n_streams, -1)
        out = frontend_mod.StepOutput(packed=packed)
        if self.enable_backend:
            self._ba_pending.append(_HostRecord(out.packed))
            self._drain_ba(BA_LAG)
        return out

    def _drain_ba(self, keep_lag: int) -> None:
        """Read the lagged records (one host copy of ``[S, 32]`` each, no
        other leaf) and dispatch BA when a stream inserted a keyframe and the
        last dispatch is more than ``ba_min_frame_gap`` steps back (the
        reference backend's coalescing, backend.cpp:8-17).  Every rank reads
        the whole record, so all decide alike; each solves those of its own
        streams that asked, possibly none."""
        f = frontend_mod.StepOutput._FIELDS
        own = slice(self.streams.start, self.streams.stop)
        while len(self._ba_pending) > keep_lag:
            o = self._ba_pending.popleft().numpy()
            needs = o[:, f["needs_ba"]] > 0.5
            self._frames_since_ba += 1
            if needs.any() and self._frames_since_ba > self.cfg.ba_min_frame_gap:
                mine = needs[own]
                kf, pred, self._kept_rows = _to_device(self.device, o[own, f["kf_slot"]], mine, np.flatnonzero(mine))
                self.states = self._ba(self.states, kf, pred.bool())
                self._frames_since_ba = 0
                self.ba_dispatches += 1
                self.ba_streams_kept += int(mine.sum())

    def _ba(self, states, kf, pred):
        """Local BA of the streams ``pred [S]`` marks, each at its keyframe
        ``kf [S]``: gathers them, solves only them, and returns new
        ``[S, ...]`` states holding their results and every other stream's
        leaves as they were (``states`` itself is not written, nor solved
        at all where ``pred`` marks none).  Adds the solved streams' LM steps
        to the counter.  The rows come from ``_drain_ba``'s host record;
        called without them, it reads them from ``pred`` (a sync)."""
        rows, self._kept_rows = self._kept_rows, None
        if rows is None:
            rows = pred.nonzero().flatten()
        n = rows.numel()
        if not n:
            return states
        # a batch of one rounds otherwise than batches of two or more, which
        # agree to the bit: a lone stream is solved beside a copy of itself,
        # so its result does not depend on how many others asked with it
        # (nor on how the streams are split over ranks)
        take = rows if n > 1 else rows.repeat(2)
        self.ba_streams_solved += take.numel()
        solved, lm_steps = self._solve(pytree.tree_map(lambda x: x.index_select(0, take), states),
                                       kf.index_select(0, take))
        self._ba_lm_steps.index_add_(0, rows, lm_steps[:n].to(self._ba_lm_steps.dtype))
        return pytree.tree_map(lambda old, new: old.index_copy(0, rows, new[:n]), states, solved)

    def counters(self) -> dict:
        """Local BA's work since construction, as host ints, over this
        rank's streams: dispatches, streams solved (the rows gathered into
        a solve, a lone stream's copy included) and kept (those whose record
        asked for BA), the LM iterations run for the kept streams and those
        whose step was taken.  Reads the device once; the step path never calls it."""
        n, kept = self.ba_dispatches, self.ba_streams_kept
        return dict(ba_dispatches=n, ba_streams_solved=self.ba_streams_solved, ba_streams_kept=kept,
                    ba_lm_iterations=2 * self.cfg.ba_iterations * kept, ba_lm_steps=int(self._ba_lm_steps.sum()))

    def finish(self) -> None:
        """Run the BA dispatches still due (call once after the last step)."""
        if self.enable_backend:
            self._drain_ba(0)

    def aggregate_metrics(self, out: frontend_mod.StepOutput) -> dict:
        """Counters reduced over the streams of one step's output (every
        rank's: ``step`` returns the whole record)."""
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


def _ba_one(cfg, camera, state, kf):
    """``ba_step`` on one stream; returns ``(state, LM steps taken)``.  It
    is looked up on ``backend`` at each call, so a wrapper set there (a
    profiler span, a test's spy) sees every dispatch."""
    new_state, out = backend.ba_step(cfg, camera, state, kf)
    return new_state, out.lm_steps


def _to_device(device, *arrays):
    """Host integer or bool arrays -> int64 tensors on ``device``, in one
    copy; on CUDA from pinned memory and not waited for, so the host goes
    on enqueuing while it lands (the stream orders it before their use)."""
    sizes = [a.size for a in arrays]
    flat = torch.from_numpy(np.concatenate([np.asarray(a, np.int64).ravel() for a in arrays]))
    if device.type == "cuda":
        flat = flat.pin_memory().to(device, non_blocking=True)
    else:
        flat = flat.to(device)
    return flat.split(sizes)


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

    @spanned("vo.readback")
    def numpy(self) -> np.ndarray:
        if self._done is not None:
            self._done.synchronize()
        return self._host.numpy()


# ---------------------------------------------------------------------------
# the map-point pool split over the ranks of a group
# ---------------------------------------------------------------------------


def map_partition_specs() -> mapstate.VOState:
    """For each ``VOState`` leaf, the dimension split over the ranks in the
    port's C-major layout, or None for a leaf every rank holds whole
    (``mesh.py:218-235``): dim 0 of every ``mp_*`` and ``obs_*`` pool, dim 1
    of the incidence matrix ``A_inc [K, C]``."""
    return mapstate.VOState(**{
        f.name: 1 if f.name == "A_inc" else 0 if f.name.startswith(("mp_", "obs_")) else None
        for f in dataclasses.fields(mapstate.VOState)
    })


def _split_leaves():
    specs = map_partition_specs()
    return [(f.name, getattr(specs, f.name)) for f in dataclasses.fields(specs) if getattr(specs, f.name) is not None]


def shard_state(state: mapstate.VOState, shard: collectives.MapShard) -> mapstate.VOState:
    """A whole state (a loaded checkpoint) -> this rank's: its block of
    every split leaf (copied, so the whole pool can be freed), the other
    leaves as they are.  Raises unless the state holds ``shard.size`` map
    points."""
    if state.mp_pos.shape[0] != shard.size:
        raise ValueError(f"the state holds {state.mp_pos.shape[0]} map points, the shards {shard.size}")
    return state.replace(**{n: getattr(state, n).narrow(d, shard.offset, shard.local_size).clone()
                            for n, d in _split_leaves()})


def gather_state(state: mapstate.VOState, shard: collectives.MapShard) -> mapstate.VOState:
    """The ranks' states -> the whole state, on every rank (one all-reduce)."""
    names = _split_leaves()
    blocks = collectives.all_gather_blocks(shard, *(getattr(state, n) for n, _ in names))
    return state.replace(**{n: torch.cat(list(b.unbind(0)), dim=d) for (n, d), b in zip(names, blocks)})


class _SilentViewer:
    """The viewer of ranks other than 0: called where rank 0's is (the map
    snapshot it is handed is a collective), writing nothing."""

    def render_overlay(self, *args, **kwargs):
        return None

    maybe_render_map = export_html = render_overlay


class ShardedMapVO(VisualOdometry):
    """One stream whose map-point pool is split over the ranks of ``group``
    (``mesh.py:238-284``)::

        group = open_group("nccl", "tcp://host:port", world_size, rank)
        vo = ShardedMapVO(cfg, group, device=f"cuda:{local_rank}")
        for rgb, depth, t in frames:  # every rank, the same frames
            res = vo.process(rgb, depth, t)

    Every rank computes the replicated work (ORB, RANSAC, LM, BA's solve)
    and holds the keyframes, the FSM and the key whole.  The reductions over
    the pool are collectives (``ops.collectives``), and before a rank
    writes its block it takes rank 0's decisions (the replicated fields of
    ``TrackInter``, BA's solution and prune mask): one broadcast per frame
    and one per BA, so CUDA's run-to-run rounding cannot set ranks apart.
    The whole-map readers (``map_snapshot``, ``global_relax``, the online
    relaxations) gather the pool first (``whole_state``, a collective);
    rank 0 alone computes a relaxation, and each rank deforms its own block
    with it.  A checkpoint is ``io.checkpoint.save_state(vo.whole_state(),
    ...)`` written by one rank, and ``vo.state = shard_state(state,
    vo.shard)`` resumes from one.  Give ``run`` its output paths on one
    rank only.
    """

    def __init__(self, cfg, group, device="cuda", seed: int = 0):
        world = dist.get_world_size(group)
        if cfg.max_mappoints % world:
            raise ValueError(f"max_mappoints={cfg.max_mappoints} must divide evenly over {world} ranks")
        super().__init__(cfg, seed=seed, device=device)
        self.shard = collectives.MapShard.of(group, cfg.max_mappoints, self.device)
        self.state = shard_state(self.state, self.shard)
        if self._viewer is not None and self.shard.rank != 0:
            self._viewer = _SilentViewer()

    def whole_state(self) -> mapstate.VOState:
        return gather_state(self.state, self.shard)

    def _agree(self, compute) -> Optional[globalopt.Relaxation]:
        if self.shard.rank != 0:
            got = collectives.broadcast_object(self.shard, None)
            if isinstance(got, str):
                raise RuntimeError(f"the relaxation failed on rank 0: {got}")
            return _relaxation_to(got, self.device)
        try:
            rlx = compute()
        except BaseException as e:  # release the other ranks, which raise too
            collectives.broadcast_object(self.shard, f"{type(e).__name__}: {e}")
            raise
        collectives.broadcast_object(self.shard, _relaxation_to(rlx, "cpu"))
        return rlx

    def _relax_done(self, thread) -> bool:
        done = torch.tensor(int(not thread.is_alive()), device=self.device)
        return bool(collectives.pool_min(self.shard, done))


def _relaxation_to(rlx: Optional[globalopt.Relaxation], device) -> Optional[globalopt.Relaxation]:
    if rlx is None:
        return None
    return dataclasses.replace(rlx, **{n: getattr(rlx, n).to(device)
                                       for n in ("delta_w", "snap_valid", "snap_ts", "ref_delta_w")})


def sharded_match_descriptors(group, cand_desc: torch.Tensor, cand_mask: torch.Tensor, kp_desc: torch.Tensor,
                              kp_mask: torch.Tensor, match_ratio: float = 2.0,
                              min_match_distance: float = 30.0) -> matching.MatchResult:
    """Exact Hamming matching against a pool split over the ranks of
    ``group`` (``mesh.py:287-331``): this rank's packed rows
    ``cand_desc [C / W, 8]`` int32 and ``cand_mask [C / W]``, every rank's
    keypoints ``kp_desc [N, 8]``, ``kp_mask [N]``.  Kernel K2 on the local
    rows, then one all-reduce MIN for the global minimum distance: returns
    this rank's rows of the ``MatchResult`` with the global
    ``min_distance``."""
    shard = collectives.MapShard.of(group, cand_desc.shape[0] * dist.get_world_size(group), cand_desc.device)
    nn = matching.nearest_keypoints_packed(cand_desc, kp_desc, kp_mask)
    return matching.gate_matches(nn, cand_mask, match_ratio, min_match_distance, shard=shard)
