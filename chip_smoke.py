#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit) and builds the
   hand-written kernels from ``rgbd_visualodometry_tpu_torch/csrc`` (one
   ``nvcc`` per source, in parallel; ``-Xptxas -v`` output printed).
2. Kernel phase: each kernel against its plain torch version on the card,
   with ``torch.equal`` after a synchronise (all three are exact).
   K1 ``fast_nms_pyramid`` on the 8 levels of a 640x480 synthetic frame (one
   launch), an odd-sized 641x479 pyramid, a table with 1x1 and 5x7 levels,
   10 levels (two launches) and one level at a time; K2 ``hamming_nn`` at
   N = 500 keypoints x C = 16384 map rows with ~10% of the keypoint mask
   off, a tie-heavy case, a ragged C, an all-masked mask, N = 37 with
   C = 1000 and N = 3000; K3 ``hamming_matrix`` at C x N = 65536 x 512 (the
   parity bench's shape), 16384 x 500 (the main path's), ragged C = 16383
   with N = 500 and 37, rows that are not 16-byte aligned (N = 1, 7, 9,
   37), C = 1, N = 3000 (several keypoint chunks), C = 0, N = 0 and a
   tie-heavy pool (candidates equal to keypoints, every keypoint twice);
   each nonempty case also through K3's C entry into a sentinel-guarded
   buffer, at output offsets of 0 and 1 word (the vector and the one-word
   store paths), which fails on any write outside [C, N].  Timed after
   steps 4-7, at the main path's shapes: each kernel's wrapper-inclusive
   time (CUDA events around one call) and its plain version's time, then
   its device time (torch.profiler), its bound (the larger of its bytes at
   3.35 TB/s and its operations at the published peak of their type) and,
   for K2 and K3, ``torch._int_mm`` on the bipolar operands as the library
   yardstick (the port never calls it); for K3 also a store-only pass over
   its output (``fill_``) as the card's own write floor.  The SM clock and
   its maximum (``nvidia-smi``) are printed before and after the timings.
3. K3 path: the entry point ``matching.hamming_matrix_packed`` called once
   at 65536 x 512 with the launch counts reset just before it.
4. Slice phase: ``VisualOdometry(cfg, device="cuda").run`` over 60 frames of
   the single-stream bench workload (640x480, fr1 intrinsics, 500 ORB
   features over 8 levels, 16384 map points) with packed matching and no
   local BA.  Every frame must be tracked, the ATE against the exact ground
   truth must be < 3 cm, and the launch counters must show K1 and K2 once
   per frame.
5. Full-VO phase: the same over ``bench.single_stream_cfg(VOConfig())``
   unchanged - local BA after every keyframe - with the same checks, and
   BA must have run once for every record that asked for it.  Then one
   offline ``vo.global_relax()`` of that run (128 keyframe slots: a
   [768, 768] solve), with synchronised stage timers; the corrected
   trajectory's ATE must stay < 3 cm.
5b. Loop-closure phase: the JAX package's ``slow``
   ``test_online_relax_fullres_closed_loop`` on the port -
   :func:`loop_config` (the full-VO config with 64 keyframes,
   ``relax_every_kf=6``, a 1 s loop gap) over the 64-frame closed circuit
   ``io.synthetic.loop_trajectory(64, step=0.03)`` with a +5% depth-scale
   fault over frames 16-47, run twice with the counts reset before each:
   ``relax_async=False`` with synchronised timers around the relaxation's
   stages (co-observation graph, appearance graph, solve, apply), then
   ``relax_async=True``.  Each run must track every frame, relax at least
   once with at least one relaxation that found loop or appearance edges
   and acted, write a trajectory file equal to the corrected in-memory
   poses (1e-6), keep every pose finite, and launch K1 and K2 once per
   frame; in the async run every relaxation the worker computed must
   equal ``compute_relaxation`` called again on a clone of its snapshot,
   to the bit.  Printed, not asserted: each acting relaxation's streamed
   ATE before and after it, the edge counts, the relax wall and stage
   times, in the async run the median frame time beside the frame time
   while a relaxation is in flight, and in both the non-stalling
   contract's numbers (spikes, total over frames x median).
   Then the stall-contract step: the JAX package's tier-1
   ``test_async_relax_does_not_stall_frame_loop`` on the card
   (:func:`contract_config`, its 320x240 config field for field, over the
   same faulted circuit at 320x240): a warm-up instance whose relaxations
   must equal ``compute_relaxation`` on their snapshots to the bit, then a
   timed instance, its frame clock around the generator's ``yield`` as the
   test's, the counts reset just before.  Per frame it prints the wall
   time, whether a relaxation was in flight, and for those frames the
   time in the blocking record reads, in the relaxation's start and
   finish, and the rest.  Asserted as the test writes them: at least 3
   relaxations, at most 2 frames after frame 8 slower than 3 x median +
   50 ms, their total at most 1.6 x frames x median + 3 s; and every
   frame tracked, the file equal to memory, K1 and K2 once per frame.
5c. CLI phase: the user-facing surfaces, driven in this process through
   ``cli.main`` on ``configs/default.yaml`` (640x480, fr1 intrinsics, 500
   features over 8 levels, local BA, the default capacities): (a)
   ``--synthetic 60 --stats --save-map --global-relax``: every frame
   tracked, ATE < 3 cm (printed, and of the relaxed trajectory file), K1
   and K2 exactly 60 launches each, 60 trajectory lines and 60 stats
   records, and the checkpoint reloaded (``io.checkpoint.load_state``) and
   saved again to equal leaves, both timed; (b) 30 frames of the same
   sequence written as a TUM directory with real epoch stamps by
   ``io.png`` and tracked with ``--dataset --evaluate``: every frame
   tracked, ATE < 3 cm, and the decoder that ran (the native libpng loader
   or ``io/png.py``) and both decoders' ms per frame; (c) ``--load-map
   --localize-only`` over that directory: every frame tracked, and the
   keyframe, mappoint and observation leaves of the map saved after it equal
   to those loaded; (d) the eval CLI's ``ate`` and ``rpe`` on (b)'s files;
   (e) the viewer on the card: its payload's rule checked on 10 frames
   (the flags are exactly the valid keypoints that a kept match points at,
   at most ``num_matches``), then ``cli.main`` with ``enable_viewer: 1``
   over 10 frames of (b)'s directory: every payload on the card, an
   overlay per frame that decodes to ``draw_keypoints`` of its payload,
   ``map.html`` of the final map, and the map PNGs of the run loop and the
   CLI written exactly where matplotlib imports.  It prints which of
   PyYAML, OpenCV, matplotlib, Pillow and libpng this machine has, the ms
   per frame through the CLI and the phase's wall time.
5d. Bench phase: the port's bench program
   (``rgbd_visualodometry_tpu_torch/bench.py``, the counterpart of the
   root ``bench.py``) through its phase functions with the protocol cut to
   1 pass of 3 windows (4 warm-up frames, windows of 5 frames or 2 batch
   steps): ``bench_single`` (single-stream full VO, BA in the lagged
   drain) and ``bench_multistream`` with 32 streams of tracking only (the
   bench's third phase), each with the counts reset just before it.  Every
   frame must be tracked, K1 and K2 must launch once per frame or batch
   step, the windows must be finite and logged with this card's name, and
   the result line must carry ``bench.py``'s keys.
6. Multistream phase: the bench's headline "72-stream batched full VO",
   ``parallel.MultiStreamVO`` over ``bench.multistream_cfg(VOConfig(),
   full_vo=True)`` (the full-VO config with packed matching and BA at most
   every 15 steps): 72 streams, each its own 640x480 sequence (seed ``s``,
   rendered by ``bench.render_streams`` in a process pool), 12 warm-up and
   12 timed batch steps, the batches staged on the card first.  Every stream must track every frame
   with ATE < 3 cm, a BA dispatch must have run, and K1 and K2 must have
   launched exactly once per batch step.  Then K1 (72 streams x 8 levels)
   and K2 (72 x 16384 x 500, one stream all masked) are compared with their
   plain versions per stream, and timed after the other kernels, with
   ``torch.bmm`` in fp16 as K2's library yardstick; the same at the first
   32 streams, the shapes of the bench's tracking phase (step 5d).
6b. Distributed phase: the port's multi-process half (``parallel``) on
   the one card, every rank on ``cuda:0``.  Two spawned ranks of a gloo
   group with CUDA tensors (NCCL refuses two ranks on one device) run
   (a) ``sharded_match_descriptors`` at C = 65536 (32768 rows a rank),
   N = 500: each rank's K2 rows exactly the plain version
   (``hamming_nn_reference``) + ``gate_matches`` over the whole pool, and
   K2 on the whole pool exactly its plain version; (b)
   ``ShardedMapVO(VOConfig())``, the JAX dry-run's production shape
   (640x480, 500 features, 65536 map points, 512 keyframes, local BA),
   over 30 frames of the bench sequence, held to ``VisualOdometry``'s run on
   them in this process: every frame tracked, ATE at most 1.1x, the
   replicated leaves bit-equal across the ranks after every frame (an
   all-reduce MAX and MIN of a checksum), K1 and K2 once per frame on each
   rank, each rank's pool half of ``VisualOdometry``'s, and the first frame
   whose keyframe decision differs printed with the poses around it; (c)
   ``MultiStreamVO`` with step 6's 72 streams split 36 and 36 (its
   sequences read from memory-mapped files), 12 + 12 steps: every
   stream-frame tracked, the whole ``[S, 32]`` records against step 6's
   one-process records (the decisions equal on every stream-frame; each
   stream's ATE at most 1.05x one process's + 0.5 mm; the counts and poses
   that differ printed), the BA dispatches of step 6's run, K1 and K2 once
   per step.
   Then (d) one rank of an NCCL group: 5 frames of ``ShardedMapVO`` whose
   discrete outputs equal ``VisualOdometry``'s, poses within 1e-5.  The
   ms/frame and stream-frames/s it prints are two processes sharing one
   card: no scaling number.
7. With ``--profile``: a breakdown of one full-VO frame's time and of one
   multistream batch step's by stage, ``ba_step`` included, and the device
   busy share (torch.profiler) - not part of the default run.
8. Prints the kernels' JSON line, then ``{"ok": true, "device": ...}`` as the
   last line.  In it ``ms`` is the wrapper-inclusive time and ``device_ms``
   the device time; ``launches_per_frame`` is each kernel's count in the
   full-VO run over its frames, and ``launches`` that count too, except for
   K3, whose path is step 3; ``max_abs_err`` is measured on the compared
   outputs at the main path's shapes.  K1 and K2 also carry a
   ``multistream`` entry: the same keys at the batched shapes, with
   ``launches`` from step 6, ``loop_closure_launches``, their counts in
   the two runs of step 5b and its stall-contract step, ``cli_launches``, their counts in the four
   tracking runs of step 5c, ``distributed_launches``, their counts on
   each rank in step 6b, and ``bench_single_launches``, their count in
   step 5d's single-stream run; the ``multistream`` entry holds
   ``tracking_launches``, their count in step 5d's 32-stream tracking run,
   and ``tracking``, their timings at 32 streams.

Any failure raises and exits nonzero; without a CUDA device, or without the
repository beside this file, it exits nonzero before printing a result.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
N_FRAMES = 60
WARMUP_FRAMES = 10
ATE_LIMIT_M = 0.03
MS_STREAMS = 72  # bench.FULL_VO_STREAMS
MS_WARMUP = 12  # bench.WARMUP_FRAMES
MS_MEASURED = 12
TRACKING_STREAMS = 32  # bench.TRACKING_STREAMS
LOOP_FRAMES = 64  # tests/test_loopclosure.py::test_online_relax_fullres_closed_loop
CONTRACT_SKIP = 8  # frames the non-stalling contract leaves out (tests/test_loopclosure.py:686)
CLI_FRAMES = 60
TUM_FRAMES = 30
VIEWER_FRAMES = 10
VIEWER_MAP_EVERY = 5
TUM_T0 = 1305031102.175304  # the first stamp of TUM fr1/xyz: the CLI reads real epoch stamps


def sass_summary(lib) -> dict:
    """Counts of tensor-core (HMMA, IMMA, BMMA) and popcount and float
    min/max (POPC, FMNMX) instructions in each kernel of the built library,
    from ``cuobjdump -sass``: which units the kernels' work is compiled for."""
    tool = shutil.which("cuobjdump") or os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return {}
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True).stdout
    out, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = next((k for k in ("fast_nms_pyramid_kernel", "hamming_nn_kernel", "hamming_matrix_kernel")
                         if k in line), line.split("Function :")[1].strip())
            out[name] = {}
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)", line)
        if name and m and m.group(1) in ("HMMA", "IMMA", "BMMA", "POPC", "FMNMX"):
            out[name][m.group(1)] = out[name].get(m.group(1), 0) + 1
    return out


def full_vo_config():
    """``bench.single_stream_cfg(VOConfig())``, the repo's headline
    single-stream workload with local BA after every keyframe (the port's
    bench program, ``rgbd_visualodometry_tpu_torch/bench.py``)."""
    from rgbd_visualodometry_tpu_torch import VOConfig, bench

    return bench.single_stream_cfg(VOConfig())


def slice_config():
    """:func:`full_vo_config` with packed matching and no local BA."""
    return full_vo_config().replace(packed_matching=True, enable_local_optimization=False)


def multistream_config():
    """``bench.multistream_cfg(VOConfig(), full_vo=True)``, the config of the
    repo's headline "72-stream batched full VO": :func:`full_vo_config` with
    packed matching and one batched BA solve at most every 15 steps."""
    from rgbd_visualodometry_tpu_torch import VOConfig, bench

    return bench.multistream_cfg(VOConfig(), full_vo=True)


def loop_config():
    """The full-width online loop-closure workload of the JAX package's
    ``slow`` ``test_online_relax_fullres_closed_loop``: :func:`full_vo_config`
    with 64 keyframes, a relaxation every 6 keyframes and a 1 s loop gap
    (the synthetic circuit spans ~2 s)."""
    return full_vo_config().replace(max_keyframes=64, relax_every_kf=6, relax_loop_gap_s=1.0)


def loop_frames(cfg, n: int = LOOP_FRAMES):
    """That test's closed circuit (``io.synthetic.loop_trajectory``, 3 cm
    steps) with a +5% depth-scale fault over its middle half: ``(frames,
    depth images as fed)``."""
    import numpy as np

    from rgbd_visualodometry_tpu_torch.io import synthetic

    scene = synthetic.SyntheticScene(
        width=cfg.image_width, height=cfg.image_height,
        fx=cfg.camera_fx, fy=cfg.camera_fy, cx=cfg.camera_cx, cy=cfg.camera_cy,
    )
    frames = [scene.render(T, timestamp=i / 30.0) for i, T in enumerate(synthetic.loop_trajectory(n, step=0.03))]
    depths = [np.clip(f.depth.astype(np.float32) * 1.05, 0, 65535).astype(np.uint16) if n // 4 <= i < 3 * n // 4
              else f.depth for i, f in enumerate(frames)]
    return frames, depths


def make_frames(cfg, n: int, seed: int = 0):
    """The frames of ``bench._make_frames``: the synthetic textured plane,
    a constant-velocity drift with yaw."""
    from rgbd_visualodometry_tpu_torch import bench

    return bench._make_frames(cfg, n, seed=seed)


# published peaks of one H100 SXM (NVIDIA's data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"fp32": 67e12, "int8 tensor-core": 1979e12}
# sub/min/max per pixel of K1's arithmetic: 16 ring differences, 128 for
# the arc windows by doubling, 30 for the bright/dark maxima, 2 for the
# clamp and the bright/dark max, 9 for the 3x3 NMS window and its select
K1_OPS_PER_PIXEL = 16 + 128 + 30 + 2 + 9


def sm_clocks() -> str:
    """The SM clock and its maximum now, as ``nvidia-smi`` reads them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def _median_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    """Median of CUDA events around single calls: the wrapper's host work
    (checks, allocation, the ctypes call) is inside the window."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _device_ms(fn, kernel: str | None, iters: int = 100, attempts: int = 3) -> float:
    """Device time (ms) of one call of ``fn``: the torch.profiler self device
    time of the kernels whose name holds ``kernel`` (every kernel if None)
    over ``iters`` calls, per call: the mean over the launches it recorded
    times the launches per call.  The profiler drops an event now and then,
    and once dropped nearly all: a window whose count of such launches is
    more than 2% of ``iters`` away from a whole number per call is taken
    again, up to ``attempts`` times, then this raises."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total_us, launches = 0.0, 0
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:  # a host op also carries its kernels' time
                continue
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0.0)
            if us and (kernel is None or kernel in e.key):
                total_us += us
                launches += e.count
        per_call = round(launches / iters)
        if total_us > 0 and per_call >= 1 and abs(launches - per_call * iters) <= iters // 50:
            return total_us / launches * per_call / 1e3
    raise AssertionError(f"torch.profiler recorded {launches} device kernels for {kernel!r} over {iters} calls "
                         f"in each of {attempts} windows")


def _bound(nbytes: int, ops: int, op_type: str) -> tuple[float, str, str]:
    """Least time (ms) of the work on the card: the larger of its bytes over
    the memory rate and its operations over the peak of their type.
    Returns (ms, "bytes" or "operations", the basis in words)."""
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * ops / PEAK_OPS_PER_S[op_type]
    if t_bytes >= t_ops:
        return t_bytes, "bytes", f"{nbytes} B read and written once at 3.35 TB/s"
    return t_ops, "operations", f"{ops} {op_type} operations at {PEAK_OPS_PER_S[op_type] / 1e12:.0f} T/s"


def _bipolar(desc):
    """Packed descriptors -> [K, 256] int8 +-1, the JAX default's layout."""
    import torch

    from rgbd_visualodometry_tpu_torch.ops.orb import unpack_bits

    return (unpack_bits(desc) * 2 - 1).to(torch.int8)


def _int_mm_ms(cand, kp, n_pad: int, label: str, check=None):
    """``torch._int_mm`` of the bipolar operands ``[C, 256] x [256, n_pad]``
    (keypoints padded with zero rows): the one PyTorch call that computes
    the distances' dot, timed as the kernels' yardstick.  Never called by
    the port.  ``check`` (a [C, N] distance matrix) is compared with
    (256 - dot) / 2 first.  Returns (device ms, what was timed) or
    (None, why not)."""
    import torch

    a = _bipolar(cand)
    b = torch.zeros((n_pad, 256), dtype=torch.int8, device=kp.device)
    b[: kp.shape[0]] = _bipolar(kp)
    try:
        dot = torch._int_mm(a, b.t())
    except RuntimeError as e:  # a yardstick only: report it, do not fail the run
        return None, f"{label}: not timed, {e}"
    if check is not None and not torch.equal((256 - dot[:, : check.shape[1]]) // 2, check):
        return None, f"{label}: not timed, its distances differ from the plain version"
    return _device_ms(lambda: torch._int_mm(a, b.t()), None), label


def _timing(k, what, *, wrapper, plain, bound, device, library, max_abs_err, store_floor=None, **extra) -> dict:
    """One kernel's event timings, taken now, and its profiler timings
    (``device``: a function returning ms; ``library``: one returning
    (ms or None, what); ``store_floor``: None or one returning the device
    ms of a store-only pass over the kernel's output), taken later by
    :func:`_entry`."""
    return dict(k=k, what=what, wrapper=wrapper, plain=plain, bound=bound, device=device, library=library,
                store_floor=store_floor, max_abs_err=max_abs_err, extra=extra)


def _entry(t: dict) -> dict:
    """Run a :func:`_timing`'s profiler measurements; print and return the
    kernel's JSON entry (its launch counts still to fill).  ``ms`` is the
    wrapper-inclusive time (CUDA events around one Python call, as in the
    port's first slices), ``device_ms`` the kernel's own device time."""
    k = t["k"]
    device_ms = t["device"]()
    lib_ms, lib_how = t["library"]()
    bound_ms, bound_by, basis = t["bound"]
    e = dict(
        name=k.name, route="cuda", source=k.source, replaces=k.replaces, max_abs_err=t["max_abs_err"],
        ms=t["wrapper"], device_ms=device_ms, plain_ms=t["plain"],
        bound_ms=bound_ms, bound_by=bound_by, bound_basis=basis, share_of_bound=bound_ms / device_ms,
        library_ms=lib_ms, library_call=lib_how, **t["extra"],
    )
    lib = "none" if lib_ms is None else f"{lib_ms:.4f} ms device time ({lib_how})"
    floor = ""
    if t["store_floor"] is not None:
        e["store_floor_ms"] = t["store_floor"]()
        floor = (f"; store-only pass over its output (fill_) {e['store_floor_ms']:.4f} ms, "
                 f"{100 * e['store_floor_ms'] / device_ms:.1f}% of the kernel's time")
    print(f"{k.name} {t['what']}: device {device_ms:.4f} ms (torch.profiler), wrapper-inclusive events "
          f"{e['ms']:.4f} ms, plain {e['plain_ms']:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} ({basis}), "
          f"{100 * e['share_of_bound']:.1f}% of bound; library {lib}{floor}")
    return e


def kernel_phase(frame, cfg, dev):
    """Compare K1 and K2 with their plain versions in every case; return a
    function that times them at the main path's shapes and returns their
    JSON entries (launch counts still to fill)."""
    import numpy as np
    import torch

    from rgbd_visualodometry_tpu_torch import kernels
    from rgbd_visualodometry_tpu_torch.ops import fast, image as im, matching

    gray = im.rgb_to_gray(torch.from_numpy(frame.rgb).to(dev))
    pyr = im.build_pyramid(gray, cfg.level_pyramid, cfg.scale_factor)
    quotas = im.features_per_level(cfg.number_of_features, cfg.level_pyramid, cfg.scale_factor)
    levels = [lvl for lvl, q in zip(pyr, quotas) if q > 0]
    rng = np.random.default_rng(0)
    odd = im.gaussian_blur(torch.from_numpy(rng.uniform(0, 255, (479, 641)).astype(np.float32)).to(dev), 7, 2.0)
    tables = {
        "main pyramid": (levels, 1),
        "641x479 pyramid": (im.build_pyramid(odd, 8, 1.2), 1),
        "1x1 and 5x7 levels": ([torch.zeros(1, 1, device=dev), odd[:5, :7].contiguous(), odd[100:133, :47].contiguous(),
                                torch.full((5, 7), 3.0, device=dev), levels[-1]], 1),
        "10 levels": (im.build_pyramid(odd, 10, 1.2), 2),
    }
    for name, (table, launches) in tables.items():
        before = kernels.FAST_NMS.launches
        got = fast.fast_nms_pyramid(table)
        torch.cuda.synchronize()
        if kernels.FAST_NMS.launches != before + launches:
            raise AssertionError(f"K1 {name}: {kernels.FAST_NMS.launches - before} launches, expected {launches}")
        want = [fast.fast_nms_reference(lvl) for lvl in table]
        if name == "main pyramid":
            k1_err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        for g, w, lvl in zip(got, want, table):
            if not torch.equal(g, w):
                raise AssertionError(f"K1 fast_nms_pyramid differs from its plain version ({name}, {tuple(lvl.shape)})")
    for lvl in levels + tables["1x1 and 5x7 levels"][0]:
        if not torch.equal(fast.fast_nms(lvl), fast.fast_nms_reference(lvl)):
            raise AssertionError(f"K1 one-level fast_nms differs from its plain version on {tuple(lvl.shape)}")
    print(f"K1 fast_nms: bit-exact on {', '.join(tables)} and one level at a time; main-path levels "
          f"{[tuple(lv.shape) for lv in levels]}")

    N, C = cfg.number_of_features, cfg.max_mappoints

    def words(n):
        return torch.from_numpy(rng.integers(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32).view(np.int32)).to(dev)

    cand, kp = words(C), words(N)
    mask = torch.from_numpy(rng.random(N) >= 0.1).to(dev)
    tie_kp = kp.clone()
    tie_kp[N // 2:] = kp[: N - N // 2]  # duplicated keypoints: ties everywhere
    tie_cand = cand.clone()
    tie_cand[: C // 4] = kp[torch.arange(C // 4, device=dev) % N]  # exact hits at distance 0
    wide = words(3000)
    cases = {
        "main": (cand, kp, mask),
        "ties": (tie_cand, tie_kp, mask),
        f"ragged C={C - 1}": (cand[: C - 1].contiguous(), kp, mask),
        "all masked": (cand[:1000].contiguous(), kp, torch.zeros_like(mask)),
        "N=37, C=1000": (cand[:1000].contiguous(), kp[:37].contiguous(), mask[:37].contiguous()),
        "N=3000": (cand, wide, torch.from_numpy(rng.random(3000) >= 0.1).to(dev)),
    }
    for name, (c, k, m) in cases.items():
        got = matching.nearest_keypoints_packed(c, k, m)
        want = matching.hamming_nn_reference(c, k, m)
        torch.cuda.synchronize()
        if name == "main":
            k2_err = float(max((got.kp_index - want.kp_index).abs().max(), (got.distance - want.distance).abs().max()))
        if not (torch.equal(got.kp_index, want.kp_index) and torch.equal(got.distance, want.distance)):
            raise AssertionError(f"K2 hamming_nn differs from its plain version ({name})")
    print(f"K2 hamming_nn: exact on {', '.join(cases)}")

    def timings():
        px = sum(lv.numel() for lv in levels)
        k1 = _timing(
            kernels.FAST_NMS, f"per frame ({len(levels)} levels, {px} px, one launch)", max_abs_err=k1_err,
            wrapper=_median_ms(lambda: fast.fast_nms_pyramid(levels)),
            plain=_median_ms(lambda: [fast.fast_nms_reference(lvl) for lvl in levels]),
            bound=_bound(8 * px, K1_OPS_PER_PIXEL * px, "fp32"),
            device=lambda: _device_ms(lambda: fast.fast_nms_pyramid(levels), "fast_nms_pyramid_kernel"),
            library=lambda: (None, "none"),
        )
        k2 = _timing(
            kernels.HAMMING_NN, f"N={N} C={C}", max_abs_err=k2_err,
            wrapper=_median_ms(lambda: matching.nearest_keypoints_packed(cand, kp, mask)),
            plain=_median_ms(lambda: matching.hamming_nn_reference(cand, kp, mask)),
            bound=_bound(32 * C + 33 * N + 8 * C, 2 * 256 * C * N, "int8 tensor-core"),
            device=lambda: _device_ms(lambda: matching.nearest_keypoints_packed(cand, kp, mask), "hamming_nn_kernel"),
            library=lambda: _int_mm_ms(cand, kp, 512, label=f"torch._int_mm [{C}, 256] x [256, 512], distance half only"),
        )
        return [k1, k2]

    return timings


def _guarded_k3(cand, kp, offset: int):
    """K3's C entry on an output that is a view ``offset`` words into a
    buffer with 64 sentinel words on each side; raises if a sentinel
    changed, returns the [C, N] view.  ``offset`` 1 leaves the output
    unaligned, which takes the kernel's one-word store path."""
    import torch

    from rgbd_visualodometry_tpu_torch import kernels

    C, N, pad, sentinel = cand.shape[0], kp.shape[0], 64, -7
    buf = torch.full((C * N + 2 * pad,), sentinel, dtype=torch.int32, device=cand.device)
    out = buf[pad + offset : pad + offset + C * N]
    kernels.HAMMING_MATRIX.launch(cand, kp, C, N, out)
    torch.cuda.synchronize()
    if not (bool((buf[: pad + offset] == sentinel).all()) and bool((buf[pad + offset + C * N :] == sentinel).all())):
        raise AssertionError(f"K3 hamming_matrix wrote outside its [{C}, {N}] output (offset {offset})")
    return out.view(C, N)


def k3_phase(dev):
    """Compare K3 with its plain version, then drive its entry point once
    with the counts reset; return a function that times K3 and returns its
    JSON entry."""
    import numpy as np
    import torch

    from rgbd_visualodometry_tpu_torch import kernels
    from rgbd_visualodometry_tpu_torch.ops import matching

    rng = np.random.default_rng(3)

    def words(n):
        return torch.from_numpy(rng.integers(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32).view(np.int32)).to(dev)

    shapes = ((65536, 512), (16384, 500), (16383, 500), (16383, 37), (1000, 1), (1000, 7), (1000, 9), (1, 512),
              (16384, 3000), (0, 500), (1000, 0))
    cases = {f"{c}x{n}": (words(c), words(n)) for c, n in shapes}
    tie_kp = words(500)
    tie_kp[250:] = tie_kp[:250]  # every keypoint twice
    cases["ties 4096x500"] = (tie_kp[torch.arange(4096, device=dev) % 500].contiguous(), tie_kp)  # distance 0 hits
    err = {}
    for name, (cand, kp) in cases.items():
        c, n = cand.shape[0], kp.shape[0]
        got = matching.hamming_matrix_packed(cand, kp)
        want = matching.hamming_matrix_reference(cand, kp)
        torch.cuda.synchronize()
        if got.shape != (c, n) or not torch.equal(got, want):
            raise AssertionError(f"K3 hamming_matrix differs from its plain version at {name}")
        err[c, n] = float((got - want).abs().max()) if got.numel() else 0.0
        if got.numel():  # nothing written outside [C, N], on the aligned and the one-word store path
            for offset in (0, 1):
                if not torch.equal(_guarded_k3(cand, kp, offset), want):
                    raise AssertionError(f"K3 hamming_matrix differs from its plain version at {name}, offset {offset}")
    print(f"K3 hamming_matrix: exact at {', '.join(cases)}; no write outside [C, N] at output offsets 0 and 1 word")
    del got, want

    # the K3 path: its entry point at the parity bench's shape
    cand, kp = cases["65536x512"]
    kernels.reset_counts()
    out = matching.hamming_matrix_packed(cand, kp)
    torch.cuda.synchronize()
    launches = kernels.counts()
    print(f"launches on the hamming_matrix_packed path: {launches}")
    if launches["hamming_matrix"] != 1 or not torch.equal(out, matching.hamming_matrix_reference(cand, kp)):
        raise AssertionError(f"hamming_matrix_packed did not run through K3 once: {launches}")
    del out

    def timings():
        out = []
        for c, n in ((65536, 512), (16384, 500)):
            cand, kp = cases[f"{c}x{n}"]
            n_pad = n + (-n) % 8
            dst = torch.empty((c, n), dtype=torch.int32, device=dev)
            out.append(_timing(
                kernels.HAMMING_MATRIX, f"C={c} N={n}", max_abs_err=err[c, n],
                wrapper=_median_ms(lambda: matching.hamming_matrix_packed(cand, kp)),
                plain=_median_ms(lambda: matching.hamming_matrix_reference(cand, kp)),
                bound=_bound(32 * c + 32 * n + 4 * c * n, 2 * 256 * c * n, "int8 tensor-core"),
                device=lambda cand=cand, kp=kp: _device_ms(lambda: matching.hamming_matrix_packed(cand, kp), "hamming_matrix_kernel"),
                library=lambda cand=cand, kp=kp, c=c, n=n, n_pad=n_pad: _int_mm_ms(
                    cand, kp, n_pad, check=matching.hamming_matrix_reference(cand, kp),
                    label=f"torch._int_mm [{c}, 256] x [256, {n_pad}], the dot of (256 - dot) / 2"),
                # what this card writes: a store-only pass over the same output, never called by the port
                store_floor=lambda dst=dst: _device_ms(lambda: dst.fill_(0), None),
                launches=launches["hamming_matrix"],
            ))
        return out

    return timings


def slice_phase(frames, cfg, dev):
    """Drive ``VisualOdometry.run`` over the frames; return (the
    ``VisualOdometry``, its results, per-frame seconds after the warm-up,
    launch counts, (seconds, pruned observations) of each BA dispatch)."""
    import torch

    from rgbd_visualodometry_tpu_torch import VisualOdometry, kernels
    from rgbd_visualodometry_tpu_torch.pipeline import system

    ba_s = []
    ba_step = system.backend.ba_step

    def timed_ba(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = ba_step(*a, **k)
        torch.cuda.synchronize()
        ba_s.append((time.perf_counter() - t0, int(out[1].num_pruned)))
        return out

    stamps = []

    def feed():
        for f in frames:
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            yield f.rgb, f.depth, f.timestamp
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    vo = VisualOdometry(cfg, device=dev)
    system.backend.ba_step = timed_ba
    kernels.reset_counts()
    results = vo.run(feed())
    torch.cuda.synchronize()
    counts = kernels.counts()
    system.backend.ba_step = ba_step
    step_s = [b - a for a, b in zip(stamps[:-1], stamps[1:])][WARMUP_FRAMES:]
    return vo, results, step_s, counts, ba_s


def check_run(name, frames, cfg, run) -> dict:
    """Print and check one run of :func:`slice_phase`; return its counts."""
    from rgbd_visualodometry_tpu_torch.io.synthetic import _pose_inverse as pose_inverse
    from rgbd_visualodometry_tpu_torch.evaltools import ate_rmse

    vo, results, step_s, counts, ba_runs = run
    ba_s = [sec for sec, _ in ba_runs]
    tracked = sum(r.tracked for r in results)
    gt_xyz = [pose_inverse(f.T_c_w)[4:7] for f in frames]
    ate = ate_rmse(
        [r.timestamp for r in results if r.tracked], [r.pose_w_c[4:7] for r in results if r.tracked],
        [f.timestamp for f in frames], gt_xyz,
    )
    ms_frame = 1e3 * statistics.median(step_s)
    # needs_ba = is_keyframe & enable_local_optimization (frontend.apply_updates)
    ba_requests = sum(r.is_keyframe for r in results) if cfg.enable_local_optimization else 0
    print(f"{name}: {tracked}/{len(frames)} tracked, ATE {ate * 100:.3f} cm, "
          f"{ms_frame:.2f} ms/frame median over frames {WARMUP_FRAMES}-{len(frames) - 1} "
          f"(p90 {1e3 * sorted(step_s)[int(0.9 * len(step_s))]:.2f} ms), keyframes "
          f"{sum(r.is_keyframe for r in results)}, map points {results[-1].stats['num_mappoints']}")
    if ba_s:
        print(f"{name}: {vo.ba_dispatches} BA dispatches for {ba_requests} records asking for BA, "
              f"BA {1e3 * statistics.median(ba_s):.2f} ms/dispatch median "
              f"(min {1e3 * min(ba_s):.2f}, max {1e3 * max(ba_s):.2f}), "
              f"{sum(n for _, n in ba_runs)} observations pruned")
    print(f"launches on the {name} path: {counts}")
    if len(results) != len(frames) or tracked != len(frames):
        raise AssertionError(f"{name}: tracked {tracked} of {len(frames)} frames")
    if not (math.isfinite(ate) and ate < ATE_LIMIT_M):
        raise AssertionError(f"{name}: ATE {ate} m is not below {ATE_LIMIT_M} m")
    if counts["fast_nms"] != len(frames):  # every level of a frame in one launch
        raise AssertionError(f"{name}: fast_nms launched {counts['fast_nms']} times, expected {len(frames)}")
    if counts["hamming_nn"] != len(frames):
        raise AssertionError(f"{name}: hamming_nn launched {counts['hamming_nn']} times, expected {len(frames)}")
    if vo.ba_dispatches != ba_requests or len(ba_s) != ba_requests:
        raise AssertionError(f"{name}: {vo.ba_dispatches} BA dispatches for {ba_requests} requests")
    if cfg.enable_local_optimization and not ba_requests:
        raise AssertionError(f"{name}: BA never ran")
    return counts


def _relax_stage_timers(stages: dict):
    """Wrap the relaxation's stages (co-observation graph, appearance graph,
    solve, apply) in synchronised host timers appending to ``stages``;
    returns a function that removes them."""
    import torch

    from rgbd_visualodometry_tpu_torch.pipeline import globalopt

    patched = []
    for mod, name, label in ((globalopt.loopclosure, "build_coobservation_graph", "co-observation graph"),
                             (globalopt.loopclosure, "build_appearance_graph", "appearance graph"),
                             (globalopt.posegraph, "optimize_pose_graph_graphed", "solve"),
                             (globalopt, "apply_relaxation", "apply")):
        fn = getattr(mod, name)

        def timed(*a, _fn=fn, _label=label, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(*a, **k)
            torch.cuda.synchronize()
            stages.setdefault(_label, []).append(time.perf_counter() - t0)
            return out

        setattr(mod, name, timed)
        patched.append((mod, name, fn))
    return lambda: [setattr(mod, name, fn) for mod, name, fn in patched]


def loop_phase(cfg, frames, depths, dev, relax_async: bool) -> dict:
    """``VisualOdometry.run`` with online loop closure over the faulted
    circuit, relaxations synchronous or on the worker thread, the launch
    counts reset just before.  Checks that every frame is tracked, that at
    least one relaxation ran and one detected a loop and acted, that the
    trajectory file equals the corrected in-memory poses, that every pose is
    finite, and that K1 and K2 launched once per frame.  Prints each acting
    relaxation's streamed ATE before and after it, its edge counts, its
    stage times (synchronous run), the frame times with and without a
    relaxation in flight (asynchronous run) and the non-stalling contract's
    numbers (:func:`stall_numbers`; its limits belong to the 320x240
    scenario of :func:`stall_contract_phase`).  In the asynchronous run
    every relaxation the worker computed must equal ``compute_relaxation``
    on its snapshot to the bit, and in both every call through
    ``ops.replay`` (captured and replayed after the first at a shape) the
    eager call, and every solve the eager solve on the unpadded graph.  Returns the launch counts."""
    import tempfile

    import numpy as np
    import torch

    from rgbd_visualodometry_tpu_torch import VisualOdometry, kernels
    from rgbd_visualodometry_tpu_torch.evaltools import ate_rmse
    from rgbd_visualodometry_tpu_torch.io.synthetic import _pose_inverse as pose_inverse
    from rgbd_visualodometry_tpu_torch.io.trajectory import read_trajectory
    from rgbd_visualodometry_tpu_torch.pipeline import globalopt

    name = f"loop closure ({'async' if relax_async else 'sync'})"
    cfg = cfg.replace(relax_async=relax_async)
    gt_ts = np.asarray([f.timestamp for f in frames])
    gt_xyz = np.asarray([pose_inverse(f.T_c_w)[4:7] for f in frames])
    vo = VisualOdometry(cfg, device=dev)
    relaxes = []  # (streamed ts, streamed poses, report, wall s)

    def streamed():
        return (np.asarray([r.timestamp for r in vo.results]), np.asarray([r.pose_w_c for r in vo.results]))

    global_relax, finish = vo.global_relax, vo._finish_async_relax

    def spied_relax(**kw):
        ts, ps = streamed()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = global_relax(**kw)
        torch.cuda.synchronize()
        relaxes.append((ts, ps, rep, time.perf_counter() - t0))
        return rep

    applied = []

    def spied_finish(wait=False):
        ts, ps = streamed()
        rlx = finish(wait)
        if rlx is not None:
            relaxes.append((ts, ps, rlx.report, None))
            applied.append(rlx)
        return rlx

    vo.global_relax, vo._finish_async_relax = spied_relax, spied_finish
    stamps, in_flight = [], []

    def feed():
        for f, d in zip(frames, depths):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            in_flight.append(vo._relax_thread is not None)
            yield f.rgb, d, f.timestamp
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    stages: dict = {}
    replays, restore_replays = _spy_replays()
    if relax_async:
        kept, restore_relax = _spy_relaxations()
    else:
        restore_relax = _relax_stage_timers(stages)

    def restore():
        restore_relax()
        restore_replays()
    with tempfile.TemporaryDirectory() as tmp:
        traj = os.path.join(tmp, "traj.txt")
        kernels.reset_counts()
        try:
            results = vo.run(feed(), trajectory_path=traj)
            torch.cuda.synchronize()
            counts = kernels.counts()
        finally:
            restore()
        file_ts, file_poses = read_trajectory(traj)
    entries = vo._trajectory_entries()
    est = np.asarray([r.pose_w_c for r in results])
    tracked = sum(r.tracked for r in results)
    ate = ate_rmse([r.timestamp for r in results], est[:, 4:7], gt_ts, gt_xyz)
    frame_s = np.diff(stamps)
    acted = 0
    print(f"{name}: {tracked}/{len(frames)} tracked, {vo.num_auto_relaxes} relaxations, final ATE {100 * ate:.3f} cm, "
          f"{vo.ba_dispatches} BA dispatches; launches {counts}")
    for ts, ps, rep, wall in relaxes:
        acting = rep.kf_ts.size and rep.num_loop_edges + rep.num_appearance_edges
        line = (f"  relax after {len(ts)} frames: {rep.num_edges} co-observation edges ({rep.num_loop_edges} loop), "
                f"{rep.num_appearance_edges} appearance, {rep.num_chain_edges} chain"
                + (f", {1e3 * wall:.1f} ms" if wall is not None else ""))
        if acting:
            acted += 1
            corrected = globalopt.correct_trajectory(rep, ts - vo.time_base, ps)
            line += (f"; streamed ATE {100 * ate_rmse(ts, ps[:, 4:7], gt_ts, gt_xyz):.3f} -> "
                     f"{100 * ate_rmse(ts, corrected[:, 4:7], gt_ts, gt_xyz):.3f} cm, "
                     f"max correction {100 * rep.max_correction_m:.2f} cm")
        else:
            line += "; no loop: no-op"
        print(line)
    for label, secs in stages.items():
        print(f"  {label}: {', '.join(f'{1e3 * x:.1f}' for x in secs)} ms")
    med = 1e3 * statistics.median(frame_s[WARMUP_FRAMES:])
    busy = [1e3 * x for x, f in zip(frame_s, in_flight) if f]
    print(f"  frame time median {med:.1f} ms over frames {WARMUP_FRAMES}-{len(frames) - 1}, max {1e3 * frame_s.max():.1f} ms"
          + (f"; with a relaxation in flight: median {statistics.median(busy):.1f} ms over {len(busy)} frames"
             if busy else ""))
    print(f"  the non-stalling contract's numbers (printed, not asserted at 640x480): {_stall_line(frame_s)}")
    if relax_async:
        _check_relaxations(name, kept, applied)
    _check_replays(name, replays)
    if len(results) != len(frames) or tracked != len(frames):
        raise AssertionError(f"{name}: tracked {tracked} of {len(frames)} frames")
    if vo.num_auto_relaxes < 1 or not acted:
        raise AssertionError(f"{name}: {vo.num_auto_relaxes} relaxations, {acted} acting")
    if not np.isfinite(est).all() or not np.isfinite(ate):
        raise AssertionError(f"{name}: a pose is not finite")
    if len(file_ts) != len(entries) or not np.allclose(file_poses, np.asarray([p for _, p in entries]), atol=1e-6):
        raise AssertionError(f"{name}: the trajectory file differs from the corrected in-memory poses")
    if counts["fast_nms"] != len(frames) or counts["hamming_nn"] != len(frames):
        raise AssertionError(f"{name}: launches {counts}, expected fast_nms and hamming_nn {len(frames)} times each")
    return counts


def contract_config():
    """The config of the JAX package's tier-1
    ``tests/test_loopclosure.py::test_async_relax_does_not_stall_frame_loop``
    (``:635-643``), field for field: 320x240, 300 features over 4 levels,
    32 keyframes, local BA, a relaxation every 6 keyframes on the worker
    thread, a 1 s loop gap."""
    from rgbd_visualodometry_tpu_torch import VOConfig

    return VOConfig(
        image_width=320, image_height=240,
        camera_fx=258.6, camera_fy=258.2, camera_cx=159.3, camera_cy=127.6,
        number_of_features=300, level_pyramid=4,
        max_keyframes=32, max_mappoints=4096, max_obs_per_mappoint=8,
        pnp_max_points=512, triangulation_batch=128, ransac_hypotheses=64,
        ba_max_poses=8, ba_max_points=1024,
        relax_every_kf=6, relax_loop_gap_s=1.0, relax_async=True,
    )


def stall_numbers(frame_s) -> dict:
    """The reference's non-stalling contract (``tests/test_loopclosure.py:686-702``)
    read on per-frame wall times: over the frames after the first 8, the
    median, the spikes (frames slower than 3 x median + 50 ms; at most 2
    pass), the total and its limit (1.6 x frames x median + 3 s), and the
    total over frames x median."""
    steady = list(frame_s[CONTRACT_SKIP:])
    med = statistics.median(steady)
    return dict(median_s=med, spikes_s=[t for t in steady if t > 3.0 * med + 0.05], total_s=sum(steady),
                limit_s=1.6 * len(steady) * med + 3.0, ratio=sum(steady) / (len(steady) * med))


def _stall_line(frame_s) -> str:
    st = stall_numbers(frame_s)
    return (f"median {1e3 * st['median_s']:.1f} ms over frames {CONTRACT_SKIP}-{len(frame_s) - 1}, "
            f"{len(st['spikes_s'])} spikes > 3 x median + 50 ms {[round(1e3 * float(t), 1) for t in st['spikes_s']]} ms, "
            f"total {st['total_s']:.2f} s of limit {st['limit_s']:.2f} s ({st['ratio']:.3f} x frames x median)")


def _spy_relaxations():
    """Patch ``globalopt.compute_relaxation`` so that each call on the async
    worker thread keeps a clone of the snapshot it was given (taken on the
    worker's stream, before it computes), its config and keyword arguments
    and the relaxation it returned.  Returns ``(kept, restore)``."""
    import threading

    import torch
    from torch.utils import _pytree as pytree

    from rgbd_visualodometry_tpu_torch.pipeline import globalopt

    real, kept = globalopt.compute_relaxation, []

    def spied(state, cfg, **kw):
        if threading.current_thread().name != "vo-relax":
            return real(state, cfg, **kw)
        snap = pytree.tree_map(torch.clone, state)
        rlx = real(state, cfg, **kw)
        kept.append((snap, cfg, kw, rlx))
        return rlx

    globalopt.compute_relaxation = spied
    return kept, lambda: setattr(globalopt, "compute_relaxation", real)


def relaxation_mismatches(kept, applied) -> list[str]:
    """Hold every relaxation that the async run applied to
    ``compute_relaxation`` called again, on this thread and stream, on the
    worker's snapshot (:func:`_spy_relaxations`): ``delta_w``,
    ``snap_valid``, ``snap_ts``, ``ref_delta_w`` and every field of the
    report equal to the bit.  Returns what differs."""
    import numpy as np
    import torch

    from rgbd_visualodometry_tpu_torch.pipeline import globalopt

    torch.cuda.synchronize()
    if [id(r) for *_, r in kept] != [id(r) for r in applied]:
        return [f"the run consumed {len(applied)} relaxations, the worker computed {len(kept)}"]
    bad = []
    for n, (snap, cfg, kw, got) in enumerate(kept):
        want = globalopt.compute_relaxation(snap, cfg, **kw)
        torch.cuda.synchronize()
        for f in ("delta_w", "snap_valid", "snap_ts", "ref_delta_w"):
            if not torch.equal(getattr(got, f), getattr(want, f)):
                bad.append(f"relaxation {n}: {f}")
        for f, x in vars(got.report).items():
            y = getattr(want.report, f)
            if not (np.array_equal(x, y) if isinstance(x, np.ndarray) else x == y):
                bad.append(f"relaxation {n}: report.{f}")
    return bad


def _check_relaxations(name, kept, applied) -> None:
    bad = relaxation_mismatches(kept, applied)
    acting = sum(bool(r.report.kf_ts.size) for r in applied)
    print(f"{name}: {len(applied)} relaxations from the worker ({acting} acting), "
          + (f"NOT equal to compute_relaxation on their snapshots: {bad}" if bad
             else "each equal to the bit to compute_relaxation on its snapshot"))
    if bad:
        raise AssertionError(f"{name}: the async relaxations differ from compute_relaxation: {bad}")


# the tracking step's pose rounds, 4 calls through ops.replay a frame or a
# fleet step (the fleet's: their vmapped bodies, ops.replay.vmapped): their
# first 3 calls at each key (eager, captured, replayed) and every 16th after
# are held, the relaxation's stages every call
_POSE_STAGES = ("_ransac", "_refine")


def _spy_replays():
    """Patch ``ops.replay.replayed`` (through which ``compute_relaxation``
    runs its solve and its appearance pair registration on the card, and
    the tracking step its RANSAC and pose LM, vmapped in ``MultiStreamVO``)
    to keep clones of the inputs and the outputs of the calls
    :data:`_POSE_STAGES` says.  Returns ``(calls, restore)``."""
    try:
        from rgbd_visualodometry_tpu_torch.ops import replay
    except ImportError:  # a tree from before the replays (tools/port_ab.py): nothing to hold
        return [], lambda: None
    real, calls, seen = replay.replayed, [], {}

    def spied(fn, *args, **kw):
        out = real(fn, *args, **kw)
        key = (fn, tuple(a.shape for a in args), tuple(sorted(kw.items())))
        n = seen[key] = seen.get(key, 0) + 1
        if fn.__name__ not in _POSE_STAGES or n <= 3 or n % 16 == 0:
            calls.append((fn, [a.clone() for a in args], kw, out))
        return out

    replay.replayed = spied
    return calls, lambda: setattr(replay, "replayed", real)


def replay_mismatches(calls) -> list[str]:
    """Hold every call of :func:`_spy_replays` (eager at a new shape,
    captured at the next call or after the async worker, then replayed) to
    its function called eagerly on the same inputs, and every pose-graph solve (on the graph padded to its bucket)
    also to the eager solve on the unpadded graph, its valid edges, which
    come first: equal to the bit.  Returns what differs."""
    import torch
    from torch.utils import _pytree as pytree

    from rgbd_visualodometry_tpu_torch.ops import posegraph

    torch.cuda.synchronize()
    bad = []
    for n, (fn, args, kw, got) in enumerate(calls):
        wants = {"eager": fn(*args, **kw)}
        if fn is posegraph._optimize_flat:
            e = int(args[5].sum())
            wants["eager, unpadded"] = fn(args[0], *(a[:e] for a in args[1:6]), args[6], **kw)
        torch.cuda.synchronize()
        for label, want in wants.items():
            if not all(torch.equal(g, w) for g, w in zip(pytree.tree_leaves(got), pytree.tree_leaves(want))):
                bad.append(f"{fn.__name__} call {n} {[tuple(a.shape) for a in args[:2]]} vs {label}")
    return bad


def _check_replays(name, calls) -> None:
    bad = replay_mismatches(calls)
    solves = sum(fn.__name__ == "_optimize_flat" for fn, *_ in calls)
    rounds = sum(fn.__name__ in _POSE_STAGES for fn, *_ in calls)
    bodies = getattr(sys.modules.get("rgbd_visualodometry_tpu_torch.ops.replay"), "_bodies", {})  # the fleet's vmapped bodies
    vmapped = sum(fn in bodies for fn, *_ in calls)
    print(f"{name}: {len(calls)} calls through ops.replay held ({solves} solves, {rounds} pose-round stages, {vmapped} of "
          f"them vmapped; eager at a new shape, then captured and replayed), " + (
              f"NOT equal to eager: {bad}" if bad else
              "each equal to the bit to the eager call, and each solve to the unpadded one"))
    if bad:
        raise AssertionError(f"{name}: a replayed call differs from the eager one: {bad}")


def _worker_stage_timers():
    """Host timers (no synchronise) around the relaxation's stages when
    they run on the async worker thread: the co-observation graph, the
    appearance graph, the solve and the whole ``compute_relaxation``.
    Returns ``(records [(stage, seconds)], restore)``."""
    import threading

    from rgbd_visualodometry_tpu_torch.pipeline import globalopt

    records, patched = [], []
    solve = "optimize_pose_graph_graphed" if hasattr(globalopt.posegraph, "optimize_pose_graph_graphed") \
        else "optimize_pose_graph"
    for mod, name, label in ((globalopt.loopclosure, "build_coobservation_graph", "co-observation"),
                             (globalopt.loopclosure, "build_appearance_graph", "appearance"),
                             (globalopt.posegraph, solve, "solve"),
                             (globalopt, "compute_relaxation", "total")):
        fn = getattr(mod, name)

        def timed(*a, _fn=fn, _label=label, **k):
            if threading.current_thread().name != "vo-relax":
                return _fn(*a, **k)
            t = time.perf_counter()
            try:
                return _fn(*a, **k)
            finally:
                records.append((_label, time.perf_counter() - t))

        setattr(mod, name, timed)
        patched.append((mod, name, fn))
    return records, lambda: [setattr(mod, name, fn) for mod, name, fn in patched]


def stall_contract_run(dev) -> dict:
    """The JAX package's tier-1 ``test_async_relax_does_not_stall_frame_loop``
    on the card: :func:`contract_config` over the 64-frame faulted circuit
    (:func:`loop_frames`), a warm-up instance, then a timed instance whose
    frame clock runs around the generator's ``yield`` as the test's does
    (``:668-673``, no synchronise: it includes the lagged record reads and
    the relaxations' start and finish).  The warm-up's relaxations are
    held to the bit to ``compute_relaxation`` on their snapshots; the
    launch counts are reset just before the timed run.  Per frame of the
    timed run: its wall time, whether a relaxation was in flight, the time
    of the blocking record reads (``out.packed.cpu()``, read once more
    before ``_materialize`` reads it) and of ``_start_async_relax`` and
    ``_finish_async_relax``.  Returns the numbers and the list of
    failures: the contract's three assertions as the test writes them,
    every frame tracked, the file equal to memory, K1 and K2 once per
    frame, and the relaxations' bit-equality."""
    import tempfile

    import numpy as np
    import torch

    from rgbd_visualodometry_tpu_torch import VisualOdometry, kernels
    from rgbd_visualodometry_tpu_torch.evaltools import ate_rmse
    from rgbd_visualodometry_tpu_torch.io.synthetic import _pose_inverse as pose_inverse
    from rgbd_visualodometry_tpu_torch.io.trajectory import read_trajectory

    cfg = contract_config()
    frames, depths = loop_frames(cfg)
    feed = [(f.rgb, d, f.timestamp) for f, d in zip(frames, depths)]
    t0 = time.perf_counter()
    warm = VisualOdometry(cfg, device=dev)
    applied, finish = [], warm._finish_async_relax

    def spied_finish(wait=False):
        rlx = finish(wait)
        if rlx is not None:
            applied.append(rlx)
        return rlx

    warm._finish_async_relax = spied_finish
    kept, restore = _spy_relaxations()
    replays, restore_replays = _spy_replays()
    try:
        warm.run(iter(feed))
    finally:
        restore_replays()
        restore()
    mismatches = relaxation_mismatches(kept, applied) + replay_mismatches(replays)
    out = dict(warm_s=time.perf_counter() - t0, warm_relaxations=len(applied), warm_replays=len(replays),
               warm_acting=sum(bool(r.report.kf_ts.size) for r in applied), mismatches=mismatches)
    del warm, kept, applied, spied_finish, replays

    vo = VisualOdometry(cfg, device=dev)
    frame_s, in_flight, read_s, hook_s = [], [], [], []
    materialize = vo._materialize

    def read_first(ts, step_out, *rest):
        t = time.perf_counter()
        step_out.packed.cpu()  # the blocking read alone; _materialize's own copy is then immediate
        read_s[-1] += time.perf_counter() - t
        return materialize(ts, step_out, *rest)

    def timed(fn):
        def call(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                hook_s[-1] += time.perf_counter() - t
        return call

    vo._materialize = read_first
    vo._start_async_relax, vo._finish_async_relax = timed(vo._start_async_relax), timed(vo._finish_async_relax)

    def stream():
        last = time.perf_counter()
        for item in feed:
            read_s.append(0.0)
            hook_s.append(0.0)
            busy = vo._relax_thread is not None
            yield item
            now = time.perf_counter()
            frame_s.append(now - last)
            in_flight.append(busy or vo._relax_thread is not None)
            last = now
        read_s.append(0.0)  # the run's close: final flush and relaxation
        hook_s.append(0.0)

    stages, restore = _worker_stage_timers()
    with tempfile.TemporaryDirectory() as tmp:
        traj = os.path.join(tmp, "traj.txt")
        kernels.reset_counts()
        try:
            results = vo.run(stream(), trajectory_path=traj)
        finally:
            restore()
        torch.cuda.synchronize()
        counts = kernels.counts()
        file_ts, file_poses = read_trajectory(traj)
    entries = vo._trajectory_entries()
    est = np.asarray([r.pose_w_c for r in results])
    gt_xyz = np.asarray([pose_inverse(f.T_c_w)[4:7] for f in frames])
    tracked = sum(r.tracked for r in results)
    st = stall_numbers(frame_s)
    worker = [{}]  # per relaxation on the worker: stage -> host s
    for label, sec in stages:
        worker[-1][label] = worker[-1].get(label, 0.0) + sec
        if label == "total":
            worker.append({})
    out.update(st, frame_s=frame_s, in_flight=in_flight, read_s=read_s[:len(frame_s)], hook_s=hook_s[:len(frame_s)],
               worker_stages_s=worker[:-1], relaxations=vo.num_auto_relaxes, tracked=tracked, launches=counts,
               ate_m=ate_rmse([r.timestamp for r in results], est[:, 4:7], [f.timestamp for f in frames], gt_xyz))
    failures = [f"a relaxation or solve differs from its synchronous or eager recomputation: {m}" for m in mismatches]
    if tracked != len(frames) or len(results) != len(frames):
        failures.append(f"tracked {tracked} of {len(frames)} frames")
    if vo.num_auto_relaxes < 3:
        failures.append(f"{vo.num_auto_relaxes} relaxations: too few relaxes to exercise the contract (>= 3)")
    if len(st["spikes_s"]) > 2:
        failures.append(f"async relax stalled the loop {len(st['spikes_s'])} times (at most 2)")
    if st["total_s"] > st["limit_s"]:
        failures.append(f"aggregate overhead too high: {st['total_s']:.2f} s > {st['limit_s']:.2f} s")
    if len(file_ts) != len(entries) or not np.allclose(file_poses, np.asarray([p for _, p in entries]), atol=1e-6):
        failures.append("the trajectory file differs from the corrected in-memory poses")
    if counts["fast_nms"] != len(frames) or counts["hamming_nn"] != len(frames):
        failures.append(f"launches {counts}, expected fast_nms and hamming_nn {len(frames)} times each")
    out["failures"] = failures
    return out


def stall_contract_phase(dev) -> dict:
    """Print :func:`stall_contract_run`, frame by frame, and raise on any of
    its failures.  Returns the timed run's launch counts."""
    name = "stall contract (320x240 async, the JAX package's tier-1 test)"
    r = stall_contract_run(dev)
    print(f"{name}: warm-up instance {r['warm_s']:.1f} s, {r['warm_relaxations']} relaxations from the worker "
          f"({r['warm_acting']} acting), {r['warm_replays']} calls through ops.replay, "
          + (f"NOT equal to compute_relaxation on their snapshots, or to eager calls: {r['mismatches']}"
             if r["mismatches"] else "each relaxation equal to the bit to compute_relaxation on its snapshot, "
             "each replayed call to the eager one, each solve to the unpadded one"))
    for n, st in enumerate(r["worker_stages_s"]):
        print(f"  relaxation {n} on the worker (host time): "
              + ", ".join(f"{label} {1e3 * sec:.1f} ms" for label, sec in st.items()))
    for k, (s, busy, rd, hk) in enumerate(zip(r["frame_s"], r["in_flight"], r["read_s"], r["hook_s"])):
        print(f"  frame {k}: {1e3 * s:.1f} ms"
              + (f", relaxation in flight: record reads {1e3 * rd:.1f} ms, relax start/finish {1e3 * hk:.1f} ms, "
                 f"the rest {1e3 * (s - rd - hk):.1f} ms" if busy else f" (record reads {1e3 * rd:.1f} ms)"))
    steady = range(CONTRACT_SKIP, len(r["frame_s"]))
    busy = [k for k in steady if r["in_flight"][k]]
    calm = [k for k in steady if not r["in_flight"][k]]
    med = lambda key, ks: 1e3 * statistics.median([r[key][k] for k in ks]) if ks else float("nan")  # noqa: E731
    print(f"{name}: {r['tracked']}/{len(r['frame_s'])} tracked, {r['relaxations']} relaxations, ATE "
          f"{100 * r['ate_m']:.3f} cm (printed; the test's 5 cm bound is not part of the contract here); "
          f"{_stall_line(r['frame_s'])}; frames {CONTRACT_SKIP}+ with a relaxation in flight: {len(busy)}, median "
          f"{med('frame_s', busy):.1f} ms (record reads {med('read_s', busy):.1f} ms), without: {len(calm)}, median "
          f"{med('frame_s', calm):.1f} ms (record reads {med('read_s', calm):.1f} ms); launches {r['launches']}")
    if r["failures"]:
        raise AssertionError(f"{name}: {r['failures']}")
    return r["launches"]


def offline_relax(run, frames):
    """One ``global_relax`` on the finished full-VO run (its 128-keyframe
    capacity makes the solve [768, 768]); checks that the corrected
    trajectory's ATE stays under the limit."""
    import numpy as np
    import torch

    from rgbd_visualodometry_tpu_torch.evaltools import ate_rmse
    from rgbd_visualodometry_tpu_torch.io.synthetic import _pose_inverse as pose_inverse
    from rgbd_visualodometry_tpu_torch.pipeline import globalopt

    vo, results = run[0], run[1]
    stages: dict = {}
    restore = _relax_stage_timers(stages)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = vo.global_relax()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        restore()
    ts = np.asarray([r.timestamp for r in results])
    est = np.asarray([r.pose_w_c for r in results])
    corrected = globalopt.correct_trajectory(rep, ts - vo.time_base, est)
    gt_ts = [f.timestamp for f in frames]
    gt_xyz = [pose_inverse(f.T_c_w)[4:7] for f in frames]
    before, after = (ate_rmse(ts, p[:, 4:7], gt_ts, gt_xyz) for p in (est, corrected))
    K = vo.state.kf_pose.shape[0]
    print(f"offline relax of the full-VO run: {1e3 * wall:.1f} ms ([{6 * K}, {6 * K}] solve), {rep.num_edges} "
          f"co-observation edges ({rep.num_loop_edges} loop), {rep.num_appearance_edges} appearance, "
          f"{rep.num_chain_edges} chain; ATE {100 * before:.3f} -> {100 * after:.3f} cm; stages "
          + ", ".join(f"{label} {1e3 * sum(x):.1f} ms" for label, x in stages.items()))
    if not (np.isfinite(corrected).all() and after < ATE_LIMIT_M):
        raise AssertionError(f"offline relax: ATE {after} m is not below {ATE_LIMIT_M} m")


def _run_cli(argv, label: str) -> tuple[int, str, dict]:
    """``cli.main(argv)`` in this process, so the launch counters see its
    kernels; the counts are reset just before.  Prints what it printed.
    Returns (exit code, that text, numbers): the launch counts, the wall
    seconds of ``VisualOdometry.run`` and of ``global_relax`` between two
    synchronises, the frames and the host time between consecutive
    frames."""
    import numpy as np
    import torch

    from rgbd_visualodometry_tpu_torch import cli, kernels
    from rgbd_visualodometry_tpu_torch.pipeline.system import VisualOdometry

    run, process_async, relax = VisualOdometry.run, VisualOdometry.process_async, VisualOdometry.global_relax
    numbers, stamps = {}, []

    def timed_run(self, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run(self, *a, **k)
        torch.cuda.synchronize()
        numbers.update(run_s=time.perf_counter() - t0, frames=len(out))
        return out

    def timed_relax(self, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = relax(self, *a, **k)
        torch.cuda.synchronize()
        numbers["relax_s"] = time.perf_counter() - t0
        return out

    def stamped(self, *a, **k):
        stamps.append(time.perf_counter())
        return process_async(self, *a, **k)

    VisualOdometry.run, VisualOdometry.process_async, VisualOdometry.global_relax = timed_run, stamped, timed_relax
    buf = io.StringIO()
    t0 = time.perf_counter()
    kernels.reset_counts()
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        torch.cuda.synchronize()
    finally:
        VisualOdometry.run, VisualOdometry.process_async, VisualOdometry.global_relax = run, process_async, relax
        print("\n".join(f"  | {ln}" for ln in buf.getvalue().strip().splitlines()))
    numbers.update(counts=kernels.counts(), wall_s=time.perf_counter() - t0, frame_s=np.diff(stamps))
    frame_s = numbers["frame_s"]
    print(f"CLI {label}: rc {rc}, {numbers.get('frames')} frames, VisualOdometry.run {numbers.get('run_s', 0):.2f} s "
          f"({1e3 * numbers.get('run_s', 0) / max(numbers.get('frames', 0), 1):.1f} ms/frame, first frame included), "
          f"median {1e3 * float(np.median(frame_s[WARMUP_FRAMES:])) if len(frame_s) > WARMUP_FRAMES else float('nan'):.1f} "
          f"ms between frames {WARMUP_FRAMES}-{len(stamps) - 1}; "
          + (f"global_relax {1e3 * numbers['relax_s']:.1f} ms; " if "relax_s" in numbers else "")
          + f"cli.main {numbers['wall_s']:.2f} s; launches {numbers['counts']}")
    return rc, buf.getvalue(), numbers


def _check_cli(label, rc, text, numbers, frames: int) -> None:
    """The CLI's exit code, its "N/N frames tracked" line and K1/K2 once per
    frame."""
    m = re.search(r"^(\d+)/(\d+) frames tracked in ", text, re.M)
    if rc != 0 or m is None or (int(m.group(1)), int(m.group(2))) != (frames, frames):
        raise AssertionError(f"CLI {label}: rc {rc}, tracked {m.group(0) if m else None}, expected {frames}/{frames}")
    c = numbers["counts"]
    if c["fast_nms"] != frames or c["hamming_nn"] != frames:
        raise AssertionError(f"CLI {label}: launches {c}, expected fast_nms and hamming_nn {frames} times each")


def _npz_equal(a: str, b: str, names=None) -> list[str]:
    """The arrays (all, or those named) that differ between two ``.npz``."""
    import numpy as np

    with np.load(a) as x, np.load(b) as y:
        keys = sorted(x.files) if names is None else names
        if names is None and sorted(x.files) != sorted(y.files):
            return ["<key sets>"]
        return [k for k in keys if x[k].dtype != y[k].dtype or x[k].shape != y[k].shape or not np.array_equal(x[k], y[k])]


def cli_phase(dev) -> dict:
    """Step 5c: the CLI, checkpoints, the TUM reader, the eval CLI and the
    viewer on the card.  Returns K1's and K2's launch counts per tracking
    run."""
    import importlib
    import importlib.util
    import tempfile

    import numpy as np
    import torch

    from rgbd_visualodometry_tpu_torch import load_config, mapstate, native
    from rgbd_visualodometry_tpu_torch.camera import Camera
    from rgbd_visualodometry_tpu_torch.evaltools import absolute_trajectory_error
    from rgbd_visualodometry_tpu_torch.evaltools import cli as eval_cli
    from rgbd_visualodometry_tpu_torch.io import checkpoint, png, synthetic, tum
    from rgbd_visualodometry_tpu_torch.io.trajectory import read_trajectory
    from rgbd_visualodometry_tpu_torch.pipeline import frontend
    from rgbd_visualodometry_tpu_torch.viz import MapViewer

    t_phase = time.perf_counter()
    have = {}
    for name in ("yaml", "cv2", "matplotlib", "PIL"):  # none of them imported by the port
        have[name] = importlib.util.find_spec(name) is not None
        if have[name]:
            have[name] = getattr(importlib.import_module(name), "__version__", True)
    have["libpng (native.available())"] = native.available()
    print(f"CLI phase: on this machine {', '.join(f'{k} {v}' for k, v in have.items())}"
          + ("" if native.available() else f"; native build: {native.build_error()}"))
    config = os.path.join(HERE, "configs", "default.yaml")
    cfg = load_config(config)
    counts = {}
    with tempfile.TemporaryDirectory() as tmp:
        # (a) synthetic frames, stats, checkpoint, offline relax
        traj, stats, ckpt = (os.path.join(tmp, n) for n in ("syn.txt", "syn.jsonl", "map.npz"))
        rc, text, nums = _run_cli([config, "--synthetic", str(CLI_FRAMES), "--stats", stats, "--save-map", ckpt,
                                   "--global-relax", "--output", traj, "--quiet"], "synthetic")
        _check_cli("synthetic", rc, text, nums, CLI_FRAMES)
        counts["synthetic"] = nums["counts"]
        printed = float(re.search(r"ATE vs exact ground truth: rmse=([0-9.]+) cm", text).group(1)) / 100
        gt_T = synthetic.orbit_trajectory(CLI_FRAMES)
        gt_ts = np.arange(CLI_FRAMES) / 30.0
        gt_xyz = np.asarray([synthetic._pose_inverse(T)[4:7] for T in gt_T])
        ts, poses = read_trajectory(traj)
        relaxed = absolute_trajectory_error(ts, poses[:, 4:7], gt_ts, gt_xyz).rmse
        records = [json.loads(ln) for ln in open(stats, encoding="utf-8")]
        print(f"CLI synthetic: ATE {100 * printed:.2f} cm as printed, {100 * relaxed:.3f} cm of the relaxed "
              f"trajectory file ({len(ts)} lines), {len(records)} stats records")
        if not (printed < ATE_LIMIT_M and relaxed < ATE_LIMIT_M):
            raise AssertionError(f"CLI synthetic: ATE {printed} m printed, {relaxed} m relaxed, limit {ATE_LIMIT_M} m")
        if len(ts) != CLI_FRAMES or len(records) != CLI_FRAMES:
            raise AssertionError(f"CLI synthetic: {len(ts)} trajectory lines and {len(records)} stats records")
        seconds = {"checkpoint load": [], "checkpoint save": []}
        again = os.path.join(tmp, "map_again.npz")
        for _ in range(3):
            t0 = time.perf_counter()
            state, ccfg, meta = checkpoint.load_state(ckpt, with_meta=True, device=dev)
            torch.cuda.synchronize()
            seconds["checkpoint load"].append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            checkpoint.save_state(state, ccfg, again, meta=meta)
            torch.cuda.synchronize()
            seconds["checkpoint save"].append(time.perf_counter() - t0)
        differ = _npz_equal(ckpt, again)
        print(f"checkpoint at the default capacities ({os.path.getsize(ckpt) / 2**20:.2f} MiB compressed): "
              + "; ".join(f"{k}: {1e3 * sum(v):.1f} ms total, {1e3 * sum(v) / len(v):.2f} ms/call (n={len(v)})"
                          for k, v in seconds.items())
              + f"; leaves that differ after a reload and save: {differ}")
        if differ:
            raise AssertionError(f"checkpoint: a reload saved again differs in {differ}")

        # (b) the same sequence as a TUM directory on disk, epoch stamps
        scene = synthetic.SyntheticScene(width=cfg.image_width, height=cfg.image_height, fx=cfg.camera_fx,
                                         fy=cfg.camera_fy, cx=cfg.camera_cx, cy=cfg.camera_cy,
                                         depth_scale=cfg.camera_depth_scale)
        seq = synthetic.generate_sequence(TUM_FRAMES, scene=scene)
        d = os.path.join(tmp, "tum")
        os.makedirs(os.path.join(d, "rgb"))
        os.makedirs(os.path.join(d, "depth"))
        lines = {"rgb": [], "depth": [], "groundtruth": []}
        t0 = time.perf_counter()
        for f in seq:
            stamp = f"{TUM_T0 + f.timestamp:.6f}"
            png.write(os.path.join(d, "rgb", f"{stamp}.png"), f.rgb)
            png.write(os.path.join(d, "depth", f"{stamp}.png"), f.depth)
            lines["rgb"].append(f"{stamp} rgb/{stamp}.png")
            lines["depth"].append(f"{stamp} depth/{stamp}.png")
            q, t = synthetic._pose_inverse(f.T_c_w)[:4], synthetic._pose_inverse(f.T_c_w)[4:7]
            lines["groundtruth"].append(f"{stamp} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f} {q[0]:.6f}")
        for name, rows in lines.items():
            with open(os.path.join(d, f"{name}.txt"), "w", encoding="utf-8") as fh:
                fh.write("\n".join(rows) + "\n")
        write_s = time.perf_counter() - t0
        decode = {}
        for use_native in ((True, False) if native.available() else (False,)):
            t0 = time.perf_counter()
            got = list(tum.iter_dataset(d, cfg.image_width, cfg.image_height, use_native=use_native))
            decode["native" if use_native else "io/png.py"] = 1e3 * (time.perf_counter() - t0) / len(got)
            if len(got) != TUM_FRAMES or not all((r == f.rgb).all() and (z == f.depth).all() for (_, r, z), f in zip(got, seq)):
                raise AssertionError(f"TUM decode ({'native' if use_native else 'io/png.py'}) differs from the frames written")
        print(f"TUM directory: {TUM_FRAMES} frames written by io/png.py in {1e3 * write_s / TUM_FRAMES:.1f} ms/frame; "
              f"the CLI decodes with {'the native loader' if native.available() else 'io/png.py'}; decode "
              + ", ".join(f"{k} {v:.1f} ms/frame" for k, v in decode.items()) + " (rgb + depth, read back exactly)")
        traj2 = os.path.join(tmp, "tum.txt")
        gt_file = os.path.join(d, "groundtruth.txt")
        rc, text, nums = _run_cli([config, "--dataset", d, "--evaluate", gt_file, "--output", traj2, "--quiet"], "TUM")
        _check_cli("TUM", rc, text, nums, TUM_FRAMES)
        counts["tum"] = nums["counts"]
        ate_tum = float(re.search(r"^ATE rmse: ([0-9.]+) m", text, re.M).group(1))
        if not ate_tum < ATE_LIMIT_M:
            raise AssertionError(f"CLI TUM: ATE {ate_tum} m is not below {ATE_LIMIT_M} m")

        # (c) localize against the frozen map of (a)
        ckpt2, traj3 = os.path.join(tmp, "after_loc.npz"), os.path.join(tmp, "loc.txt")
        rc, text, nums = _run_cli([config, "--load-map", ckpt, "--localize-only", "--dataset", d, "--save-map", ckpt2,
                                   "--output", traj3, "--quiet"], "localize-only")
        _check_cli("localize-only", rc, text, nums, TUM_FRAMES)
        counts["localize"] = nums["counts"]
        frozen = [f"leaf_{i}" for i, n in enumerate(checkpoint.LEAVES)
                  if n.startswith(("kf_", "mp_", "obs_")) or n in ("num_kf", "A_inc")]
        differ = _npz_equal(ckpt, ckpt2, frozen)
        ts3, poses3 = read_trajectory(traj3)
        gts, gtp = read_trajectory(gt_file)
        ate_loc = absolute_trajectory_error(ts3, poses3[:, 4:7], gts, gtp[:, 4:7]).rmse
        print(f"CLI localize-only: {len(ts3)} poses, ATE {100 * ate_loc:.3f} cm; of {len(frozen)} map leaves "
              f"{len(differ)} changed {differ}")
        if differ or len(ts3) != TUM_FRAMES:
            raise AssertionError(f"CLI localize-only: map leaves changed {differ}, {len(ts3)} poses")

        # (d) the eval CLI on (b)'s files
        for argv in (["ate", gt_file, traj2, "--verbose", "--save", os.path.join(tmp, "aligned.txt")],
                     ["rpe", gt_file, traj2, "--verbose"]):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = eval_cli.main(argv)
            print("\n".join(f"  | {ln}" for ln in buf.getvalue().strip().splitlines()))
            if rc != 0:
                raise AssertionError(f"eval CLI {argv[0]}: rc {rc}")
            if argv[0] == "ate":
                rmse = float(re.search(r"absolute_translational_error.rmse ([0-9.]+) m", buf.getvalue()).group(1))
                if abs(rmse - ate_tum) > 1e-4 or len(open(argv[-1]).readlines()) != TUM_FRAMES:
                    raise AssertionError(f"eval CLI ate: {rmse} m vs the CLI's {ate_tum} m")

        # (e) the viewer on the card: the payload's rule, checked on the
        # step's intermediates...
        vcfg = cfg.replace(enable_viewer=True)
        cam = Camera.from_config(vcfg)
        state = mapstate.init_state(vcfg, 0, dev)
        flagged = []
        for i, f in enumerate(seq[:VIEWER_FRAMES]):
            it = frontend.track_compute(vcfg, cam, state, frontend.frame_input(f.rgb, f.depth, f.timestamp, dev))
            payload = frontend.viewer_payload(it)
            state, out = frontend.apply_updates(vcfg, cam, state, it)
            if not (payload.device == state.kf_pose.device and payload.dtype == torch.float32
                    and payload.shape == (vcfg.number_of_features, 3)):
                raise AssertionError(f"viewer payload: {payload.device} {payload.dtype} {tuple(payload.shape)}")
            v = payload.cpu().numpy()
            want = np.zeros(len(v), bool)
            want[it.kpi[it.mval].cpu().numpy()] = True
            want &= it.kp_valid.cpu().numpy()
            flags = v[:, 2] > 0.5
            n_match = int(out.num_matches)
            if not (np.array_equal(flags, want) and np.array_equal(v[:, :2], it.xy.cpu().numpy())
                    and flags.sum() <= n_match and (i == 0 or flags.sum() > 0)):
                raise AssertionError(f"viewer payload, frame {i}: {flags.sum()} flags, {want.sum()} kept matches, "
                                     f"{n_match} matches")
            flagged.append((int(flags.sum()), n_match))
        # ... then through the user's entry point: cli.main on a config with
        # enable_viewer: 1, in the temporary directory, where the CLI's
        # final render goes to viewer_out/
        vdir = os.path.join(tmp, "viewer")
        vyaml = os.path.join(tmp, "viewer.yaml")
        with open(config, encoding="utf-8") as fh:
            text = fh.read()
        if "\nenable_viewer: 0\n" not in text:
            raise AssertionError(f"{config} has no 'enable_viewer: 0' line")
        with open(vyaml, "w", encoding="utf-8") as fh:
            fh.write(text.replace("\nenable_viewer: 0\n", "\nenable_viewer: 1\n")
                     + f"viewer_dir: {vdir}\nviewer_map_every: {VIEWER_MAP_EVERY}\n")
        from rgbd_visualodometry_tpu_torch.pipeline.system import VisualOdometry

        materialize, seen = VisualOdometry._materialize, []

        def spy(self, ts, out, *a, **k):
            seen.append((out.viewer.device.type, out.viewer.cpu().numpy()))
            res = materialize(self, ts, out, *a, **k)
            seen[-1] += (res.stats["num_matches"],)
            return res

        cwd = os.getcwd()
        VisualOdometry._materialize = spy
        try:
            os.chdir(tmp)
            rc, text, nums = _run_cli([vyaml, "--dataset", d, "--max-frames", str(VIEWER_FRAMES),
                                       "--output", os.path.join(tmp, "viewer.txt"), "--quiet"], "viewer")
        finally:
            os.chdir(cwd)
            VisualOdometry._materialize = materialize
        _check_cli("viewer", rc, text, nums, VIEWER_FRAMES)
        counts["viewer"] = nums["counts"]
        if len(seen) != VIEWER_FRAMES or any(dt != dev.type or v.shape != (cfg.number_of_features, 3)
                                              or (v[:, 2] > 0.5).sum() > n for dt, v, n in seen):
            raise AssertionError(f"CLI viewer: payloads {[(dt, v.shape, int((v[:, 2] > 0.5).sum()), n) for dt, v, n in seen]}")
        for i, (f, (_, v, _)) in enumerate(zip(seq, seen)):
            path = os.path.join(vdir, f"frame_{i:05d}.png")
            if not np.array_equal(png.read(path), MapViewer.draw_keypoints(f.rgb, v[:, :2], v[:, 2] > 0.5)):
                raise AssertionError(f"CLI viewer: overlay {path} does not decode to draw_keypoints of its payload")
        maps = [f"map_{i:05d}.png" for i in range(0, VIEWER_FRAMES, VIEWER_MAP_EVERY)]
        files = sorted(os.listdir(vdir))
        want_files = sorted([f"frame_{i:05d}.png" for i in range(VIEWER_FRAMES)] + ["map.html"]
                            + (maps if have["matplotlib"] else []))
        final = os.path.join(tmp, "viewer_out")
        final_line = "map rendered to viewer_out/map_00000.png" if have["matplotlib"] else \
            "map not rendered: matplotlib does not import here"
        html = open(os.path.join(vdir, "map.html"), encoding="utf-8").read()
        m = re.search(r"map: (\d+) points, (\d+) keyframes", html)
        if files != want_files or final_line not in text.splitlines() or m is None or int(m.group(1)) == 0 or int(m.group(2)) == 0:
            raise AssertionError(f"CLI viewer: files {files}, expected {want_files}; final line {final_line!r} "
                                 f"printed: {final_line in text}; map.html {m.group(0) if m else None}")
        if sorted(os.listdir(final)) != (["map_00000.png"] if have["matplotlib"] else []):
            raise AssertionError(f"CLI viewer: {final} holds {sorted(os.listdir(final))}")
        print(f"viewer on the card: the payload rule holds on {len(flagged)} frames, (flags, num_matches) "
              f"{flagged}; through cli.main: {len(seen)} payloads on {dev.type}, {VIEWER_FRAMES} overlays decode to "
              f"draw_keypoints of them, {m.group(0)} in map.html, map PNGs "
              + ("rendered" if have["matplotlib"] else "skipped: matplotlib does not import here")
              + f"; files {files}")
    print(f"CLI phase: {time.perf_counter() - t_phase:.1f} s")
    return counts


# the bench phase (step 5d): the protocol cut to 1 pass of 3 windows of 5
# frames, or of 2 batch steps, after 4 warm-up frames
BENCH_CUT = dict(WARMUP_FRAMES=4, MEASURE_FRAMES=5, MS_MEASURE_FRAMES=6)
BENCH_KEYS = ["metric", "value", "unit", "vs_baseline", "vs_strongest_twin", "best", "median", "passes"]  # bench.py's


def bench_phase(smi: str, dev) -> dict:
    """Step 5d: the port's bench program (``rgbd_visualodometry_tpu_torch.bench``)
    through its own phase functions, with the protocol cut to
    :data:`BENCH_CUT` and 1 pass: ``bench_single`` (single-stream full VO)
    and ``bench_multistream`` with ``TRACKING_STREAMS`` streams of tracking,
    each with the counts reset just before it.  Each must track every frame
    (the phases raise otherwise), launch K1 and K2 once per frame or batch
    step, give 3 finite windows, log them with this card's name, and give a
    result line with ``bench.py``'s keys.  Returns each run's counts."""
    import tempfile

    import torch

    from rgbd_visualodometry_tpu_torch import VOConfig, bench, kernels

    t_phase = time.perf_counter()
    saved = {k: getattr(bench, k) for k in BENCH_CUT}
    counts = {}
    try:
        for k, v in BENCH_CUT.items():
            setattr(bench, k, v)
        divisors = bench.load_baseline()
        reporter = bench._Reporter(divisors["frontend_only"])
        S = bench.TRACKING_STREAMS
        with tempfile.TemporaryDirectory() as tmp:
            log = os.path.join(tmp, "windows.jsonl")
            for name, units, run, divisor, label in (
                ("single", bench.WARMUP_FRAMES + 3 * bench.MEASURE_FRAMES,
                 lambda: bench.bench_single(VOConfig(), repeats=1, device=dev, window_log=log),
                 divisors["full_vo"], "single-stream full VO"),
                ("tracking", bench.WARMUP_FRAMES + bench.MS_MEASURE_FRAMES,
                 lambda: bench.bench_multistream(VOConfig(), S, full_vo=False, repeats=1, device=dev, window_log=log),
                 divisors["frontend_only"], f"{S}-stream batched tracking"),
            ):
                t0 = time.perf_counter()
                kernels.reset_counts()
                got = run()
                torch.cuda.synchronize()
                counts[name] = kernels.counts()
                text = io.StringIO()
                with contextlib.redirect_stdout(text):
                    reporter.add(got, divisor, label)
                line = json.loads(text.getvalue().strip().splitlines()[-1])
                print(f"bench {label}: 1 pass, windows {[round(w, 2) for w in got['windows'][0]]} "
                      f"{'frames' if name == 'single' else 'stream-frames'}/s, {units} "
                      f"{'frames' if name == 'single' else 'steps'}, launches {counts[name]}, "
                      f"{time.perf_counter() - t0:.1f} s; result line {json.dumps(line)}")
                if counts[name]["fast_nms"] != units or counts[name]["hamming_nn"] != units:
                    raise AssertionError(f"bench {label}: launches {counts[name]}, expected {units} each")
                if got["passes"] != 1 or len(got["windows"][0]) != 3 or not all(
                        math.isfinite(w) and w > 0 for w in got["windows"][0]):
                    raise AssertionError(f"bench {label}: {got}")
                if list(line) != BENCH_KEYS:
                    raise AssertionError(f"bench {label}: result line keys {list(line)}, expected {BENCH_KEYS}")
            with open(log) as f:
                logged = [json.loads(x) for x in f]
        if [r["phase"] for r in logged] != ["single-stream full VO", f"{S}-stream batched tracking"] or not all(
                r["card"].startswith(smi.split(",")[0]) for r in logged):
            raise AssertionError(f"bench window log: {logged}")
    finally:
        for k, v in saved.items():
            setattr(bench, k, v)
    print(f"bench phase: {time.perf_counter() - t_phase:.1f} s (window log card field: {logged[0]['card']})")
    return counts


def multistream_phase(cfg, dev, profile_steps: int = 0):
    """The bench's headline workload on the port: ``MultiStreamVO`` with
    ``MS_STREAMS`` streams of 640x480 full VO (:func:`multistream_config`),
    each its own sequence, ``MS_WARMUP`` steps then ``MS_MEASURED`` timed
    ones, every batch staged on the card first.  Checks that every stream
    tracks every frame with ATE < 3 cm, that a BA dispatch ran and
    that K1 and K2 launched once per batch step.  Returns a function that
    times K1 and K2 at the batched shapes (after the other timings) and
    returns their entries for the JSON line, one that runs
    :func:`profile_phase` over ``2 * profile_steps`` more batch steps
    (``--profile``; None without), and what the distributed phase compares
    with: the frames, stamps and ground truth, the steps, the records, the
    BA dispatches and the largest ATE."""
    import tempfile

    import numpy as np
    import torch

    from rgbd_visualodometry_tpu_torch import bench, kernels
    from rgbd_visualodometry_tpu_torch.evaltools import ate_rmse
    from rgbd_visualodometry_tpu_torch.io.synthetic import _pose_inverse as pose_inverse
    from rgbd_visualodometry_tpu_torch.ops import fast, image as im, matching
    from rgbd_visualodometry_tpu_torch.parallel import MultiStreamVO
    from rgbd_visualodometry_tpu_torch.pipeline.frontend import StepOutput

    S, n = MS_STREAMS, MS_WARMUP + MS_MEASURED
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        seq = {k: np.array(v) for k, v in bench.render_streams(cfg, S, n + 2 * profile_steps, tmp).items()}
    gt = np.apply_along_axis(lambda T: pose_inverse(T)[4:7], -1, seq["T_c_w"])  # camera centres [T, S, 3]
    print(f"multistream: rendered {S} sequences x {len(seq['rgb'])} frames {cfg.image_width}x{cfg.image_height} "
          f"(seeds 0-{S - 1}) in {time.perf_counter() - t0:.1f} s")

    vo = MultiStreamVO(cfg, S, device=dev)
    batches = [vo.put_batch(seq["rgb"][i], seq["depth"][i], seq["timestamp"][i]) for i in range(n + 2 * profile_steps)]
    ba_s = []
    fleet_ba = vo._ba

    def timed_ba(*a):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fleet_ba(*a)
        torch.cuda.synchronize()
        ba_s.append(time.perf_counter() - t)
        return out

    vo._ba = timed_ba
    torch.cuda.synchronize()
    kernels.reset_counts()
    outs, step_s = [], []
    replays, restore_replays = _spy_replays()
    try:
        for fb in batches[:n]:
            t = time.perf_counter()
            outs.append(vo.step(fb).packed)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t)
        vo.finish()
        torch.cuda.synchronize()
    finally:
        restore_replays()
    counts = kernels.counts()
    rec = torch.stack(outs).cpu().numpy()  # [steps, S, 32]
    f = StepOutput._FIELDS
    tracked = rec[..., f["tracked"]] > 0.5
    stamps = seq["timestamp"][:n]
    ates = [ate_rmse(stamps[:, s], rec[:, s, 11:14], stamps[:, s], gt[:n, s]) for s in range(S)]
    measured = step_s[MS_WARMUP:]
    print(f"multistream: {S} streams x {n} steps, {int(tracked.sum())}/{tracked.size} stream-frames tracked, "
          f"ATE max {100 * max(ates):.3f} cm, mean {100 * statistics.mean(ates):.3f} cm; "
          f"{S * len(measured) / sum(measured):.2f} stream-frames/s over steps {MS_WARMUP}-{n - 1}, "
          f"{1e3 * statistics.median(measured):.2f} ms/step median (p90 "
          f"{1e3 * sorted(measured)[int(0.9 * len(measured))]:.2f}), first step {1e3 * step_s[0]:.2f} ms")
    print(f"multistream: {vo.ba_dispatches} BA dispatches ({int(rec[..., f['needs_ba']].sum())} "
          f"stream-records asked for BA), BA {1e3 * statistics.median(ba_s):.2f} ms/dispatch median "
          f"(all: {', '.join(f'{1e3 * x:.2f}' for x in ba_s)})" if ba_s else "multistream: no BA dispatch")
    print(f"launches on the multistream path: {counts} over {n} batch steps")
    pose = {k: v for k, v in vo.counters().items() if k.startswith("pose_stage")}
    print(f"multistream: pose-round stage calls {pose or 'not counted'}")
    _check_replays("multistream", replays)
    if not tracked.all():
        raise AssertionError(f"multistream: {int((~tracked).sum())} stream-frames not tracked")
    if not all(math.isfinite(a) and a < ATE_LIMIT_M for a in ates):
        raise AssertionError(f"multistream: ATE {max(ates)} m is not below {ATE_LIMIT_M} m")
    if vo.ba_dispatches < 1 or len(ba_s) != vo.ba_dispatches:
        raise AssertionError(f"multistream: {vo.ba_dispatches} BA dispatches")
    if counts["fast_nms"] != n or counts["hamming_nn"] != n:
        raise AssertionError(f"multistream: launches {counts}, expected fast_nms and hamming_nn {n} times each")
    reference = dict(rgb=seq["rgb"][:n], depth=seq["depth"][:n], stamps=stamps, gt=gt[:n], steps=n,
                     ba_dispatches=vo.ba_dispatches, ate_max=max(ates), records=rec)
    profile = None
    if profile_steps:
        def profile():
            return profile_phase(f"multistream, {S} streams", "step", vo.step, batches[n : n + profile_steps],
                          batches[n + profile_steps :], lambda: vo.ba_dispatches,
                          extra=[(vo, "_update", "apply_updates (keyframe, map, DLT), vmapped")])
    else:
        del batches, vo
    del outs

    # K1 and K2 at the batched shapes: the frames' pyramids, and pools of C
    # words against the frames' N keypoints, at this phase's 72 streams and
    # at the 32 of the bench's tracking phase (the first 32 of them)
    gray = im.rgb_to_gray(torch.from_numpy(seq["rgb"][0]).to(dev))
    levels = torch.func.vmap(lambda g: im.build_pyramid(g, cfg.level_pyramid, cfg.scale_factor))(gray)
    want = torch.cat([torch.stack([fast.fast_nms_reference(g) for g in lv]).reshape(S, -1) for lv in levels], dim=1)
    rng = np.random.default_rng(5)
    N, C = cfg.number_of_features, cfg.max_mappoints
    words = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.integers(0, 2**32, shape + (8,), dtype=np.uint64).astype(np.uint32).view(np.int32)).to(dev)
    cand, kp = words(S, C), words(S, N)
    mask = torch.from_numpy(rng.random((S, N)) >= 0.1).to(dev)
    mask[1] = False  # one stream with every keypoint masked
    refs = [matching.hamming_nn_reference(cand[s], kp[s], mask[s]) for s in range(S)]
    sizes = (S, TRACKING_STREAMS)
    k1_err = {}
    for s_n in sizes:
        got = fast.fast_nms_streams([x[:s_n] for x in levels])
        torch.cuda.synchronize()
        if not torch.equal(got, want[:s_n]):
            raise AssertionError(f"K1 fast_nms differs from its plain version on {s_n} streams' pyramids")
        idx, dist = matching.hamming_nn_streams(cand[:s_n], kp[:s_n], mask[:s_n])
        for s in range(s_n):
            if not (torch.equal(idx[s], refs[s].kp_index) and torch.equal(dist[s], refs[s].distance)):
                raise AssertionError(f"K2 hamming_nn differs from its plain version on stream {s} of {s_n}")
        k1_err[s_n] = float((got - want[:s_n]).abs().max())
    print(f"K1 and K2 at {' and '.join(map(str, sizes))} streams: exact per stream ({len(levels)} levels each; "
          f"pools {C}x{N}, one with every keypoint masked)")

    def timings():
        """Per stream count (72, 32): K1's and K2's entries."""
        a16 = (matching.unpack_bits(cand) * 2 - 1).half()
        b16 = torch.zeros((S, 512, 256), dtype=torch.float16, device=dev)
        b16[:, :N] = (matching.unpack_bits(kp) * 2 - 1).half()
        dot = torch.bmm(a16[:1], b16[:1].mT)
        lib_ok = torch.equal(((256 - dot[0, :, :N]) / 2).int(), matching.hamming_matrix_reference(cand[0], kp[0]))
        out = {}
        for s_n in sizes:
            lv = [x[:s_n] for x in levels]  # per level [s_n, H, W]
            px = sum(x.numel() for x in lv)
            c_, k_, m_ = cand[:s_n], kp[:s_n], mask[:s_n]
            lib = (None, "torch.bmm fp16: its distances differ from the plain version")
            if lib_ok:
                lib = (_device_ms(lambda: torch.bmm(a16[:s_n], b16[:s_n].mT), None),
                       f"torch.bmm fp16 [{s_n}, {C}, 256] x [{s_n}, 256, 512], distance half only")
            entries = out[s_n] = {}
            for name, what, fn, plain, bound, library, err in (
                ("fast_nms", f"{s_n} streams x {len(lv)} levels, {px} px, one launch",
                 lambda: fast.fast_nms_streams(lv), lambda: [fast.fast_nms_reference(g) for x in lv for g in x],
                 _bound(8 * px, K1_OPS_PER_PIXEL * px, "fp32"), (None, "none"), k1_err[s_n]),
                ("hamming_nn", f"{s_n} streams x N={N} C={C}, one launch",
                 lambda: matching.hamming_nn_streams(c_, k_, m_),
                 lambda: [matching.hamming_nn_reference(c_[s], k_[s], m_[s]) for s in range(s_n)],
                 _bound(s_n * (32 * C + 33 * N + 8 * C), s_n * 2 * 256 * C * N, "int8 tensor-core"), lib, 0.0),
            ):
                kname = "fast_nms_pyramid_kernel" if name == "fast_nms" else "hamming_nn_kernel"
                device_ms = _device_ms(fn, kname)
                plain_ms = _median_ms(plain, iters=3, warmup=1)
                bound_ms, bound_by, basis = bound
                entries[name] = dict(
                    streams=s_n, device_ms=device_ms, ms=_median_ms(fn), plain_ms=plain_ms, bound_ms=bound_ms,
                    bound_by=bound_by, bound_basis=basis, share_of_bound=bound_ms / device_ms, library_ms=library[0],
                    library_call=library[1], max_abs_err=err,
                )
                if s_n == S:  # this phase's own launches
                    entries[name].update(launches=counts[name], launches_per_step=counts[name] / n)
                lib_txt = "none" if library[0] is None else f"{library[0]:.4f} ms device time ({library[1]})"
                print(f"{name} at {what}: device {device_ms:.4f} ms (torch.profiler), wrapper-inclusive events "
                      f"{entries[name]['ms']:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} "
                      f"({basis}), {100 * bound_ms / device_ms:.1f}% of bound; library {lib_txt}")
        return out

    return timings, profile, reference


DIST_FRAMES = 30  # ShardedMapVO frames at the production shape (step 6b b)
NCCL_FRAMES = 5
SHARE_NOTE = "2 processes sharing one H100, not a scaling number"
# step 6b (c): the ranks' records against step 6's one process, whose batch
# is 72 streams to their 36.  On the card the two round the step's float
# sums differently, so a borderline inlier can flip a count and move the
# later poses: the decisions must be equal on every stream-frame, the
# counts and pose differences are printed, and each stream's ATE is held to
# one process's as test_torch_system.py holds the port's to the JAX
# package's (float sums in another order): at most 1.05x + 0.5 mm
MS_DECISIONS = ("tracked", "fsm", "is_keyframe", "needs_ba", "kf_slot", "num_keyframes", "kf_overflow")
MS_ATE_RATIO, MS_ATE_SLACK_M = 1.05, 5e-4


def _rank_main(rank, world, backend, init, job, args, out):
    """One rank of the distributed phase, in a spawned process: join the
    group on ``cuda:0``, run ``job(group, rank, world, *args)`` and write its
    JSON result.  A rank that raises fails the phase (and the script)."""
    import torch
    import torch.distributed as dist

    from rgbd_visualodometry_tpu_torch.parallel import open_group

    torch.cuda.set_device(0)  # every rank shares the one card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    group = open_group(backend, init, world, rank)
    try:
        result = job(group, rank, world, *args)
        if any(m == "jax" or m.startswith("jax.") for m in sys.modules):
            raise AssertionError(f"rank {rank} imported jax")
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out, f"{job.__name__}_{rank}.json"), "w") as f:
        json.dump(result, f)


def _replicated_agree(vo) -> bool:
    """Whether every replicated leaf of the ranks' states is bit-equal: a
    checksum of their bytes, position-weighted, through an all-reduce MAX
    and an all-reduce MIN."""
    import torch
    import torch.distributed as dist

    from rgbd_visualodometry_tpu_torch.parallel import map_partition_specs

    total = torch.zeros((), dtype=torch.int64, device=vo.device)
    for name, dim in vars(map_partition_specs()).items():
        if dim is None:
            b = getattr(vo.state, name).contiguous().reshape(-1).view(torch.uint8).long()
            total += torch.sum(b * (torch.arange(b.numel(), device=vo.device) % 65521 + 1))
    hi, lo = total.clone(), total.clone()
    dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=vo.shard.group)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=vo.shard.group)
    return bool(hi == lo)


def _pool_bytes(state) -> int:
    from rgbd_visualodometry_tpu_torch.parallel import map_partition_specs

    return sum(getattr(state, n).nbytes for n, d in vars(map_partition_specs()).items() if d is not None)


def _gloo_job(group, rank, world, frames, ref, ms_dir, ms_ref):
    """Steps (a)-(c) of the distributed phase on one rank of the gloo group."""
    import numpy as np
    import torch

    from rgbd_visualodometry_tpu_torch import VOConfig, kernels
    from rgbd_visualodometry_tpu_torch.evaltools import ate_rmse
    from rgbd_visualodometry_tpu_torch.ops import matching
    from rgbd_visualodometry_tpu_torch.parallel import MultiStreamVO, ShardedMapVO, sharded_match_descriptors
    from rgbd_visualodometry_tpu_torch.pipeline.frontend import StepOutput

    dev = torch.device("cuda", 0)
    out = {}

    # (a) the sharded matcher, K2 on each rank's rows, against the plain
    # version + the gate over the whole pool; K2 on the whole pool too
    rng = np.random.default_rng(11)
    C, N = 65536, 500
    words = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.integers(0, 2**32, shape + (8,), dtype=np.uint64).astype(np.uint32).view(np.int32)).to(dev)
    cand, kp = words(C), words(N)
    cand[: N // 4] = kp[: N // 4]  # exact copies on the first rank's rows: the global minimum is 0
    near = kp[N // 4 : N // 2] ^ torch.from_numpy(  # and copies up to 8 bits off on the last rank's rows
        (1 << rng.integers(0, 32, (N // 4, 8))).astype(np.uint32).view(np.int32) * (rng.random((N // 4, 8)) < 0.8)).to(dev)
    cand[C - N // 4 :] = near
    cand_mask = torch.from_numpy(rng.random(C) < 0.9).to(dev)
    kp_mask = torch.from_numpy(rng.random(N) < 0.95).to(dev)
    Cw = C // world
    own = slice(rank * Cw, (rank + 1) * Cw)
    got = sharded_match_descriptors(group, cand[own].clone(), cand_mask[own].clone(), kp, kp_mask)
    plain = matching.hamming_nn_reference(cand, kp, kp_mask)
    want = matching.gate_matches(plain, cand_mask)
    whole = matching.nearest_keypoints_packed(cand, kp, kp_mask)
    torch.cuda.synchronize()
    for key in ("matched", "kp_index", "distance"):
        if not torch.equal(getattr(got, key), getattr(want, key)[own]):
            raise AssertionError(f"(a) rank {rank}: sharded {key} differs from the plain version's on the whole pool")
    if not (torch.equal(whole.kp_index, plain.kp_index) and torch.equal(whole.distance, plain.distance)):
        raise AssertionError(f"(a) rank {rank}: K2 on the whole pool of {C} rows differs from its plain version")
    if int(got.min_distance) != int(want.min_distance):
        raise AssertionError(f"(a) rank {rank}: min_distance {int(got.min_distance)} != {int(want.min_distance)}")
    if not bool(got.matched.any()):
        raise AssertionError(f"(a) rank {rank}: no match among its rows")
    out["a"] = dict(rows=Cw, matched=int(got.matched.sum()), min_distance=int(got.min_distance))

    # (b) ShardedMapVO at the production shape
    cfg = VOConfig()
    vo = ShardedMapVO(cfg, group, device=dev)
    torch.cuda.synchronize()
    kernels.reset_counts()
    results, step_s, agree = [], [], []
    for rgb, depth, ts in frames:
        t0 = time.perf_counter()
        results.append(vo.process(rgb, depth, ts))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        agree.append(_replicated_agree(vo))
    counts = kernels.counts()
    tracked = [r.tracked for r in results]
    ts_all = [f[2] for f in frames]
    ate = ate_rmse([r.timestamp for r in results if r.tracked], [r.pose_w_c[4:7] for r in results if r.tracked],
                   ts_all, ref["gt"])
    kf, kf_ref = [r.is_keyframe for r in results], ref["is_keyframe"]
    first = next((i for i, (a, b) in enumerate(zip(kf, kf_ref)) if a != b), None)
    reason = None
    if first is not None:
        dpos = [float(np.linalg.norm(np.asarray(r.pose_w_c[4:7]) - np.asarray(p[4:7])))
                for r, p in zip(results, ref["pose_w_c"])]
        reason = (f"frame {first}: sharded is_keyframe={kf[first]}, VisualOdometry {kf_ref[first]}; "
                  f"inliers {results[first].stats['num_inliers']} vs {ref['inliers'][first]}, the two poses "
                  f"{1e3 * dpos[first - 1] if first else 0.0:.4f} mm apart the frame before, {1e3 * dpos[first]:.4f} mm "
                  "at it (float sums of BA and LM on CUDA round differently from run to run)")
    out["b"] = dict(tracked=sum(tracked), ate=ate, keyframes=sum(kf), first_keyframe_difference=reason,
                    agree=all(agree), counts=counts, pool_bytes=_pool_bytes(vo.state),
                    ms_frame=1e3 * statistics.median(step_s[WARMUP_FRAMES:]), ba_dispatches=vo.ba_dispatches)
    if not all(tracked):
        raise AssertionError(f"(b) rank {rank}: tracked {sum(tracked)} of {len(frames)} frames")
    if not all(agree):
        raise AssertionError(f"(b) rank {rank}: the replicated leaves differ across ranks after frame "
                             f"{agree.index(False)}")
    if not (math.isfinite(ate) and ate <= 1.1 * ref["ate"]):
        raise AssertionError(f"(b) rank {rank}: ATE {ate} m above 1.1x VisualOdometry's {ref['ate']} m")
    if counts["fast_nms"] != len(frames) or counts["hamming_nn"] != len(frames):
        raise AssertionError(f"(b) rank {rank}: launches {counts}, expected {len(frames)} each")
    if 2 * _pool_bytes(vo.state) != ref["pool_bytes"]:
        raise AssertionError(f"(b) rank {rank}: pool {_pool_bytes(vo.state)} B, not half of {ref['pool_bytes']} B")
    del vo

    # (c) MultiStreamVO with the streams split over the ranks
    mcfg = multistream_config()
    rgb = np.load(os.path.join(ms_dir, "rgb.npy"), mmap_mode="c")  # copy-on-write: writable views
    depth = np.load(os.path.join(ms_dir, "depth.npy"), mmap_mode="c")
    stamps = np.load(os.path.join(ms_dir, "stamps.npy"))
    gt = np.load(os.path.join(ms_dir, "gt.npy"))
    S, n = rgb.shape[1], rgb.shape[0]
    ms = MultiStreamVO(mcfg, S, device=dev, group=group)
    batches = [ms.put_batch(rgb[i], depth[i], stamps[i]) for i in range(n)]  # this rank's streams, staged
    torch.cuda.synchronize()
    kernels.reset_counts()
    recs, step_s = [], []
    for fb in batches:
        t0 = time.perf_counter()
        recs.append(ms.step(fb).packed)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    ms.finish()
    torch.cuda.synchronize()
    counts = kernels.counts()
    rec = torch.stack(recs).cpu().numpy()
    f = StepOutput._FIELDS
    ok = rec[..., f["tracked"]] > 0.5
    ates = [ate_rmse(stamps[:, s], rec[:, s, 11:14], stamps[:, s], gt[:, s]) for s in range(S)]
    timed = step_s[MS_WARMUP:]
    # against step 6's one-process records (the parent checks them, after
    # printing): the decisions, the counts, the poses T_w_c
    want = np.load(os.path.join(ms_dir, "records.npy"))
    cols = [f[k] for k in MS_DECISIONS]
    dec = np.any(rec[..., cols] != want[..., cols], axis=-1)
    cnt = {k: float(np.abs(rec[..., j] - want[..., j]).max()) for k, j in f.items() if k not in MS_DECISIONS}
    cnt_rows = np.any(np.stack([rec[..., j] != want[..., j] for k, j in f.items() if k not in MS_DECISIONS]), axis=0)
    dot = np.abs(np.sum(rec[..., 7:11].astype(np.float64) * want[..., 7:11], axis=-1))
    ates_ref = [ate_rmse(stamps[:, s], want[:, s, 11:14], stamps[:, s], gt[:, s]) for s in range(S)]
    first = None
    if dec.any():
        i, st = np.argwhere(dec)[0]
        first = (f"step {i} stream {st}: " + ", ".join(f"{k} {rec[i, st, f[k]]:g} vs {want[i, st, f[k]]:g}"
                                                       for k in MS_DECISIONS if rec[i, st, f[k]] != want[i, st, f[k]]))
    out["c"] = dict(streams=[ms.streams.start, ms.streams.stop], tracked=int(ok.sum()), frames=int(ok.size),
                    ate_max=max(ates), ates=ates, ates_ref=ates_ref, ba_dispatches=ms.ba_dispatches, counts=counts,
                    fps=S * len(timed) / sum(timed), ms_step=1e3 * statistics.median(timed),
                    decisions_differ=int(dec.sum()), first_decision_difference=first,
                    counts_differ=int(cnt_rows.sum()), count_diff_max=cnt,
                    dt_max=float(np.abs(rec[..., 11:14] - want[..., 11:14]).max()),
                    drot_max_deg=float(np.degrees(2 * np.arccos(np.clip(dot, 0, 1))).max()))
    if not ok.all():
        raise AssertionError(f"(c) rank {rank}: {int((~ok).sum())} stream-frames not tracked")
    if not all(math.isfinite(a) for a in ates):
        raise AssertionError(f"(c) rank {rank}: ATE {ates}")
    if ms.ba_dispatches != ms_ref["ba_dispatches"]:
        raise AssertionError(f"(c) rank {rank}: {ms.ba_dispatches} BA dispatches, one process ran "
                             f"{ms_ref['ba_dispatches']}")
    if counts["fast_nms"] != n or counts["hamming_nn"] != n:
        raise AssertionError(f"(c) rank {rank}: launches {counts}, expected {n} each")
    return out


def _nccl_job(group, rank, world, frames):
    """Step (d): ShardedMapVO on a one-rank NCCL group against
    VisualOdometry on the same frames."""
    import numpy as np
    import torch

    from rgbd_visualodometry_tpu_torch import VOConfig, VisualOdometry, kernels
    from rgbd_visualodometry_tpu_torch.parallel import ShardedMapVO

    cfg = VOConfig()
    single = VisualOdometry(cfg, device="cuda")
    want = [single.process(*f) for f in frames]
    vo = ShardedMapVO(cfg, group, device="cuda")
    kernels.reset_counts()
    got = [vo.process(*f) for f in frames]
    torch.cuda.synchronize()
    counts = kernels.counts()
    dpose = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        if (a.tracked, a.fsm, a.is_keyframe, a.stats) != (b.tracked, b.fsm, b.is_keyframe, b.stats):
            raise AssertionError(f"(d) frame {i}: {a} != {b}")
        dpose = max(dpose, float(np.abs(a.pose_w_c - b.pose_w_c).max()))
    if dpose > 1e-5:
        raise AssertionError(f"(d) poses {dpose} apart, above 1e-5")
    return dict(frames=len(got), max_pose_diff=dpose, counts=counts, backend=torch.distributed.get_backend(group))


def distributed_phase(smi: str, ms_ref: dict) -> dict:
    """Step 6b: the port's multi-process half on the one card, every rank
    on ``cuda:0`` (``parallel``: ``ShardedMapVO``,
    ``sharded_match_descriptors``, ``MultiStreamVO`` with ``group``).  Two
    ranks of a gloo group with CUDA tensors (NCCL refuses two ranks on one
    device), spawned: (a) the sharded matcher at C = 65536, N = 500 equal
    to the plain matcher and the gate over the whole pool; (b) ``ShardedMapVO`` at the
    JAX dry-run's production shape (``VOConfig()``) over 30 frames, held
    to ``VisualOdometry``'s run on them here; (c) ``MultiStreamVO`` with
    the 72 streams of step 6 split 36 and 36, held to step 6's records.  Then
    (d) one rank of an NCCL group.  Returns each rank's launch counts."""
    import tempfile

    import numpy as np
    import torch
    import torch.multiprocessing as mp

    from rgbd_visualodometry_tpu_torch import VOConfig, VisualOdometry
    from rgbd_visualodometry_tpu_torch.evaltools import ate_rmse
    from rgbd_visualodometry_tpu_torch.io.synthetic import _pose_inverse as pose_inverse

    t_phase = time.perf_counter()
    cfg = VOConfig()
    frames = make_frames(cfg, DIST_FRAMES)
    feed = [(f.rgb, f.depth, f.timestamp) for f in frames]
    gt = [pose_inverse(f.T_c_w)[4:7].tolist() for f in frames]
    vo = VisualOdometry(cfg, device="cuda")
    res = [vo.process(*f) for f in feed]
    torch.cuda.synchronize()
    ref = dict(gt=gt, is_keyframe=[r.is_keyframe for r in res], pose_w_c=[r.pose_w_c.tolist() for r in res],
               inliers=[r.stats["num_inliers"] for r in res], pool_bytes=_pool_bytes(vo.state),
               ate=ate_rmse([r.timestamp for r in res if r.tracked], [r.pose_w_c[4:7] for r in res if r.tracked],
                            [f.timestamp for f in frames], gt))
    if not all(r.tracked for r in res):
        raise AssertionError("distributed: VisualOdometry did not track every frame")
    del vo
    torch.cuda.empty_cache()
    print(f"distributed: VisualOdometry on the card, VOConfig() (640x480, 500 features, 65536 map points, "
          f"512 keyframes, local BA): {len(res)}/{len(res)} tracked, ATE {100 * ref['ate']:.3f} cm, "
          f"{sum(ref['is_keyframe'])} keyframes, pool {ref['pool_bytes']} B")

    with tempfile.TemporaryDirectory() as tmp:
        big = ("rgb", "depth", "stamps", "gt", "records")  # [steps, streams, ...], read by the ranks from files
        for k in big:
            np.save(os.path.join(tmp, f"{k}.npy"), ms_ref[k])
        small_ref = {k: v for k, v in ms_ref.items() if k not in big}
        t0 = time.perf_counter()
        mp.start_processes(_rank_main, args=(2, "gloo", f"file://{tmp}/gloo", _gloo_job, (feed, ref, tmp, small_ref),
                                             tmp), nprocs=2, start_method="spawn")
        ranks = []
        for r in range(2):
            with open(os.path.join(tmp, f"_gloo_job_{r}.json")) as f:
                ranks.append(json.load(f))
        gloo_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        mp.start_processes(_rank_main, args=(1, "nccl", f"file://{tmp}/nccl", _nccl_job, (feed[:NCCL_FRAMES],), tmp),
                           nprocs=1, start_method="spawn")
        with open(os.path.join(tmp, "_nccl_job_0.json")) as f:
            nccl = json.load(f)
        nccl_s = time.perf_counter() - t0

    a, b, c = ([r[k] for r in ranks] for k in ("a", "b", "c"))
    print(f"distributed (a): sharded_match_descriptors at C=65536 ({a[0]['rows']} rows a rank), N=500 over gloo "
          f"with CUDA tensors: exactly the plain matcher + gate_matches over the whole pool on both ranks, and K2 "
          f"on the whole pool exactly its plain version "
          f"(min distance {a[0]['min_distance']}, {a[0]['matched']} + {a[1]['matched']} matched)")
    for r, x in enumerate(b):
        print(f"distributed (b) rank {r}: ShardedMapVO(VOConfig()) {x['tracked']}/{DIST_FRAMES} tracked, ATE "
              f"{100 * x['ate']:.3f} cm ({x['ate'] / ref['ate']:.3f}x VisualOdometry's), {x['keyframes']} keyframes, "
              f"{x['ba_dispatches']} BA, replicated leaves equal across ranks after every frame: {x['agree']}, "
              f"launches {x['counts']}, pool {x['pool_bytes']} B (VisualOdometry {ref['pool_bytes']} B)")
        print(f"distributed (b) rank {r}: keyframe decisions "
              + ("equal to VisualOdometry's on every frame" if x["first_keyframe_difference"] is None
                 else f"first differ at {x['first_keyframe_difference']}"))
        print(f"distributed (b) rank {r}: {x['ms_frame']:.2f} ms/frame median over frames {WARMUP_FRAMES}-"
              f"{DIST_FRAMES - 1} ({SHARE_NOTE}; {smi})")
    for r, x in enumerate(c):
        print(f"distributed (c) rank {r}: MultiStreamVO streams {x['streams'][0]}-{x['streams'][1] - 1} of 72, "
              f"{x['tracked']}/{x['frames']} stream-frames tracked, ATE max {100 * x['ate_max']:.3f} cm (one process "
              f"{100 * ms_ref['ate_max']:.3f} cm), {x['ba_dispatches']} BA dispatches (one process "
              f"{ms_ref['ba_dispatches']}), launches {x['counts']}")
        print(f"distributed (c) rank {r}: the whole [72, 32] records against one process's: decisions "
              f"({', '.join(MS_DECISIONS)}) differ on {x['decisions_differ']} of {x['frames']} stream-frames"
              + (f" (first at {x['first_decision_difference']})" if x["first_decision_difference"] else "")
              + f"; counts on {x['counts_differ']} (largest differences "
              f"{ {k: v for k, v in x['count_diff_max'].items() if v} }); poses {1e3 * x['dt_max']:.4f} mm and "
              f"{x['drot_max_deg']:.4f} deg apart at most; each stream's ATE against one process's: largest "
              f"ratio {max(a / b for a, b in zip(x['ates'], x['ates_ref'])):.4f}, largest difference "
              f"{1e3 * max(a - b for a, b in zip(x['ates'], x['ates_ref'])):.4f} mm")
        print(f"distributed (c) rank {r}: {x['fps']:.2f} stream-frames/s over steps {MS_WARMUP}-{ms_ref['steps'] - 1}, "
              f"{x['ms_step']:.2f} ms/step median ({SHARE_NOTE}; {smi})")
    for r, x in enumerate(c):
        if x["decisions_differ"]:
            raise AssertionError(f"distributed (c) rank {r}: decisions differ from one process's on "
                                 f"{x['decisions_differ']} stream-frames, first at {x['first_decision_difference']}")
        worse = [(s, a, b) for s, (a, b) in enumerate(zip(x["ates"], x["ates_ref"]))
                 if a > MS_ATE_RATIO * b + MS_ATE_SLACK_M]
        if worse or x["ate_max"] > MS_ATE_RATIO * ms_ref["ate_max"] + MS_ATE_SLACK_M:
            raise AssertionError(f"distributed (c) rank {r}: ATE max {x['ate_max']} m (one process "
                                 f"{ms_ref['ate_max']} m); streams above {MS_ATE_RATIO}x one process's + "
                                 f"{MS_ATE_SLACK_M} m: {worse}")
    print(f"distributed (d): ShardedMapVO on a one-rank {nccl['backend']} group, {nccl['frames']} frames: discrete "
          f"outputs equal to VisualOdometry's, poses within {nccl['max_pose_diff']:.3g}, launches {nccl['counts']}")
    print(f"distributed: gloo ranks {gloo_s:.1f} s, NCCL rank {nccl_s:.1f} s, phase {time.perf_counter() - t_phase:.1f} s")
    return dict(sharded=[x["counts"] for x in b], multistream=[x["counts"] for x in c], nccl=nccl["counts"])


def profile_phase(label, unit, step, timed, profiled, dispatches, extra=()):
    """``--profile``: where one ``unit`` (a frame, or a batch step) of ``step``
    goes.  Stage times come from wrapping the frontend's stages and
    ``backend.ba_step`` with synchronised host timers over the items of
    ``timed``; the device busy share and the top kernels from
    ``torch.profiler`` over those of ``profiled`` (timers off), in the
    function returned: the caller runs it after the kernel timings, whose
    profiler windows lose events after a long trace.  ``dispatches()``
    reads the BA dispatch count; ``extra`` holds more ``(object,
    attribute, label)`` stages to time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from rgbd_visualodometry_tpu_torch.pipeline import backend, frontend

    stages: dict = {}

    def wrap(mod, name, label):
        fn = getattr(mod, name)

        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            stages[label] = stages.get(label, 0.0) + time.perf_counter() - t0
            return out

        setattr(mod, name, wrapper)
        return mod, name, fn

    patches = [
        wrap(frontend.orb, "extract", "orb.extract (pyramid, K1, Harris, BRIEF)"),
        wrap(frontend.mapstate, "tracking_map_mask", "tracking_map_mask"),
        wrap(frontend.matching, "nearest_keypoints_packed", "nearest_keypoints_packed (K2)"),
        wrap(frontend, "_match_and_estimate", "2 rounds: gate, compaction, RANSAC, LM"),
        wrap(frontend, "apply_updates", "apply_updates (keyframe, map, DLT)"),
        wrap(backend, "ba_step", "ba_step (local BA)"),
    ] + [wrap(*e) for e in extra]
    ba_before = dispatches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for x in timed:
        step(x)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / len(timed)
    for mod, name, fn in patches:
        setattr(mod, name, fn)
    print(f"profile ({label}): {1e3 * wall:.2f} ms/{unit} with stage timers over {len(timed)} {unit}s, "
          f"{dispatches() - ba_before} BA dispatches")
    for what, sec in sorted(stages.items(), key=lambda kv: -kv[1]):
        print(f"  {1e3 * sec / len(timed):9.2f} ms/{unit}  {100 * sec / len(timed) / wall:5.1f}%  {what}")
    rest = wall - sum(stages.values()) / len(timed)
    print(f"  {1e3 * rest:9.2f} ms/{unit}  {100 * rest / wall:5.1f}%  the rest (gray, depth lookup, FSM, host loop, record copy)")

    def trace():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for x in profiled:
                step(x)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / len(profiled)
        kernels_ev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.time_range.elapsed_us() for e in kernels_ev) / 1e6 / len(profiled)
        print(f"profiler ({label}): {1e3 * wall:.2f} ms/{unit} under the profiler, "
              f"{len(kernels_ev) / len(profiled):.0f} device kernels/{unit}, device busy {1e3 * busy:.2f} "
              f"ms/{unit} ({100 * busy / wall:.1f}% of wall)")
        averages = prof.key_averages()
        for key in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(averages[0], key):
                print(averages.table(sort_by=key, row_limit=12, max_name_column_width=60))
                break

    return trace


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "rgbd_visualodometry_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from rgbd_visualodometry_tpu_torch import kernels

    t0 = time.perf_counter()
    lib = kernels.build(verbose=True)
    print(f"built {os.path.relpath(lib, HERE)} in {time.perf_counter() - t0:.2f} s")
    print(f"SASS instructions per kernel: {sass_summary(lib) or 'cuobjdump not found'}")

    cfg, full_cfg = slice_config(), full_vo_config()
    t0 = time.perf_counter()
    frames = make_frames(cfg, N_FRAMES)  # the two configs share the camera
    print(f"rendered {len(frames)} frames {cfg.image_width}x{cfg.image_height} in {time.perf_counter() - t0:.1f} s")

    time_k1_k2 = kernel_phase(frames[0], cfg, dev)
    time_k3 = k3_phase(dev)
    check_run("slice (no BA)", frames, cfg, slice_phase(frames, cfg, dev))
    full_run = slice_phase(frames, full_cfg, dev)
    counts = check_run("full VO", frames, full_cfg, full_run)
    offline_relax(full_run, frames)
    del full_run
    t0 = time.perf_counter()
    lcfg = loop_config()
    circuit, depths = loop_frames(lcfg)
    print(f"rendered the {len(circuit)}-frame loop circuit in {time.perf_counter() - t0:.1f} s")
    loop_counts = {mode: loop_phase(lcfg, circuit, depths, dev, relax_async=mode == "async") for mode in ("sync", "async")}
    del circuit, depths
    loop_counts["stall_contract"] = stall_contract_phase(dev)
    cli_counts = cli_phase(dev)
    bench_counts = bench_phase(smi, dev)
    profiling = "--profile" in sys.argv[1:]
    time_batched, profile_batched, ms_ref = multistream_phase(multistream_config(), dev,
                                                              profile_steps=3 if profiling else 0)
    dist_counts = distributed_phase(smi, ms_ref)
    del ms_ref
    # torch.profiler may slow the host's later launches: the stage timers
    # first, then the kernels' CUDA events, then their profiler timings,
    # then the profiler's traces of whole steps
    traces = []
    if profiling:
        from rgbd_visualodometry_tpu_torch import VisualOdometry

        vo = VisualOdometry(full_cfg, device=dev)
        for f in frames[:5]:
            vo.process(f.rgb, f.depth, f.timestamp)
        traces = [profile_phase("full VO", "frame", lambda f: vo.process(f.rgb, f.depth, f.timestamp),
                                frames[5:15], frames[15:25], lambda: vo.ba_dispatches), profile_batched()]
    print(f"SM clock, max before the kernel timings: {sm_clocks()}")
    pending = time_k1_k2() + time_k3()
    entries = [_entry(t) for t in pending][:3]  # K3 at 65536x512 in the JSON line, 16384x500 printed
    batched = time_batched()
    print(f"SM clock, max after the kernel timings: {sm_clocks()}")
    for trace in traces:
        trace()

    for e in entries:  # K3's `launches` is its own path's; per frame, every kernel's is full VO's
        e.setdefault("launches", counts[e["name"]])
        e["launches_per_frame"] = counts[e["name"]] / len(frames)
        if e["name"] in batched[MS_STREAMS]:  # K1 and K2 on the multistream path, at its shapes
            e["multistream"] = batched[MS_STREAMS][e["name"]]
            e["multistream"]["tracking_launches"] = bench_counts["tracking"][e["name"]]
            e["multistream"]["tracking"] = batched[TRACKING_STREAMS][e["name"]]
            e["bench_single_launches"] = bench_counts["single"][e["name"]]
            e["loop_closure_launches"] = {mode: c[e["name"]] for mode, c in loop_counts.items()}
            e["cli_launches"] = {run: c[e["name"]] for run, c in cli_counts.items()}
            e["distributed_launches"] = {
                "sharded_map_per_rank": [c[e["name"]] for c in dist_counts["sharded"]],
                "multistream_per_rank": [c[e["name"]] for c in dist_counts["multistream"]],
                "nccl_sharded_map": dist_counts["nccl"][e["name"]],
            }
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
