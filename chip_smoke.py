#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit) and builds the
   hand-written kernels from ``rgbd_visualodometry_tpu_torch/csrc``.
2. Kernel phase: each kernel against its plain torch version on the card,
   with ``torch.equal`` after a synchronise (both are exact), at the shapes
   of the main path - K1 ``fast_nms`` on every pyramid level of a 640x480
   synthetic frame, K2 ``hamming_nn`` at N = 500 keypoints x C = 16384 map
   rows with ~10% of the keypoint mask off, a tie-heavy case and a ragged C -
   and the median time of each (CUDA events).
3. Slice phase: ``VisualOdometry(cfg, device="cuda").run`` over 60 frames of
   the single-stream bench workload (640x480, fr1 intrinsics, 500 ORB
   features over 8 levels, 16384 map points, packed matching, no local BA).
   Every frame must be tracked, the ATE against the exact ground truth must
   be < 3 cm, and the launch counters must show both kernels on the path.
4. With ``--profile``: a breakdown of one frame's time by stage and the
   device busy share (torch.profiler) - not part of the default run.
5. Prints the kernels' JSON line, then ``{"ok": true, "device": ...}`` as the
   last line.

Any failure raises and exits nonzero; without a CUDA device, or without the
repository beside this file, it exits nonzero before printing a result.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
N_FRAMES = 60
WARMUP_FRAMES = 10
ATE_LIMIT_M = 0.03


def slice_config():
    """``bench.single_stream_cfg(VOConfig())`` with packed matching and no
    local BA - written out here because bench.py imports the JAX package."""
    from rgbd_visualodometry_tpu_torch import VOConfig

    return VOConfig().replace(
        max_mappoints=16384, max_keyframes=128, max_obs_per_mappoint=8,
        ba_max_points=1024, ba_max_poses=8, pnp_max_points=512,
        triangulation_batch=128, ransac_hypotheses=64,
        packed_matching=True, enable_local_optimization=False,
    )


def make_frames(cfg, n: int, seed: int = 0):
    """The frames of ``bench._make_frames``: the synthetic textured plane,
    a constant-velocity drift with yaw."""
    from rgbd_visualodometry_tpu_torch import _shared

    scene = _shared.SyntheticScene(
        width=cfg.image_width, height=cfg.image_height,
        fx=cfg.camera_fx, fy=cfg.camera_fy, cx=cfg.camera_cx, cy=cfg.camera_cy,
        seed=seed,
    )
    return _shared.generate_sequence(n, scene=scene, step_t=(0.012, 0.002, 0.0), step_r=(0.0, 0.0, 0.003))


def _median_ms(fn, iters: int = 30, warmup: int = 3) -> float:
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


def kernel_phase(frame, cfg, dev):
    """Compare K1 and K2 with their plain versions; return the JSON entries
    (without launch counts) of both kernels."""
    import numpy as np
    import torch

    from rgbd_visualodometry_tpu_torch import kernels
    from rgbd_visualodometry_tpu_torch.ops import fast, image as im, matching

    gray = im.rgb_to_gray(torch.from_numpy(frame.rgb).to(dev))
    pyr = im.build_pyramid(gray, cfg.level_pyramid, cfg.scale_factor)
    quotas = im.features_per_level(cfg.number_of_features, cfg.level_pyramid, cfg.scale_factor)
    levels = [lvl for lvl, q in zip(pyr, quotas) if q > 0]
    k1_err = 0.0
    for i, lvl in enumerate(levels):
        got = fast.fast_nms(lvl)
        want = fast.fast_nms_reference(lvl)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"K1 fast_nms differs from its plain version on level {i} {tuple(lvl.shape)}")
        k1_err = max(k1_err, float((got - want).abs().max()))
    k1_ms = _median_ms(lambda: [fast.fast_nms(lvl) for lvl in levels])
    k1_plain = _median_ms(lambda: [fast.fast_nms_reference(lvl) for lvl in levels])
    print(f"K1 fast_nms: {len(levels)} levels {[tuple(l.shape) for l in levels]} bit-exact; "
          f"per frame kernel {k1_ms:.4f} ms, plain {k1_plain:.4f} ms")

    rng = np.random.default_rng(0)
    N, C = cfg.number_of_features, cfg.max_mappoints

    def words(n):
        return torch.from_numpy(rng.integers(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32).view(np.int32)).to(dev)

    cand, kp = words(C), words(N)
    mask = torch.from_numpy(rng.random(N) >= 0.1).to(dev)
    tie_kp = kp.clone()
    tie_kp[N // 2:] = kp[: N - N // 2]  # duplicated keypoints: ties everywhere
    tie_cand = cand.clone()
    tie_cand[: C // 4] = kp[torch.arange(C // 4, device=dev) % N]  # exact hits at distance 0
    cases = {
        "main": (cand, kp, mask),
        "ties": (tie_cand, tie_kp, mask),
        "ragged": (cand[: C - 1].contiguous(), kp, mask),
        "all_masked": (cand[:1000].contiguous(), kp, torch.zeros_like(mask)),
    }
    k2_err = 0
    for name, (c, k, m) in cases.items():
        got = matching.nearest_keypoints_packed(c, k, m)
        want = matching.hamming_nn_reference(c, k, m)
        torch.cuda.synchronize()
        if not (torch.equal(got.kp_index, want.kp_index) and torch.equal(got.distance, want.distance)):
            raise AssertionError(f"K2 hamming_nn differs from its plain version ({name}, C={c.shape[0]})")
        k2_err = max(k2_err, int((got.distance - want.distance).abs().max()))
    k2_ms = _median_ms(lambda: matching.nearest_keypoints_packed(cand, kp, mask))
    k2_plain = _median_ms(lambda: matching.hamming_nn_reference(cand, kp, mask))
    print(f"K2 hamming_nn: N={N} C={C} (+ties, ragged C={C - 1}, all masked) exact; "
          f"kernel {k2_ms:.4f} ms, plain {k2_plain:.4f} ms")
    entry = lambda k, err, ms, plain: dict(  # noqa: E731
        name=k.name, route="cuda", source=k.source, replaces=k.replaces,
        max_abs_err=err, ms=ms, plain_ms=plain,
    )
    return [
        entry(kernels.FAST_NMS, k1_err, k1_ms, k1_plain),
        entry(kernels.HAMMING_NN, k2_err, k2_ms, k2_plain),
    ], len(levels)


def slice_phase(frames, cfg, dev):
    """Drive ``VisualOdometry.run`` over the frames; return (results,
    per-frame seconds after the warm-up, launch counts)."""
    import torch

    from rgbd_visualodometry_tpu_torch import VisualOdometry, kernels

    stamps = []

    def feed():
        for f in frames:
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            yield f.rgb, f.depth, f.timestamp
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    vo = VisualOdometry(cfg, device=dev)
    kernels.reset_counts()
    results = vo.run(feed())
    torch.cuda.synchronize()
    counts = kernels.counts()
    step_s = [b - a for a, b in zip(stamps[:-1], stamps[1:])][WARMUP_FRAMES:]
    return results, step_s, counts


def profile_phase(frames, cfg, dev, warm: int = 5, measured: int = 10) -> None:
    """``--profile``: where one frame's time goes.  Stage times come from
    wrapping the frontend's stages with synchronised host timers; the device
    busy share and the top kernels from ``torch.profiler`` over the same
    frames (timers off)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from rgbd_visualodometry_tpu_torch import VisualOdometry
    from rgbd_visualodometry_tpu_torch.pipeline import frontend

    stages: dict = {}

    def timed(mod, name, label):
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

    vo = VisualOdometry(cfg, device=dev)
    for f in frames[:warm]:
        vo.process(f.rgb, f.depth, f.timestamp)
    patches = [
        timed(frontend.orb, "extract", "orb.extract (pyramid, K1, Harris, BRIEF)"),
        timed(frontend.mapstate, "tracking_map_mask", "tracking_map_mask"),
        timed(frontend.matching, "nearest_keypoints_packed", "nearest_keypoints_packed (K2)"),
        timed(frontend, "_match_and_estimate", "2 rounds: gate, compaction, RANSAC, LM"),
        timed(frontend, "apply_updates", "apply_updates (keyframe, map, DLT)"),
    ]
    todo = frames[warm : warm + measured]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for f in todo:
        vo.process(f.rgb, f.depth, f.timestamp)
    wall = (time.perf_counter() - t0) / len(todo)
    for mod, name, fn in patches:
        setattr(mod, name, fn)
    print(f"profile: {1e3 * wall:.2f} ms/frame with stage timers over frames {warm}-{warm + len(todo) - 1}")
    for label, sec in sorted(stages.items(), key=lambda kv: -kv[1]):
        print(f"  {1e3 * sec / len(todo):9.2f} ms/frame  {100 * sec / len(todo) / wall:5.1f}%  {label}")

    todo = frames[warm + measured : warm + 2 * measured]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for f in todo:
            vo.process(f.rgb, f.depth, f.timestamp)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / len(todo)
    kernels_ev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels_ev) / 1e6 / len(todo)
    print(f"profiler: {1e3 * wall:.2f} ms/frame under the profiler, {len(kernels_ev) / len(todo):.0f} device "
          f"kernels/frame, device busy {1e3 * busy:.2f} ms/frame ({100 * busy / wall:.1f}% of wall)")
    averages = prof.key_averages()
    for key in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(averages[0], key):
            print(averages.table(sort_by=key, row_limit=12, max_name_column_width=60))
            break


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
    from rgbd_visualodometry_tpu_torch._shared import pose_inverse
    from rgbd_visualodometry_tpu_torch.evaltools import ate_rmse

    t0 = time.perf_counter()
    lib = kernels.build(verbose=True)
    print(f"built {os.path.relpath(lib, HERE)} in {time.perf_counter() - t0:.2f} s")

    cfg = slice_config()
    t0 = time.perf_counter()
    frames = make_frames(cfg, N_FRAMES)
    print(f"rendered {len(frames)} frames {cfg.image_width}x{cfg.image_height} in {time.perf_counter() - t0:.1f} s")

    entries, n_levels = kernel_phase(frames[0], cfg, dev)

    results, step_s, counts = slice_phase(frames, cfg, dev)
    tracked = sum(r.tracked for r in results)
    gt_xyz = [pose_inverse(f.T_c_w)[4:7] for f in frames]
    ate = ate_rmse(
        [r.timestamp for r in results if r.tracked], [r.pose_w_c[4:7] for r in results if r.tracked],
        [f.timestamp for f in frames], gt_xyz,
    )
    ms_frame = 1e3 * statistics.median(step_s)
    print(f"slice: {tracked}/{len(frames)} tracked, ATE {ate * 100:.3f} cm, "
          f"{ms_frame:.2f} ms/frame median over frames {WARMUP_FRAMES}-{len(frames) - 1} "
          f"(p90 {1e3 * sorted(step_s)[int(0.9 * len(step_s))]:.2f} ms), keyframes "
          f"{sum(r.is_keyframe for r in results)}, map points {results[-1].stats['num_mappoints']}")
    print(f"launches on the main path: {counts}")
    if len(results) != len(frames) or tracked != len(frames):
        raise AssertionError(f"tracked {tracked} of {len(frames)} frames")
    if not (math.isfinite(ate) and ate < ATE_LIMIT_M):
        raise AssertionError(f"ATE {ate} m is not below {ATE_LIMIT_M} m")
    if counts["fast_nms"] != len(frames) * n_levels:
        raise AssertionError(f"fast_nms launched {counts['fast_nms']} times, expected {len(frames) * n_levels}")
    if counts["hamming_nn"] != len(frames):
        raise AssertionError(f"hamming_nn launched {counts['hamming_nn']} times, expected {len(frames)}")

    if "--profile" in sys.argv[1:]:
        profile_phase(frames, cfg, dev)

    for e in entries:
        e["launches"] = counts[e["name"]]
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
