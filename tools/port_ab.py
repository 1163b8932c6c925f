#!/usr/bin/env python3
"""Two checkouts of the PyTorch/CUDA port against each other on one GPU, in
turns, in one call.

    python3 tools/port_ab.py --base DIR [--pairs 4] [--out FILE]

``DIR`` is another checkout of the repository, for example a parent commit
unpacked with ``git archive`` into a gitignored directory; "head" is the
checkout that holds this script.  One worker process per turn, in ABBA
order (base, head, head, base, base, head, ...), ``--pairs`` pairs.  A
worker imports the port and ``chip_smoke.py`` of its own checkout and runs:

1. that ``chip_smoke.py``'s two 60-frame runs (``slice_phase``): the slice
   without BA, then full VO.  Per run: the median ms/frame over frames
   10-59, its p90, BA ms per dispatch, tracked frames, keyframes, map
   points and the kernels' launch counts;
2. K1 over the pyramid levels of frame 0 (one ``fast_nms_pyramid`` call
   where the checkout has it, else one ``fast_nms`` call per level) and K2
   ``nearest_keypoints_packed`` at N = 500, C = 16384 on seeded inputs,
   each checked equal to its plain version, then timed: device time per
   call (torch.profiler self device time of the kernels whose name holds
   ``fast_nms`` / ``hamming_nn``) and wrapper-inclusive time (CUDA events
   around one call), both with the helpers of head's ``chip_smoke.py``;
3. K3 ``hamming_matrix_packed`` at C x N = 65536 x 512 (the parity bench's
   shape) and 16384 x 500 (the main path's pool) on seeded inputs, checked
   equal to its plain version, then timed the same way (kernels whose name
   holds ``hamming_matrix``).

Prints one JSON line per worker, then the median of each number per
checkout, and writes all of it to ``--out`` if given.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys

HEAD = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TAG = "PORT_AB "


def _head_smoke():
    """Head's ``chip_smoke.py`` under its own module name, for its timing
    helpers: the worker's ``chip_smoke`` is its checkout's."""
    spec = importlib.util.spec_from_file_location("_head_chip_smoke", os.path.join(HEAD, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def worker(tree: str) -> dict:
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import chip_smoke as cs
    from rgbd_visualodometry_tpu_torch import kernels
    from rgbd_visualodometry_tpu_torch.ops import fast, image as im, matching

    helpers = _head_smoke()
    dev = torch.device("cuda", 0)
    kernels.build()
    out: dict = {"tree": tree}
    cfg = cs.slice_config()
    frames = cs.make_frames(cfg, cs.N_FRAMES)
    for name, c in (("slice", cfg), ("full_vo", cs.full_vo_config())):
        _, results, step_s, counts, ba_runs = cs.slice_phase(frames, c, dev)
        ba_s = [sec for sec, _ in ba_runs]
        out[name] = dict(
            ms_frame=1e3 * statistics.median(step_s),
            p90_ms=1e3 * sorted(step_s)[int(0.9 * len(step_s))],
            ba_ms=1e3 * statistics.median(ba_s) if ba_s else None,
            tracked=sum(r.tracked for r in results), keyframes=sum(r.is_keyframe for r in results),
            map_points=int(results[-1].stats["num_mappoints"]), launches=counts,
        )

    gray = im.rgb_to_gray(torch.from_numpy(frames[0].rgb).to(dev))
    pyr = im.build_pyramid(gray, cfg.level_pyramid, cfg.scale_factor)
    quotas = im.features_per_level(cfg.number_of_features, cfg.level_pyramid, cfg.scale_factor)
    levels = [lvl for lvl, q in zip(pyr, quotas) if q > 0]
    if hasattr(fast, "fast_nms_pyramid"):
        def k1():
            return fast.fast_nms_pyramid(levels)
    else:
        def k1():
            return [fast.fast_nms(lvl) for lvl in levels]

    rng = np.random.default_rng(0)

    def words(n):
        return torch.from_numpy(rng.integers(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32).view(np.int32)).to(dev)

    cand, kp = words(cfg.max_mappoints), words(cfg.number_of_features)
    mask = torch.from_numpy(rng.random(cfg.number_of_features) >= 0.1).to(dev)

    def k2():
        return matching.nearest_keypoints_packed(cand, kp, mask)

    kernels.reset_counts()
    got1, got2 = k1(), k2()
    torch.cuda.synchronize()
    per_call = kernels.counts()
    want2 = matching.hamming_nn_reference(cand, kp, mask)
    if not all(torch.equal(g, fast.fast_nms_reference(lvl)) for g, lvl in zip(got1, levels)) or not (
        torch.equal(got2.kp_index, want2.kp_index) and torch.equal(got2.distance, want2.distance)
    ):
        raise AssertionError(f"{tree}: a kernel differs from its plain version")
    out["k1"] = dict(
        levels=[tuple(lvl.shape) for lvl in levels], launches_per_call=per_call["fast_nms"],
        wrapper_ms=helpers._median_ms(k1), device_ms=helpers._device_ms(k1, "fast_nms"),
    )
    out["k2"] = dict(
        N=kp.shape[0], C=cand.shape[0], launches_per_call=per_call["hamming_nn"],
        wrapper_ms=helpers._median_ms(k2), device_ms=helpers._device_ms(k2, "hamming_nn"),
    )
    for key, (c, n) in (("k3", (65536, 512)), ("k3_main", (cfg.max_mappoints, cfg.number_of_features))):
        cand, kp = words(c), words(n)

        def k3(cand=cand, kp=kp):
            return matching.hamming_matrix_packed(cand, kp)

        if not torch.equal(k3(), matching.hamming_matrix_reference(cand, kp)):
            raise AssertionError(f"{tree}: K3 differs from its plain version at C={c}, N={n}")
        out[key] = dict(C=c, N=n, wrapper_ms=helpers._median_ms(k3), device_ms=helpers._device_ms(k3, "hamming_matrix"))
    return out


# (section, key) of every number summarised per checkout
METRICS = [(s, k) for s in ("slice", "full_vo") for k in ("ms_frame", "p90_ms", "ba_ms")] + [
    (s, k) for s in ("k1", "k2", "k3", "k3_main") for k in ("device_ms", "wrapper_ms")
]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", help="the other checkout's root")
    ap.add_argument("--pairs", type=int, default=4)
    ap.add_argument("--out", help="write every worker's numbers here as JSON")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(TAG + json.dumps(worker(os.path.abspath(args.worker))))
        return 0
    if not args.base:
        ap.error("--base is required")
    trees = {"base": os.path.abspath(args.base), "head": HEAD}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    order = []
    for i in range(args.pairs):
        order += ["base", "head"] if i % 2 == 0 else ["head", "base"]
    runs = []
    for turn, which in enumerate(order):
        p = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", trees[which]],
                           capture_output=True, text=True, timeout=900)
        lines = [ln[len(TAG):] for ln in p.stdout.splitlines() if ln.startswith(TAG)]
        if p.returncode or not lines:
            sys.stderr.write(p.stdout[-4000:] + p.stderr[-4000:])
            raise RuntimeError(f"turn {turn} ({which}) failed with exit code {p.returncode}")
        run = dict(json.loads(lines[-1]), which=which, turn=turn)
        runs.append(run)
        print(json.dumps(run))
    summary = {}
    for which in trees:
        mine = [r for r in runs if r["which"] == which]
        summary[which] = {f"{s}.{k}": statistics.median(r[s][k] for r in mine) for s, k in METRICS
                          if all(r[s][k] is not None for r in mine)}
        print(f"{which} ({trees[which]}), median of {len(mine)} turns: {json.dumps(summary[which])}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": smi, "order": order, "runs": runs, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
