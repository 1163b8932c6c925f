"""Tiny cells for the benchmark's CPU tests: a copy of ``vobench`` and a
``BENCHMARK.json`` beside it that add 160x120 configurations, traffic
mixes of a few streams and their cells (``tiny_fleet``, ``tiny_single``)."""

from __future__ import annotations

import json
import pathlib
import shutil

REPO = pathlib.Path(__file__).resolve().parents[2]
TINY = dict(image_width=160, image_height=120, camera_fx=129.3, camera_fy=129.1, camera_cx=79.6, camera_cy=63.8,
            number_of_features=200, level_pyramid=3, max_keyframes=16, max_mappoints=1024, max_obs_per_mappoint=4,
            pnp_max_points=128, triangulation_batch=64, ransac_hypotheses=16, ba_max_poses=4, ba_max_points=256)
CAMERA = dict(width=160, height=120, fx=129.3, fy=129.1, cx=79.6, cy=63.8, depth_scale=5000.0)
# loose: the tiny cells test the control flow, not the limits; the faults
# read far beyond them (a 1 cm pose, a state left as it was)
LIMITS = {"kp_off": 20, "desc_bits_off": 200, "match_off": 20, "pose_gap_um": 200.0, "rot_gap_urad": 100.0,
          "map_off": 20, "map_gap_um": 500.0, "ba_gap_um": 200.0, "ba_flags_off": 20}


def tiny_copy(root: pathlib.Path, streams: int = 3) -> pathlib.Path:
    """Copy ``vobench`` under ``root`` and add the tiny cells; returns the
    copy's ``vobench`` folder."""
    here = root / "vobench"
    shutil.copytree(REPO / "vobench", here, ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    mixes = {"tiny_mix": streams, "tiny_mix1": 1}
    cells = {"tiny_fleet": ("MultiStreamVO", "tiny_mix",
                            dict(packed_matching=True, enable_local_optimization=True, ba_min_frame_gap=3)),
             "tiny_single": ("VisualOdometry", "tiny_mix1", {})}
    for name, (entry, mix, extra) in cells.items():
        conf = dict(name=name, entry=entry, settings=dict(TINY, **extra))
        (here / "configs" / f"{name}.json").write_text(json.dumps(conf))
        bench["configs"].append(dict(name=name, source="test", file=f"vobench/configs/{name}.json", reduced=[],
                                     why="test"))
        bench["workloads"].append(dict(name=name, config=name, traffic=mix, chips=1, why="test"))
        (here / "limits" / f"{name}.json").write_text(json.dumps(LIMITS))
    for mix, s in mixes.items():
        tr = json.loads((REPO / "vobench/traffic/xyz_sweep_72.json").read_text())
        tr.update(name=mix, streams=s, warmup=6, check=dict(track_samples=2, ba_samples=1, sample_streams=min(s, 2)),
                  trace=dict(min_steps=2, max_steps=4))
        (here / "traffic" / f"{mix}.json").write_text(json.dumps(tr))
    for m in bench["per_layer"]:
        m.setdefault("workloads", [])
        m["workloads"] += list(cells)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return here
