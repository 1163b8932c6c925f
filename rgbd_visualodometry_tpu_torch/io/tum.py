"""TUM RGB-D dataset loading and RGB<->depth timestamp association.

The PyTorch port's own copy of ``rgbd_visualodometry_tpu/io/tum.py``,
identical in behaviour (``tests/test_torch_tum.py`` holds the two
together), so the port loads no file of the JAX package.  The one change:
without the native loader, frames decode through the port's own
:mod:`rgbd_visualodometry_tpu_torch.io.png` (numpy and ``zlib``) where the
original calls ``cv2.imread``, which the CUDA machines may lack; both give
the same arrays.

Host-side equivalent of the reference's dataset plumbing: the
``associate.txt`` parser in ``app/run_vo.cpp:39-64`` and the association
algorithm of ``tools/associate.py`` (greedy nearest-timestamp matching
within a 0.02 s window).  The device pipeline receives raw uint8/uint16
arrays.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator, Sequence

import numpy as np

from rgbd_visualodometry_tpu_torch.io import png


def read_file_list(path: str) -> dict[float, list[str]]:
    """Parse a TUM-format file list: ``timestamp data...`` per line,
    ``#`` comments ignored (tools/associate.py:49-69 semantics)."""
    out: dict[float, list[str]] = {}
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            out[float(parts[0])] = parts[1:]
    return out


def associate(
    first: Sequence[float],
    second: Sequence[float],
    offset: float = 0.0,
    max_difference: float = 0.02,
) -> list[tuple[int, int]]:
    """Greedy nearest-timestamp association (tools/associate.py:71-101
    semantics): all candidate pairs within the window, sorted by |dt|,
    greedily taken with each timestamp used at most once.  Returns index
    pairs into the input sequences, sorted by first-timestamp.
    """
    first = np.asarray(list(first), dtype=np.float64)
    second = np.asarray(list(second), dtype=np.float64)
    if len(first) == 0 or len(second) == 0:
        return []
    diff = np.abs(first[:, None] - (second[None, :] + offset))
    ii, jj = np.nonzero(diff < max_difference)
    order = np.argsort(diff[ii, jj], kind="stable")
    used_i: set[int] = set()
    used_j: set[int] = set()
    matches = []
    for k in order:
        i, j = int(ii[k]), int(jj[k])
        if i in used_i or j in used_j:
            continue
        used_i.add(i)
        used_j.add(j)
        matches.append((i, j))
    matches.sort(key=lambda m: first[m[0]])
    return matches


@dataclass
class TumRecord:
    timestamp: float
    rgb_path: str
    depth_path: str


def parse_associate_file(dataset_dir: str, name: str = "associate.txt") -> list[TumRecord]:
    """Parse ``associate.txt`` lines ``rgb_t rgb_file depth_t depth_file``
    exactly like ``run_vo.cpp:39-64`` (frame timestamp = rgb timestamp)."""
    records = []
    with open(os.path.join(dataset_dir, name), "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            rgb_t, rgb_f, depth_t, depth_f = line.split()[:4]
            records.append(
                TumRecord(
                    timestamp=float(rgb_t),
                    rgb_path=os.path.join(dataset_dir, rgb_f),
                    depth_path=os.path.join(dataset_dir, depth_f),
                )
            )
    return records


def build_associate_records(dataset_dir: str) -> list[TumRecord]:
    """Associate ``rgb.txt``/``depth.txt`` directly (the tools/associate.py
    step the reference requires the user to run beforehand)."""
    rgb = read_file_list(os.path.join(dataset_dir, "rgb.txt"))
    depth = read_file_list(os.path.join(dataset_dir, "depth.txt"))
    rt = sorted(rgb)
    dt = sorted(depth)
    records = []
    for i, j in associate(rt, dt):
        records.append(
            TumRecord(
                timestamp=rt[i],
                rgb_path=os.path.join(dataset_dir, rgb[rt[i]][0]),
                depth_path=os.path.join(dataset_dir, depth[dt[j]][0]),
            )
        )
    return records


def load_frame(rec: TumRecord) -> tuple[np.ndarray, np.ndarray]:
    """Decode one RGB-D pair: uint8 [H, W, 3] RGB + uint16 [H, W] raw depth
    (the ``cv::imread(color) / cv::imread(depth, -1)`` pair at
    ``run_vo.cpp:91-92``)."""
    return png.read_color(rec.rgb_path), png.read_depth(rec.depth_path)


def iter_dataset(
    dataset_dir: str,
    width: int = 640,
    height: int = 480,
    use_native: bool = True,
) -> Iterator[tuple[TumRecord, np.ndarray, np.ndarray]]:
    """Yield (record, rgb, depth) over a TUM directory, preferring an
    existing ``associate.txt`` and falling back to on-the-fly association.

    When the native C++ loader is available (and ``use_native``), PNG decode
    runs in a background worker pool that prefetches ahead of the tracking
    loop; otherwise frames are decoded synchronously like the reference
    (``run_vo.cpp:91-92``).
    """
    if os.path.exists(os.path.join(dataset_dir, "associate.txt")):
        records = parse_associate_file(dataset_dir)
    else:
        records = build_associate_records(dataset_dir)

    if use_native:
        from rgbd_visualodometry_tpu_torch import native

        if native.available():
            loader = native.NativeLoader(
                [r.rgb_path for r in records],
                [r.depth_path for r in records],
                width=width, height=height,
            )
            for idx, rgb, depth in loader:
                yield records[idx], rgb, depth
            return

    for rec in records:
        rgb, depth = load_frame(rec)
        yield rec, rgb, depth
