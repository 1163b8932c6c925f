"""Roofline arithmetic of the benchmark: the card's published peaks, and the
operations and bytes of the work whose share of its roofline a metric
reports, as functions of shapes.

Copied from ``chip_smoke.py`` (``HBM_BYTES_PER_S``, ``PEAK_OPS_PER_S``,
``K1_OPS_PER_PIXEL``, ``_bound`` and the K1/K2 counts of its timings), so
that the yardstick stays here whatever the program does with its kernels.
"""

from __future__ import annotations

# published peaks of one H100 SXM (NVIDIA's data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"fp32": 67e12, "int8 tensor-core": 1979e12}
# sub/min/max per pixel of FAST-9 with 3x3 NMS: 16 ring differences, 128
# for the arc windows by doubling, 30 for the bright/dark maxima, 2 for the
# clamp and the bright/dark max, 9 for the 3x3 NMS window and its select
FAST_NMS_OPS_PER_PIXEL = 16 + 128 + 30 + 2 + 9
# a pixel's float32 read once and its score written once
FAST_NMS_BYTES_PER_PIXEL = 8


def bound_s(nbytes: float, ops: float, op_type: str) -> float:
    """Least time (s) of the work on the card: the larger of its bytes over
    the memory rate and its operations over the peak of their type."""
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[op_type])


def fast_nms_bound_s(pixels: float) -> float:
    """FAST-9 scores and their 3x3 NMS over ``pixels`` pixels (every level
    of every stream's pyramid): fp32 operations against 8 B a pixel."""
    return bound_s(FAST_NMS_BYTES_PER_PIXEL * pixels, FAST_NMS_OPS_PER_PIXEL * pixels, "fp32")


def hamming_nn_bound_s(rows: float, keypoints: float, streams: int = 1) -> float:
    """For each of ``streams`` streams, the nearest of its ``keypoints``
    packed 256-bit descriptors to each of its ``rows`` packed pool rows: a
    multiply-add per bit of each pair as int8 tensor-core operations,
    against the pool rows (32 B) and keypoints (32 B and a mask byte) read
    once and an index and a distance (8 B) per row written once."""
    return bound_s(streams * (32 * rows + 33 * keypoints + 8 * rows), streams * 2 * 256 * rows * keypoints,
                   "int8 tensor-core")
