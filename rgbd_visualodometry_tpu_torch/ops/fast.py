"""FAST-9/16 corner detection with 3x3 NMS, and Harris ranking.

Counterpart of ``rgbd_visualodometry_tpu/ops/fast.py``.  The NMS'd FAST
score map comes from kernel K1 (``csrc/fast_nms.cu``) for a CUDA tensor and
from :func:`fast_nms_reference`, its plain torch version, for a CPU tensor.
Both compute ``where(s >= maxpool3x3(s), s, 0)`` with ``s = fast_score``
over the edge-padded image and a -inf padded NMS window - the function the
reference's main path computes in XLA (``fast.py:113-117``) and its Pallas
kernel ``pallas_fast._fast_nms_kernel`` fuses.  Only subtraction, min and
max are involved, so the two agree bit for bit.
"""

from __future__ import annotations

import functools

import torch

from rgbd_visualodometry_tpu_torch import kernels
from rgbd_visualodometry_tpu_torch.ops import image as im
from rgbd_visualodometry_tpu_torch.ops import packing

# Bresenham circle of radius 3 in circular order, (dy, dx)
_CIRCLE = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3),
    (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3),
    (0, -3), (-1, -3), (-2, -2), (-3, -1),
)
ARC_LENGTH = 9


def fast_score(gray: torch.Tensor) -> torch.Tensor:
    """Per-pixel FAST-9 score: max over the 16 arcs of 9 of the min ring
    difference, bright and dark, clamped at 0 (edge-padded image)."""
    h, w = gray.shape
    p = im.edge_pad(gray, 3, 3, 3, 3)
    d = [p[3 + dy : 3 + dy + h, 3 + dx : 3 + dx + w] - gray for dy, dx in _CIRCLE]
    doubled = d + d[: ARC_LENGTH - 1]
    arc_min, arc_max = [], []
    for s in range(16):
        window = doubled[s : s + ARC_LENGTH]
        arc_min.append(functools.reduce(torch.minimum, window))
        arc_max.append(functools.reduce(torch.maximum, window))
    bright = functools.reduce(torch.maximum, arc_min)
    dark = functools.reduce(torch.maximum, [-x for x in arc_max])
    return torch.clamp_min(torch.maximum(bright, dark), 0.0)


def fast_nms_reference(gray: torch.Tensor) -> torch.Tensor:
    """Plain torch version of kernel K1: the NMS'd FAST score map."""
    score = fast_score(gray)
    return torch.where(score >= im.maxpool3x3(score), score, torch.zeros_like(score))


def fast_nms(gray: torch.Tensor) -> torch.Tensor:
    """NMS'd FAST-9 score map ``[H, W]`` float32: kernel K1 on CUDA, the
    plain version on the CPU."""
    if gray.dim() != 2 or gray.dtype != torch.float32:
        raise ValueError(f"fast_nms takes a float32 [H, W] image, got {gray.dtype} {tuple(gray.shape)}")
    if gray.device.type == "cpu":
        return fast_nms_reference(gray)
    if gray.device.type != "cuda":
        raise ValueError(f"fast_nms: no kernel for device {gray.device}")
    gray = gray.contiguous()
    h, w = gray.shape
    out = torch.empty_like(gray)
    kernels.FAST_NMS.launch(gray, out, h, w)
    return out


def harris_response(gray: torch.Tensor, k: float = 0.04) -> torch.Tensor:
    """Harris response with a 7x7 block (cv::ORB's ranking score), scaled
    by 1/255^4 like the reference."""
    ix, iy = im.sobel_gradients(gray)
    sxx = im.box_sum_of_products(ix, ix, 7)
    syy = im.box_sum_of_products(iy, iy, 7)
    sxy = im.box_sum_of_products(ix, iy, 7)
    det = im.fma(sxx, syy, -(sxy * sxy))
    tr = sxx + syy
    return im.fma(-(k * tr), tr, det) * (1.0 / (255.0**4))


def detect_level(gray: torch.Tensor, threshold: float, border: int, topk: int):
    """Up to ``topk`` FAST corners of one level, Harris-ranked.  Returns
    ``(xy int64 [topk, 2] as (x, y), response [topk], valid bool [topk])``."""
    if threshold < 0:
        raise ValueError("fast threshold must be >= 0")
    h, w = gray.shape
    # nms > threshold  <=>  score > threshold and score is the window max
    mask = fast_nms(gray) > threshold
    ys = torch.arange(h, device=gray.device)[:, None]
    xs = torch.arange(w, device=gray.device)[None, :]
    in_border = (ys >= border) & (ys < h - border) & (xs >= border) & (xs < w - border)
    mask = mask & in_border
    harris = harris_response(gray)
    ranked = torch.where(mask, harris, torch.full_like(harris, float("-inf"))).reshape(-1)
    vals, idx = packing.top_k(ranked, topk)
    valid = vals > float("-inf")
    xy = torch.stack([idx % w, idx // w], dim=-1)
    return xy, vals, valid
