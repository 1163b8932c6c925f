"""FAST-9/16 corner detection with 3x3 NMS, and Harris ranking.

Counterpart of ``rgbd_visualodometry_tpu/ops/fast.py``.  The NMS'd FAST
score map comes from kernel K1 (``csrc/fast_nms.cu``, every level of a
pyramid in one launch: :func:`fast_nms_pyramid`) for CUDA tensors and from
:func:`fast_nms_reference`, its plain torch version, for CPU tensors.
The kernel takes the pyramids of S streams at once
(:func:`fast_nms_streams`, a custom op that ``torch.func.vmap`` batches
into one launch).  Both compute ``where(s >= maxpool3x3(s), s, 0)`` with ``s = fast_score``
over the edge-padded image and a -inf padded NMS window - the function the
reference's main path computes in XLA (``fast.py:113-117``) and its Pallas
kernel ``pallas_fast._fast_nms_kernel`` fuses.  Only subtraction, min and
max are involved, so the two agree bit for bit.
"""

from __future__ import annotations

import ctypes
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


MAX_LEVELS_PER_LAUNCH = 8  # kMaxLevels of csrc/fast_nms.cu


@torch.library.custom_op("rgbdvo::fast_nms_streams", mutates_args=())
def fast_nms_streams(levels: list[torch.Tensor]) -> torch.Tensor:
    """The NMS'd FAST-9 score maps of S streams' pyramids in one flat
    tensor: ``levels`` are float32 ``[S, H_l, W_l]`` on one device, the
    result ``[S, sum_l H_l W_l]`` holds each stream's levels in order.  On
    CUDA one launch of kernel K1 per 8 levels for all streams, on the CPU
    the plain version per stream and level.  Under ``torch.func.vmap`` the
    vmapped axis joins the stream axis: still one launch."""
    raise ValueError(f"fast_nms: no kernel for device {levels[0].device}")


@fast_nms_streams.register_kernel("cpu")
def _fast_nms_streams_plain(levels):
    return torch.cat([torch.stack([fast_nms_reference(g) for g in lvl]).reshape(lvl.shape[0], -1)
                      for lvl in levels], dim=1)


@fast_nms_streams.register_kernel("cuda")
def _fast_nms_streams_kernel(levels):
    S = levels[0].shape[0]
    total = sum(g.shape[1] * g.shape[2] for g in levels)
    out = torch.empty((S, total), dtype=torch.float32, device=levels[0].device)
    if S == 0:
        return out
    levels = [g.contiguous() for g in levels]
    rows, off = [], 0
    for g in levels:  # (input, output, h, w, input and output stream strides)
        h, w = g.shape[1:]
        rows.append((g.data_ptr(), out.data_ptr() + 4 * off, h, w, h * w, total))
        off += h * w
    for i in range(0, len(rows), MAX_LEVELS_PER_LAUNCH):
        chunk = rows[i : i + MAX_LEVELS_PER_LAUNCH]
        table = (ctypes.c_int64 * (6 * len(chunk)))(*[v for row in chunk for v in row])
        kernels.FAST_NMS.launch(ctypes.addressof(table), len(chunk), S)
    return out


@fast_nms_streams.register_fake
def _fast_nms_streams_shape(levels):
    return levels[0].new_empty((levels[0].shape[0], sum(g.shape[1] * g.shape[2] for g in levels)))


@fast_nms_streams.register_vmap
def _fast_nms_streams_vmap(info, in_dims, levels):
    out = fast_nms_streams([kernels.fold_streams(g, d, info.batch_size) for g, d in zip(levels, in_dims[0])])
    return out.reshape(info.batch_size, -1, out.shape[-1]), 0


def fast_nms_pyramid(levels) -> list[torch.Tensor]:
    """NMS'd FAST-9 score maps of a list of float32 ``[H, W]`` images on one
    device (:func:`fast_nms_streams` with one stream): on CUDA one launch of
    kernel K1 per 8 levels, whose outputs are views of one flat buffer; on
    the CPU the plain version per level."""
    levels = list(levels)
    for g in levels:
        if g.dim() != 2 or g.dtype != torch.float32 or g.numel() == 0:
            raise ValueError(f"fast_nms takes non-empty float32 [H, W] images, got {g.dtype} {tuple(g.shape)}")
    devices = {g.device for g in levels}
    if len(devices) > 1:
        raise ValueError(f"fast_nms_pyramid: levels on several devices {devices}")
    if not levels:
        return []
    if devices.pop().type not in ("cpu", "cuda"):
        raise ValueError(f"fast_nms: no kernel for device {levels[0].device}")
    flat = fast_nms_streams([g[None] for g in levels])[0]
    return [o.view(g.shape) for o, g in zip(torch.split(flat, [g.numel() for g in levels]), levels)]


def fast_nms(gray: torch.Tensor) -> torch.Tensor:
    """NMS'd FAST-9 score map ``[H, W]`` float32 of one image: kernel K1
    with a one-level table on CUDA, the plain version on the CPU."""
    return fast_nms_pyramid([gray])[0]


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


def detect_level(gray: torch.Tensor, threshold: float, border: int, topk: int, nms=None):
    """Up to ``topk`` FAST corners of one level, Harris-ranked.  ``nms`` is
    the level's NMS'd score map if the caller computed it already (for all
    levels at once, :func:`fast_nms_pyramid`).  Returns ``(xy int64
    [topk, 2] as (x, y), response [topk], valid bool [topk])``."""
    if threshold < 0:
        raise ValueError("fast threshold must be >= 0")
    h, w = gray.shape
    # nms > threshold  <=>  score > threshold and score is the window max
    mask = (fast_nms(gray) if nms is None else nms) > threshold
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
