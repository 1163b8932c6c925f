"""Depth lookup with the 4-neighbour fallback of ``Frame::GetDepth``
(``src/frame.cpp:43-67``); counterpart of ``rgbd_visualodometry_tpu/ops/depth.py``."""

from __future__ import annotations

from typing import NamedTuple

import torch


class DepthLookup(NamedTuple):
    depth: torch.Tensor  # [N] float32 meters (0 where invalid)
    valid: torch.Tensor  # [N] bool


# centre first, then the reference's probe order dx={-1,0,1,0}, dy={0,-1,0,1}
_PROBES = ((0, 0), (-1, 0), (0, -1), (1, 0), (0, 1))


def lookup_depth(depth_img: torch.Tensor, xy: torch.Tensor, depth_scale: float) -> DepthLookup:
    """``depth_img [H, W]`` raw uint16 depth (any integer dtype), ``xy [N, 2]``
    float keypoints -> metres and validity; coordinates are clamped."""
    h, w = depth_img.shape
    x = torch.round(xy[..., 0]).long().clamp(0, w - 1)
    y = torch.round(xy[..., 1]).long().clamp(0, h - 1)
    flat = depth_img.reshape(-1).to(torch.int32)
    raw = torch.zeros(xy.shape[:-1], dtype=torch.int32, device=xy.device)
    for dx, dy in _PROBES:
        probe = flat[(y + dy).clamp(0, h - 1) * w + (x + dx).clamp(0, w - 1)]
        raw = torch.where(raw != 0, raw, probe)
    valid = raw != 0
    meters = raw.float() / depth_scale
    return DepthLookup(depth=torch.where(valid, meters, torch.zeros_like(meters)), valid=valid)
