"""ORB extraction: pyramid -> FAST-9 + NMS -> Harris top-K -> intensity
centroid angle -> steered BRIEF with quantized rotation.

Counterpart of ``rgbd_visualodometry_tpu/ops/orb.py::extract``.  The
reference's per-level quotas, border rule, BRIEF pattern (regenerated from
the same seeded ``np.random.RandomState``), 120 rotation bins and ``qbin``
rounding are kept.  Its patch canvas with a one-hot column select and its
BRIEF difference-table matmul are TPU gather workarounds: the port samples
the blurred level directly at the bin-rotated integer offsets, which gives
the same bits (a test ``p0 < p1`` is the sign of the reference's
``p1 - p0`` column of the table).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from rgbd_visualodometry_tpu_torch.ops import fast
from rgbd_visualodometry_tpu_torch.ops import image as im
from rgbd_visualodometry_tpu_torch.utils.profiling import spanned

PATCH = 33
PATCH_R = PATCH // 2
ORIENT_R = 15
PATTERN_R = 13
N_BITS = 256


def _make_brief_pattern(n_bits: int = N_BITS, seed: int = 20240216) -> np.ndarray:
    """[n_bits, 2, 2] float32 (pair, point, (x, y)) offsets: N(0, (31/5)^2)
    draws rejection-clipped to a disc of radius PATTERN_R."""
    rng = np.random.RandomState(seed)
    pts = np.empty((n_bits * 2, 2), np.float32)
    count = 0
    while count < n_bits * 2:
        cand = rng.normal(0.0, 31.0 / 5.0, size=(n_bits * 4, 2))
        ok = np.linalg.norm(cand, axis=1) <= PATTERN_R
        cand = cand[ok]
        take = min(len(cand), n_bits * 2 - count)
        pts[count : count + take] = cand[:take]
        count += take
    return pts.reshape(n_bits, 2, 2).astype(np.float32)


BRIEF_PATTERN = _make_brief_pattern()

_dy, _dx = np.mgrid[-PATCH_R : PATCH_R + 1, -PATCH_R : PATCH_R + 1]
_CIRC_MASK = (_dy**2 + _dx**2 <= ORIENT_R**2).astype(np.float32)
_CX = (_dx * _CIRC_MASK).astype(np.float32)
_CY = (_dy * _CIRC_MASK).astype(np.float32)


@functools.lru_cache(maxsize=8)
def brief_offsets(angle_bins: int) -> np.ndarray:
    """``[angle_bins, 256, 2, 2]`` int64 (bin, test, point, (dx, dy)): the
    pattern rotated by ``2*pi*q/angle_bins``, rounded and clipped to the
    patch exactly as the reference's difference table
    (``orb.py:162-185``)."""
    px, py = BRIEF_PATTERN[..., 0], BRIEF_PATTERN[..., 1]
    out = np.zeros((angle_bins, N_BITS, 2, 2), np.int64)
    for q in range(angle_bins):
        th = 2.0 * np.pi * q / angle_bins
        c, s = np.cos(th), np.sin(th)
        out[q, ..., 0] = np.clip(np.round(c * px - s * py).astype(np.int64), -PATCH_R, PATCH_R)
        out[q, ..., 1] = np.clip(np.round(s * px + c * py).astype(np.int64), -PATCH_R, PATCH_R)
    return out


class ORBFeatures(NamedTuple):
    xy: torch.Tensor  # [N, 2] float32 level-0 pixel coords (x, y), 0 if invalid
    response: torch.Tensor  # [N] float32 Harris (-inf if invalid)
    angle: torch.Tensor  # [N] float32 radians
    octave: torch.Tensor  # [N] int64 pyramid level
    size: torch.Tensor  # [N] float32 patch diameter at level 0
    valid: torch.Tensor  # [N] bool
    desc: torch.Tensor  # [N, 8] int32: packed 256-bit descriptors (uint32 bits)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """``[K, 256]`` {0, 1} -> ``[K, 8]`` int32 words holding uint32 bit
    patterns (word-major, LSB first)."""
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    words = torch.sum(bits.to(torch.int64).reshape(-1, 8, 32) << shifts, dim=-1)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def unpack_bits(desc: torch.Tensor) -> torch.Tensor:
    """``[..., 8]`` packed words -> ``[..., 256]`` int64 {0, 1}."""
    shifts = torch.arange(32, dtype=torch.int64, device=desc.device)
    words = desc.to(torch.int64) & 0xFFFFFFFF
    return ((words[..., :, None] >> shifts) & 1).reshape(desc.shape[:-1] + (N_BITS,))


def _patch_index(xy: torch.Tensor, width: int) -> torch.Tensor:
    """Flat indices ``[K, PATCH*PATCH]`` of the PATCH x PATCH window whose
    top-left corner is ``(x, y)`` in an image of ``width`` columns."""
    d = torch.arange(PATCH, device=xy.device)
    rows = xy[:, 1:2, None] + d[None, :, None]
    cols = xy[:, 0:1, None] + d[None, None, :]
    return (rows * width + cols).reshape(xy.shape[0], -1)


_DEVICE_TABLES: dict = {}


def _table(name: str, device) -> torch.Tensor:
    """Constant tables, copied to each device once."""
    key = (name, str(device))
    if key not in _DEVICE_TABLES:
        if name == "centroid":
            arr = np.stack([_CX.reshape(-1), _CY.reshape(-1)], axis=1).astype(np.float64)
        else:
            arr = brief_offsets(int(name.split(":")[1]))
        _DEVICE_TABLES[key] = torch.from_numpy(arr).to(device)
    return _DEVICE_TABLES[key]


def _orientation(padded: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid angle of the raw patch around each keypoint.  The
    moments are summed in float64 - exact for these float32 products - and
    rounded once, so the result does not depend on the summation order."""
    patch = padded.reshape(-1)[_patch_index(xy, padded.shape[1])].double()
    m = (patch @ _table("centroid", patch.device)).float()
    return torch.atan2(m[:, 1], m[:, 0])


def _brief(blurred_padded: torch.Tensor, xy: torch.Tensor, qbin: torch.Tensor, angle_bins: int):
    """Steered BRIEF bits ``[K, 256]`` sampled from the edge-padded blurred
    level at the keypoint's bin-rotated offsets."""
    off = _table(f"brief:{angle_bins}", xy.device)[qbin]  # [K, 256, 2, 2]
    pw = blurred_padded.shape[1]
    ys = xy[:, None, None, 1] + PATCH_R + off[..., 1]
    xs = xy[:, None, None, 0] + PATCH_R + off[..., 0]
    vals = blurred_padded.reshape(-1)[ys * pw + xs]  # [K, 256, 2]
    return vals[..., 0] < vals[..., 1]


@spanned("vo.orb")
def extract(
    gray: torch.Tensor,
    nfeatures: int = 500,
    nlevels: int = 8,
    scale: float = 1.2,
    threshold: float = 20.0,
    border: int = 31,
    angle_bins: int = 120,
) -> ORBFeatures:
    """ORB on a float32 gray image ``[H, W]``: exactly ``nfeatures`` slots
    with a validity mask (``orb_->detectAndCompute``,
    ``src/frontend.cpp:150-154``)."""
    pyr = im.build_pyramid(gray, nlevels, scale)
    quotas = im.features_per_level(nfeatures, nlevels, scale)
    scales = im.level_scales(nlevels, scale)
    dev = gray.device
    used = [lvl for lvl, quota in enumerate(quotas) if quota > 0]
    nms = dict(zip(used, fast.fast_nms_pyramid([pyr[lvl] for lvl in used])))  # K1: one launch
    parts = []
    for lvl, (img, quota, sc) in enumerate(zip(pyr, quotas, scales)):
        if quota == 0:
            continue
        h, w = img.shape
        b = min(border, max((min(h, w) - 2 * PATCH_R - 2) // 2, PATCH_R + 1))
        xy, resp, valid = fast.detect_level(img, threshold, b, quota, nms=nms[lvl])
        angle = _orientation(im.edge_pad(img, PATCH_R, PATCH_R, PATCH_R, PATCH_R), xy)
        per_rad = torch.tensor(angle_bins / (2.0 * np.pi), dtype=torch.float32, device=dev)
        qbin = torch.floor(im.fma(angle, per_rad, torch.full_like(angle, 0.5))).long() % angle_bins
        blurred = im.edge_pad(im.gaussian_blur(img, 7, 2.0), PATCH_R, PATCH_R, PATCH_R, PATCH_R)
        bits = _brief(blurred, xy, qbin, angle_bins)
        sc32 = float(np.float32(sc))
        parts.append(dict(
            xy=xy.float() * sc32, response=resp, angle=angle,
            octave=torch.full((quota,), lvl, dtype=torch.int64, device=dev),
            size=torch.full((quota,), float(np.float32(31.0 * sc)), device=dev),
            valid=valid, bits=bits,
        ))
    cat = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
    v = cat["valid"]
    return ORBFeatures(
        xy=torch.where(v[:, None], cat["xy"], torch.zeros_like(cat["xy"])),
        response=torch.where(v, cat["response"], torch.full_like(cat["response"], float("-inf"))),
        angle=cat["angle"],
        octave=cat["octave"],
        size=cat["size"],
        valid=v,
        desc=pack_bits(cat["bits"]),
    )
