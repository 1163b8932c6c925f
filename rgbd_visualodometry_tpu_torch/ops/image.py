"""Image operations for the ORB frontend: grayscale, pyramid, blur, Sobel,
box sums and the -inf padded 3x3 max filter.

Counterpart of ``rgbd_visualodometry_tpu/ops/image.py``.  Integer decisions
downstream (FAST thresholds, NMS ties, Harris ranks, BRIEF comparisons) are
only reproducible if these float32 images are bit-identical to the
reference's, so the arithmetic follows the reference's evaluation exactly:
the same operation order, and a fused multiply-add (:func:`fma`) at the
points where XLA contracts a product into the following add.

The pyramid resize is the exception: ``jax.image.resize`` antialiases when
it downscales, which the port reproduces with the same separable triangle
weights applied as two matrix products, but XLA's dot accumulation order
and its division are not reproduced bit for bit (agreement to ~1e-3 gray
levels; tests/test_torch_ops.py).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def fma(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` with one rounding.  The float64 product of two
    float32 values is exact, so this is a fused multiply-add."""
    if not torch.is_tensor(a):
        a = float(np.float32(a))
    else:
        a = a.double()
    return (a * b.double() + c.double()).float()


def rgb_to_gray(rgb: torch.Tensor) -> torch.Tensor:
    """uint8 RGB ``[H, W, 3]`` -> float32 gray (BT.601 luma)."""
    rgb = rgb.float()
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    return fma(0.114, b, fma(0.299, r, float(np.float32(0.587)) * g))


def pyramid_shapes(height: int, width: int, nlevels: int, scale: float):
    shapes = []
    for lvl in range(nlevels):
        s = scale**lvl
        shapes.append((max(int(round(height / s)), 8), max(int(round(width / s)), 8)))
    return shapes


@functools.lru_cache(maxsize=64)
def _resize_weights(m: int, n: int) -> np.ndarray:
    """``[m, n]`` float32 antialiased triangle weights of
    ``jax.image.scale_and_translate`` for a resize from ``m`` to ``n``."""
    f32, f64 = np.float32, np.float64
    scale = n / m
    inv = f32(1.0 / scale)
    kernel_scale = f32(max(1.0 / scale, 1.0))
    r = f32(1.0 / f64(kernel_scale))
    sample = ((np.arange(n, dtype=f32) + f32(0.5)).astype(f64) * f64(inv) - 0.5).astype(f32)
    x = np.abs(np.abs(sample[None, :] - np.arange(m, dtype=f32)[:, None]) * r)
    w = np.maximum(f32(1) - x, f32(0)).astype(f32)
    total = np.zeros(n, f32)
    for s in range(0, m, 32):  # XLA reduces in windows of 32 rows
        part = np.zeros(n, f32)
        for i in range(s, min(s + 32, m)):
            part = part + w[i]
        total = total + part
    ok_total = np.abs(total) > f32(1000.0 * np.finfo(np.float32).eps)
    w = np.where(ok_total, w / np.where(total != 0, total, f32(1)), f32(0))
    in_range = (sample >= f32(-0.5)) & (sample <= f32(m - 0.5))
    return np.where(in_range[None, :], w, f32(0)).astype(f32)


_DEVICE_WEIGHTS: dict = {}


def _weights_on(m: int, n: int, device) -> torch.Tensor:
    key = (m, n, str(device))
    if key not in _DEVICE_WEIGHTS:
        _DEVICE_WEIGHTS[key] = torch.from_numpy(_resize_weights(m, n)).to(device)
    return _DEVICE_WEIGHTS[key]


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Antialiased bilinear resize ``[H, W] -> [out_h, out_w]``."""
    h, w = img.shape
    out = img
    if out_h != h:
        out = _weights_on(h, out_h, img.device).T @ out
    if out_w != w:
        out = out @ _weights_on(w, out_w, img.device)
    return out


def build_pyramid(gray: torch.Tensor, nlevels: int, scale: float):
    h, w = gray.shape
    levels = [gray]
    for lh, lw in pyramid_shapes(h, w, nlevels, scale)[1:]:
        levels.append(resize_bilinear(levels[-1], lh, lw))
    return levels


def _gaussian_kernel1d(ksize: int, sigma: float) -> np.ndarray:
    r = (ksize - 1) / 2
    x = np.arange(ksize) - r
    k = np.exp(-(x**2) / (2 * sigma**2))
    return (k / k.sum()).astype(np.float32)


def _weighted_sum(k: np.ndarray, planes) -> torch.Tensor:
    acc = fma(k[0], planes[0], float(k[1]) * planes[1])
    for i in range(2, len(planes)):
        acc = fma(k[i], planes[i], acc)
    return acc


def edge_pad(img: torch.Tensor, top: int, bottom: int, left: int, right: int) -> torch.Tensor:
    """``jnp.pad(img, ((top, bottom), (left, right)), mode="edge")`` for 2-D."""
    h, w = img.shape
    rows = torch.arange(-top, h + bottom, device=img.device).clamp(0, h - 1)
    cols = torch.arange(-left, w + right, device=img.device).clamp(0, w - 1)
    return img[rows][:, cols]


def gaussian_blur(img: torch.Tensor, ksize: int = 7, sigma: float = 2.0) -> torch.Tensor:
    """Separable Gaussian blur with edge padding (cv::ORB's 7x7, sigma 2)."""
    k = _gaussian_kernel1d(ksize, sigma)
    r = ksize // 2
    h, w = img.shape
    p = edge_pad(img, r, r, 0, 0)
    rows = _weighted_sum(k, [p[i : i + h] for i in range(ksize)])
    p = edge_pad(rows, 0, 0, r, r)
    return _weighted_sum(k, [p[:, i : i + w] for i in range(ksize)])


def sobel_gradients(img: torch.Tensor):
    p = edge_pad(img, 1, 1, 1, 1)
    h, w = img.shape

    def sh(dy, dx):
        return p[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]

    ix = (sh(-1, 1) + 2 * sh(0, 1) + sh(1, 1)) - (sh(-1, -1) + 2 * sh(0, -1) + sh(1, -1))
    iy = (sh(1, -1) + 2 * sh(1, 0) + sh(1, 1)) - (sh(-1, -1) + 2 * sh(-1, 0) + sh(-1, 1))
    return ix, iy


def box_sum_of_products(a: torch.Tensor, b: torch.Tensor, ksize: int) -> torch.Tensor:
    """``box_sum(a * b, ksize)`` of the reference (zero padded, separable,
    rows then columns).  XLA fuses the centre row's product into its add."""
    r = ksize // 2
    h, w = a.shape
    prod = torch.nn.functional.pad(a * b, (0, 0, r, r))
    rows = prod[0:h]
    for i in range(1, r):
        rows = rows + prod[i : i + h]
    rows = fma(a, b, rows)
    for i in range(r + 1, ksize):
        rows = rows + prod[i : i + h]
    p = torch.nn.functional.pad(rows, (r, r, 0, 0))
    out = p[:, 0:w]
    for i in range(1, ksize):
        out = out + p[:, i : i + w]
    return out


def maxpool3x3(img: torch.Tensor) -> torch.Tensor:
    """3x3 max filter, -inf padded (the reference's NMS window)."""
    h, w = img.shape
    p = torch.nn.functional.pad(img, (1, 1, 1, 1), value=float("-inf"))
    out = img
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            out = torch.maximum(out, p[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w])
    return out


def level_scales(nlevels: int, scale: float):
    return [scale**lvl for lvl in range(nlevels)]


def features_per_level(nfeatures: int, nlevels: int, scale: float):
    f = 1.0 / scale
    ndesired = nfeatures * (1 - f) / (1 - f**nlevels)
    counts = []
    total = 0
    for lvl in range(nlevels - 1):
        c = int(round(ndesired * f**lvl))
        counts.append(c)
        total += c
    counts.append(max(nfeatures - total, 0))
    return counts
