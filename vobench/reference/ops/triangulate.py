"""Batched DLT triangulation with the sigma-ratio and baseline gates.

Counterpart of ``rgbd_visualodometry_tpu/ops/triangulate.py``
(``myslam::Triangulation``, ``include/myslam/util.h:16-34``): two DLT rows
per observation, the null vector from the smallest eigenvector of the 4x4
Gram matrix (Jacobi), ``sigma_4 / sigma_3 < ratio`` on squared values, a
rank-3 floor, at least ``min_obs`` observations and, if ``min_baseline`` >
0, a minimum span of the observing camera centres.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vobench.reference.ops import se3
from vobench.reference.ops.smalleig import jacobi_eigh_sym


class TriangulationResult(NamedTuple):
    points: torch.Tensor  # [B, 3]
    ok: torch.Tensor  # [B] bool


def triangulate(poses, norm_xy, obs_mask, sv_ratio: float = 1e-2, min_obs: int = 2,
                min_baseline: float = 0.0) -> TriangulationResult:
    """``poses [B, K, 7]`` (T_c_w), ``norm_xy [B, K, 2]``, ``obs_mask [B, K]``."""
    P = se3.to_matrix34(poses)  # [B, K, 3, 4]
    x = norm_xy[..., 0:1]
    y = norm_xy[..., 1:2]
    row0 = x * P[..., 2, :] - P[..., 0, :]
    row1 = y * P[..., 2, :] - P[..., 1, :]
    A = torch.cat([row0, row1], dim=-2)
    A = A * torch.cat([obs_mask, obs_mask], dim=-1)[..., None].to(A.dtype)
    G = torch.einsum("...ki,...kj->...ij", A, A)
    lam, V = jacobi_eigh_sym(G)
    v_last = V[..., :, 0]
    w = v_last[..., 3]
    pts = v_last[..., :3] / torch.where(torch.abs(w) < 1e-12, torch.full_like(w, 1e-12), w)[..., None]
    lam = torch.clamp_min(lam, 0.0)
    quality = (lam[..., 0] < sv_ratio**2 * lam[..., 1]) & (lam[..., 1] > 1e-4 * lam[..., 3])
    ok = quality & (torch.sum(obs_mask, dim=-1) >= min_obs)
    if min_baseline > 0.0:
        c = -torch.einsum("...ij,...i->...j", P[..., :3, :3], P[..., :3, 3])
        d2 = torch.sum((c[..., :, None, :] - c[..., None, :, :]) ** 2, dim=-1)
        pair_ok = obs_mask[..., :, None] & obs_mask[..., None, :]
        span2 = torch.amax(torch.where(pair_ok, d2, torch.zeros_like(d2)), dim=(-2, -1))
        ok = ok & (span2 >= min_baseline * min_baseline)
    return TriangulationResult(points=pts, ok=ok)
