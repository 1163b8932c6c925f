"""Lane-parallel RANSAC pose estimation for RGB-D 3D-2D correspondences.

Counterpart of ``rgbd_visualodometry_tpu/ops/pnp.py`` (the replacement of
``cv::solvePnPRansac`` at ``src/frontend.cpp:233-242``): lane 0 is the seed
pose, depth lanes solve Horn's Kabsch on 3 depth-valid samples, depth-free
lanes run a 6-step damped Gauss-Newton on 3 matched samples, and the lane
with the most 2-D inliers (first of ties) wins.  The samples are drawn with
the port's threefry ``split``/``uniform``, so both packages draw the same
hypotheses from the same key.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rgbd_visualodometry_tpu_torch import camera as cam_mod
from rgbd_visualodometry_tpu_torch import random as vo_random
from rgbd_visualodometry_tpu_torch.ops import se3
from rgbd_visualodometry_tpu_torch.ops.packing import top_k
from rgbd_visualodometry_tpu_torch.ops.smalleig import cholesky_solve, kabsch_quat
from rgbd_visualodometry_tpu_torch.utils.profiling import spanned


class RansacResult(NamedTuple):
    pose: torch.Tensor  # [7]
    inliers: torch.Tensor  # [M] bool
    num_inliers: torch.Tensor  # scalar int64


def _nan_to_num(x: torch.Tensor) -> torch.Tensor:
    big = torch.finfo(x.dtype).max
    return torch.nan_to_num(x, nan=0.0, posinf=big, neginf=-big)


def _gn_three_point(pose0, p3, uv3, camera, iterations: int = 6, damping: float = 1e-4):
    """Batched 3-point 2D-3D pose by damped Gauss-Newton from ``pose0``:
    ``p3 [L, 3, 3]``, ``uv3 [L, 3, 2]`` -> poses ``[L, 7]``."""
    from rgbd_visualodometry_tpu_torch.ops import lm

    eye = torch.eye(6, dtype=p3.dtype, device=p3.device)
    pose = pose0.expand(p3.shape[0], 7)
    for _ in range(iterations):
        e, p_c = lm.reprojection_residuals(pose[:, None, :], p3, uv3, camera)
        J = lm.pose_jacobian(p_c, camera)  # [L, 3, 2, 6]
        H = torch.einsum("lmki,lmkj->lij", J, J)
        g = torch.einsum("lmki,lmk->li", J, e)
        delta = -cholesky_solve(H + damping * eye, g)
        delta = delta.clamp(-0.5, 0.5)
        pose = se3.normalize(se3.compose(se3.exp(delta), pose))
    return pose


@spanned("vo.pose.ransac")
def ransac_pnp(key, p_world, uv, p_cam_depth, depth_ok, match_valid, seed_pose, camera,
               n_hypotheses: int = 128, threshold: float = 4.0,
               depth_free_fraction: float = 0.25) -> RansacResult:
    """RANSAC over ``n_hypotheses`` lanes plus the seed lane; ``p_world``,
    ``p_cam_depth`` ``[M, 3]``, ``uv [M, 2]``, masks ``[M]``."""
    m = p_world.shape[0]
    n_free = int(round(n_hypotheses * depth_free_fraction))
    n_depth = n_hypotheses - n_free
    sample_ok = match_valid & depth_ok
    minus_one = torch.tensor(-1.0, device=p_world.device)

    kd, kf = vo_random.split(key)
    noise = vo_random.uniform(kd, (n_depth, m))
    _, sample_idx = top_k(torch.where(sample_ok[None, :], noise, minus_one), 3)
    hyp = _nan_to_num(kabsch_quat(p_world[sample_idx], p_cam_depth[sample_idx]))
    parts = [seed_pose[None], hyp]
    if n_free:
        noise_f = vo_random.uniform(kf, (n_free, m))
        _, idx_f = top_k(torch.where(match_valid[None, :], noise_f, minus_one), 3)
        parts.append(_nan_to_num(_gn_three_point(seed_pose, p_world[idx_f], uv[idx_f], camera)))
    hyp = torch.cat(parts, dim=0)  # [H+1, 7]

    p_c = cam_mod.world2camera(p_world[None, :, :], hyp[:, None, :])
    proj = cam_mod.camera2pixel(camera, p_c)
    err2 = torch.sum((proj - uv[None, :, :]) ** 2, dim=-1)
    is_in = match_valid[None, :] & (p_c[..., 2] > 0) & (err2 < threshold * threshold)
    counts = torch.sum(is_in, dim=1)
    # first lane of the maximal count, like jnp.argmax
    lanes = torch.arange(counts.shape[0], device=counts.device)
    best = torch.min(torch.where(counts == counts.max(), lanes, torch.full_like(lanes, counts.shape[0])))
    return RansacResult(pose=se3.normalize(hyp[best]), inliers=is_in[best], num_inliers=counts[best])
