"""Motion-only bundle adjustment: Levenberg-Marquardt on SE(3).

Counterpart of ``rgbd_visualodometry_tpu/ops/lm.py`` (the g2o pose-only BA
of ``src/frontend.cpp:256-312``): analytic 2x6 Jacobian for the left update
``exp(delta) * T``, Huber IRLS weights, the two-round schedule (robust, drop
chi2 > 1, plain), lambda x0.33 on accept and x5 on reject, and the early exit
once an accepted step improves the cost by at most ``rtol`` relative.

The reference's ``while_loop`` stops at the first converged iteration.  The
port runs the fixed ``iterations`` count and freezes every quantity once
``done`` is set, which gives the same pose without a host synchronisation
per iteration.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rgbd_visualodometry_tpu_torch import camera as cam_mod
from rgbd_visualodometry_tpu_torch.ops import se3
from rgbd_visualodometry_tpu_torch.ops.smalleig import cholesky_solve
from rgbd_visualodometry_tpu_torch.utils.profiling import spanned


def reprojection_residuals(pose, pts_w, uv, camera):
    """``e = measured - projected`` and the camera-frame points."""
    p_c = se3.apply(pose, pts_w)
    return uv - cam_mod.camera2pixel(camera, p_c), p_c


def pose_jacobian(p_cam: torch.Tensor, camera) -> torch.Tensor:
    """``[M, 2, 6]`` d(error)/d(delta), translation columns first."""
    X, Y, Z = p_cam.unbind(-1)
    Zi = 1.0 / (Z + 1e-18)
    Zi2 = Zi * Zi
    fx, fy = camera.fx, camera.fy
    z = torch.zeros_like(X)
    row0 = torch.stack(
        [-fx * Zi, z, fx * X * Zi2, fx * X * Y * Zi2, -fx - fx * X * X * Zi2, fx * Y * Zi], dim=-1
    )
    row1 = torch.stack(
        [z, -fy * Zi, fy * Y * Zi2, fy + fy * Y * Y * Zi2, -fy * X * Y * Zi2, -fy * X * Zi], dim=-1
    )
    return torch.stack([row0, row1], dim=-2)


def _huber_weights(e_norm2: torch.Tensor, delta: float | None) -> torch.Tensor:
    if delta is None:
        return torch.ones_like(e_norm2)
    e_norm = torch.sqrt(torch.clamp_min(e_norm2, 1e-18))
    return torch.where(e_norm <= delta, torch.ones_like(e_norm), delta / e_norm)


def _robust_cost(e_norm2: torch.Tensor, delta: float | None) -> torch.Tensor:
    if delta is None:
        return e_norm2
    e_norm = torch.sqrt(torch.clamp_min(e_norm2, 1e-18))
    return torch.where(e_norm <= delta, e_norm2, 2.0 * delta * e_norm - delta * delta)


def lm_pose_round(pose0, pts_w, uv, mask, camera, iterations: int, huber_delta, rtol: float = 1e-6):
    """One LM round over the masked correspondences; returns the pose."""
    maskf = mask.to(pts_w.dtype)
    eye = torch.eye(6, dtype=pts_w.dtype, device=pts_w.device)

    def total_cost(pose):
        e, _ = reprojection_residuals(pose, pts_w, uv, camera)
        return torch.sum(maskf * _robust_cost(torch.sum(e * e, dim=-1), huber_delta))

    pose = pose0
    lam = torch.tensor(1e-3, dtype=pts_w.dtype, device=pts_w.device)
    cost = total_cost(pose0)
    done = torch.zeros((), dtype=torch.bool, device=pts_w.device)
    for _ in range(iterations):
        e, p_c = reprojection_residuals(pose, pts_w, uv, camera)
        J = pose_jacobian(p_c, camera)
        w = maskf * _huber_weights(torch.sum(e * e, dim=-1), huber_delta)
        H = torch.einsum("m,mki,mkj->ij", w, J, J)
        g = torch.einsum("m,mki,mk->i", w, J, e)
        delta = -cholesky_solve(H + lam * eye, g)
        cand = se3.normalize(se3.compose(se3.exp(delta), pose))
        new_cost = total_cost(cand)
        accept = new_cost < cost
        converged = accept & (cost - new_cost <= rtol * (cost + 1e-20))
        live = ~done
        pose = torch.where(live & accept, cand, pose)
        lam_next = torch.where(accept, lam * 0.33, lam * 5.0)
        cost = torch.where(live & accept, new_cost, cost)
        done = done | (live & (converged | (lam > 1e8)))
        lam = torch.where(live, lam_next, lam)
    return pose


class PoseRefineResult(NamedTuple):
    pose: torch.Tensor  # [7]
    inliers: torch.Tensor  # [M] bool: final chi2 <= threshold
    num_final_inliers: torch.Tensor  # scalar int64


@spanned("vo.pose.lm")
def refine_pose(pose0, pts_w, uv, inlier_mask, camera, iterations: int = 10,
                huber_delta: float = 7.815**0.5, chi2_outlier: float = 1.0) -> PoseRefineResult:
    """The reference's two-round schedule (``src/frontend.cpp:256-329``)."""
    pose1 = lm_pose_round(pose0, pts_w, uv, inlier_mask, camera, iterations, huber_delta)
    e1, _ = reprojection_residuals(pose1, pts_w, uv, camera)
    mask2 = inlier_mask & (torch.sum(e1 * e1, dim=-1) <= chi2_outlier)
    pose2 = lm_pose_round(pose1, pts_w, uv, mask2, camera, iterations, None)
    e2, _ = reprojection_residuals(pose2, pts_w, uv, camera)
    final = inlier_mask & (torch.sum(e2 * e2, dim=-1) <= chi2_outlier)
    return PoseRefineResult(pose=pose2, inliers=final, num_final_inliers=torch.sum(final))
