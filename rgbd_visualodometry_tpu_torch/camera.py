"""Pinhole RGB-D camera model on torch tensors.

Counterpart of ``rgbd_visualodometry_tpu/camera.py``
(``include/myslam/camera.h:29-69``, ``src/camera.cpp:41-86``): the
world <-> camera <-> pixel transforms broadcast over leading batch
dimensions.  Intrinsics are float32 Python scalars rounded once, so every
product rounds exactly as the reference's float32 constants do.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from rgbd_visualodometry_tpu_torch.ops import se3


@dataclass(frozen=True)
class Camera:
    fx: float
    fy: float
    cx: float
    cy: float
    depth_scale: float
    width: int = 640
    height: int = 480

    @classmethod
    def from_config(cls, cfg) -> "Camera":
        f32 = lambda v: float(np.float32(v))  # noqa: E731
        return cls(
            fx=f32(cfg.camera_fx), fy=f32(cfg.camera_fy),
            cx=f32(cfg.camera_cx), cy=f32(cfg.camera_cy),
            depth_scale=f32(cfg.camera_depth_scale),
            width=cfg.image_width, height=cfg.image_height,
        )

    @property
    def matrix(self) -> torch.Tensor:
        """3x3 float32 intrinsics K (``camera.h:48-50``)."""
        return torch.tensor([[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]], dtype=torch.float32)


def world2camera(p_w: torch.Tensor, T_c_w: torch.Tensor) -> torch.Tensor:
    return se3.apply(T_c_w, p_w)


def camera2world(p_c: torch.Tensor, T_c_w: torch.Tensor) -> torch.Tensor:
    return se3.apply(se3.inverse(T_c_w), p_c)


def camera2pixel(cam: Camera, p_c: torch.Tensor) -> torch.Tensor:
    z = p_c[..., 2]
    zs = torch.where(torch.abs(z) < 1e-12, torch.full_like(z, 1e-12), z)
    u = cam.fx * p_c[..., 0] / zs + cam.cx
    v = cam.fy * p_c[..., 1] / zs + cam.cy
    return torch.stack([u, v], dim=-1)


def pixel2camera(cam: Camera, p_p: torch.Tensor, depth=1.0) -> torch.Tensor:
    x = (p_p[..., 0] - cam.cx) * depth / cam.fx
    y = (p_p[..., 1] - cam.cy) * depth / cam.fy
    z = depth if torch.is_tensor(depth) else torch.full_like(x, depth)
    return torch.stack([x, y, z.expand(x.shape)], dim=-1)


def world2pixel(cam: Camera, p_w: torch.Tensor, T_c_w: torch.Tensor) -> torch.Tensor:
    return camera2pixel(cam, world2camera(p_w, T_c_w))


def pixel2world(cam: Camera, p_p: torch.Tensor, T_c_w: torch.Tensor, depth=1.0) -> torch.Tensor:
    return camera2world(pixel2camera(cam, p_p, depth), T_c_w)


def camera_center(T_c_w: torch.Tensor) -> torch.Tensor:
    return se3.trans(se3.inverse(T_c_w))


def in_frustum(
    cam: Camera,
    p_w: torch.Tensor,
    T_c_w: torch.Tensor,
    mp_norm: torch.Tensor | None = None,
    max_angle: float = math.pi / 6,
) -> torch.Tensor:
    """Vectorized ``Frame::IsCouldObserveMappoint`` (``src/frame.cpp:70-91``)."""
    p_c = world2camera(p_w, T_c_w)
    in_front = p_c[..., 2] > 0
    uv = camera2pixel(cam, p_c)
    ok = (
        in_front
        & (uv[..., 0] >= 0) & (uv[..., 0] < cam.width)
        & (uv[..., 1] >= 0) & (uv[..., 1] < cam.height)
    )
    if mp_norm is not None:
        d = p_w - camera_center(T_c_w)
        d = d / torch.clamp_min(se3._norm(d, keepdim=True), 1e-12)
        cosang = torch.sum(d * mp_norm, dim=-1)
        ok = ok & (cosang > float(np.float32(math.cos(max_angle))))
    return ok
