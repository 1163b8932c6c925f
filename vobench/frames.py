"""Frames rendered on the device from the seed, and the ring they replay from.

The ray-casting model is a copy of the port's ``io/synthetic.py``
(``SyntheticScene.render`` with its defaults: the textured plane
``z = 2.5`` m, cells of 6 cm, no boxes, no sensor noise), written in PyTorch
so that the frames are made on the card in a few large calls.  Depth is the
camera-frame z in uint16 units at ``depth_scale`` 5000 per metre, kept as
the int32 that ``FrameInput`` holds.

Stream ``s`` of ``S`` sees a texture drawn from a generator seeded with
``(seed, s)`` and a sweep that starts at phase ``s * period / S``: every
seed gives each stream a scene of its own, over the same trajectories.  The
camera sweeps back and forth over the plane (:func:`sweep_poses`): every
pose component is a sinusoid of the frame index with period ``period``,
whose peak step per frame is the traffic's ``peak_step_m`` and
``peak_yaw_rad``; the phases keep the streams' keyframes out of lockstep.
One period of frames is rendered per stream during set-up (:class:`Ring`);
the run replays it for as long as it lasts, with timestamps that keep
rising at ``fps``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

TEXTURE_CELLS = 1024  # SyntheticScene's texture_cells
PLANE_Z = 2.5  # m
CELL_SIZE = 0.06  # m


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit generator seed for ``(seed, stream)``."""
    words = np.random.SeedSequence([int(seed) & 0xFFFFFFFFFFFFFFFF, int(stream)]).generate_state(2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


def texture(seed: int, stream: int, device) -> torch.Tensor:
    """Stream ``stream``'s ``[1024, 1024, 3]`` uint8 blocky texture in
    [20, 236), as the scene's."""
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, stream))
    return torch.randint(20, 236, (TEXTURE_CELLS, TEXTURE_CELLS, 3), generator=g, device=device, dtype=torch.uint8)


def _quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate ``v [..., 3]`` by unit quaternions ``q [..., 4]`` (w, x, y, z)."""
    w, qv = q[..., :1], q[..., 1:4]
    t = 2.0 * torch.cross(qv.expand_as(v), v, dim=-1)
    return v + w * t + torch.cross(qv.expand_as(v), t, dim=-1)


def sweep_poses(frames: np.ndarray, period: int, peak_step_m, peak_yaw_rad: float, phase: float) -> np.ndarray:
    """``T_c_w [n, 7]`` (qw qx qy qz tx ty tz, float64) at frame indices
    ``frames``: translation ``A sin(theta)`` and yaw ``B sin(theta)`` with
    ``theta = 2 pi (i + phase) / period``, the amplitudes set so that the
    peak step per frame is ``peak_step_m`` and ``peak_yaw_rad``."""
    k = period / (2.0 * math.pi)
    theta = 2.0 * math.pi * (np.asarray(frames, np.float64) + phase) / period
    s = np.sin(theta)
    yaw = peak_yaw_rad * k * s
    t = np.asarray(peak_step_m, np.float64)[None, :] * k * s[:, None]
    q = np.stack([np.cos(yaw / 2), np.zeros_like(yaw), np.zeros_like(yaw), np.sin(yaw / 2)], axis=1)
    return np.concatenate([q, t], axis=1)


def render(tex: torch.Tensor, T_c_w: torch.Tensor, camera: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """Render poses ``T_c_w [n, 7]`` (float64) of the plane textured with
    ``tex``: ``rgb [n, H, W, 3]`` uint8 and ``depth [n, H, W]`` int32, as
    ``SyntheticScene.render`` does with its defaults."""
    dev = tex.device
    H, W = camera["height"], camera["width"]
    fx, fy, cx, cy = camera["fx"], camera["fy"], camera["cx"], camera["cy"]
    v, u = torch.meshgrid(torch.arange(H, device=dev, dtype=torch.float64),
                          torch.arange(W, device=dev, dtype=torch.float64), indexing="ij")
    dirs = torch.stack([(u - cx) / fx, (v - cy) / fy, torch.ones_like(u)], dim=-1)  # [H, W, 3]
    T = T_c_w.to(dev, torch.float64)
    q_wc = T[:, :4] * torch.tensor([1.0, -1.0, -1.0, -1.0], device=dev, dtype=torch.float64)
    center = -_quat_rotate(q_wc, T[:, 4:7])  # [n, 3]
    d_w = _quat_rotate(q_wc[:, None, None, :], dirs[None].expand(T.shape[0], H, W, 3))
    dz = d_w[..., 2]
    dz = torch.where(dz.abs() < 1e-9, torch.full_like(dz, 1e-9), dz)
    t_plane = (PLANE_Z - center[:, 2, None, None]) / dz
    hit = t_plane > 0.05
    t = torch.where(hit, t_plane, torch.zeros_like(t_plane))
    p_w = center[:, None, None, :] + t[..., None] * d_w
    tu = p_w[..., 0] + 0.731 * p_w[..., 2]
    tv = p_w[..., 1] + 0.413 * p_w[..., 2]
    n_tex = tex.shape[0]
    ui = torch.remainder(torch.floor(tu / CELL_SIZE).to(torch.int64), n_tex)
    vi = torch.remainder(torch.floor(tv / CELL_SIZE).to(torch.int64), n_tex)
    rgb = tex[vi, ui]
    rgb = torch.where(hit[..., None], rgb, torch.zeros_like(rgb))
    depth = torch.where(hit, t * camera["depth_scale"], torch.zeros_like(t))
    depth = torch.clamp(torch.round(depth), 0, 65535).to(torch.int32)
    return rgb, depth


class Ring:
    """One period of frames per stream, on the device, replayed in order.

    ``rgb [P, S, H, W, 3]`` uint8, ``depth [P, S, H, W]`` int32, ``T_c_w
    [P, S, 7]`` float64 on the host (ground truth), ``stamps [n_max]``
    float32 on the device.  Frame ``i`` of the run is ring slot ``i % P``;
    its timestamp is ``i / fps``.
    """

    def __init__(self, seed: int, traffic: dict, camera: dict, device, max_frames: int = 1 << 20):
        S, P = int(traffic["streams"]), int(traffic["period"])
        self.streams, self.period, self.fps = S, P, float(traffic["fps"])
        H, W = camera["height"], camera["width"]
        self.rgb = torch.empty((P, S, H, W, 3), dtype=torch.uint8, device=device)
        self.depth = torch.empty((P, S, H, W), dtype=torch.int32, device=device)
        self.T_c_w = np.empty((P, S, 7), np.float64)
        for s in range(S):
            poses = sweep_poses(np.arange(P), P, traffic["peak_step_m"], traffic["peak_yaw_rad"], s * P / S)
            self.T_c_w[:, s] = poses
            tex = texture(seed, s, device)
            for a in range(0, P, 40):  # a few frames at a time: the ray casting is float64
                rgb, depth = render(tex, torch.from_numpy(poses[a:a + 40]), camera)
                self.rgb[a:a + 40, s] = rgb
                self.depth[a:a + 40, s] = depth
        self.stamps = (torch.arange(max_frames, dtype=torch.float64, device=device) / self.fps).to(torch.float32)

    def slot(self, i: int) -> int:
        return i % self.period

    def timestamp(self, i: int) -> float:
        """The float32 timestamp of frame ``i``, as the device holds it."""
        return float(np.float32(i / self.fps))

    def frame(self, i: int, batched: bool):
        """Frame ``i`` as ``(rgb, depth, timestamp)`` device views: every
        stream's ``[S, ...]`` (``batched``), or stream 0's."""
        j = self.slot(i)
        if batched:
            return self.rgb[j], self.depth[j], self.stamps[i].expand(self.streams)
        return self.rgb[j, 0], self.depth[j, 0], self.stamps[i]
