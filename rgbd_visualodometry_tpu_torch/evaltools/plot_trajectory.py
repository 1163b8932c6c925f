"""Project a trajectory into the image sequence as RGB axes.

Equivalent of the reference's ``tools/plot_trajectory_into_image.py``: for
each frame, draw the world coordinate axes of every (earlier) camera pose
projected through the current camera - a quick visual sanity check of a
trajectory against the footage.

The port's own copy of ``rgbd_visualodometry_tpu/evaltools/
plot_trajectory.py``; Pillow, which writes the frames, is imported only
when they are written.
"""

from __future__ import annotations

import numpy as np

from rgbd_visualodometry_tpu_torch.io.tum import associate


def _quat_to_matrix(q):
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def draw_axes_into_image(
    rgb: np.ndarray,
    pose_w_c_current: np.ndarray,  # [7] current camera T_w_c
    poses_w_c: np.ndarray,  # [N, 7] poses whose axes to draw
    fx: float, fy: float, cx: float, cy: float,
    axis_length: float = 0.05,
) -> np.ndarray:
    """Returns a copy of ``rgb`` with RGB axis segments for each pose."""
    img = np.asarray(rgb).copy()
    h, w = img.shape[:2]
    # current camera: T_c_w = inverse of T_w_c
    R_wc = _quat_to_matrix(pose_w_c_current[:4])
    t_wc = pose_w_c_current[4:7]
    R_cw = R_wc.T
    t_cw = -R_cw @ t_wc

    colors = np.array([[255, 0, 0], [0, 255, 0], [0, 0, 255]], np.uint8)
    for pose in np.atleast_2d(poses_w_c):
        Rp = _quat_to_matrix(pose[:4])
        origin = pose[4:7]
        for axis in range(3):
            tip = origin + axis_length * Rp[:, axis]
            pts = []
            for p_w in (origin, tip):
                p_c = R_cw @ p_w + t_cw
                if p_c[2] <= 0.05:
                    break
                u = fx * p_c[0] / p_c[2] + cx
                v = fy * p_c[1] / p_c[2] + cy
                pts.append((u, v))
            if len(pts) == 2:
                _draw_segment(img, pts[0], pts[1], colors[axis])
    return img


def _draw_segment(img, a, b, color, steps: int = 32):
    h, w = img.shape[:2]
    for s in range(steps + 1):
        t = s / steps
        u = a[0] + t * (b[0] - a[0])
        v = a[1] + t * (b[1] - a[1])
        ui, vi = int(round(u)), int(round(v))
        if 0 <= ui < w and 0 <= vi < h:
            img[vi, ui] = color


def plot_trajectory_sequence(
    traj_ts: np.ndarray,
    traj_poses: np.ndarray,  # [N, 7] T_w_c (internal order)
    frame_iter,  # yields (timestamp, rgb)
    out_dir: str,
    fx: float, fy: float, cx: float, cy: float,
):
    """Render every frame with all past camera axes drawn in; mirrors the
    reference tool's main loop (one PNG per frame)."""
    import os

    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    frames = list(frame_iter)
    pairs = associate([t for t, _ in frames], traj_ts)
    written = []
    for fi, ti in pairs:
        ts, rgb = frames[fi]
        img = draw_axes_into_image(
            rgb, traj_poses[ti], traj_poses[: ti + 1], fx, fy, cx, cy
        )
        path = os.path.join(out_dir, f"traj_{fi:05d}.png")
        Image.fromarray(img).save(path)
        written.append(path)
    return written
