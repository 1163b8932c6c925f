"""TUM-format trajectory writing/reading.

The PyTorch port's own copy of ``rgbd_visualodometry_tpu/io/trajectory.py``,
identical in behaviour (``tests/test_torch_io.py`` holds the two
together).  It uses numpy only, so the port loads no file of
the JAX package.

Format contract from ``app/run_vo.cpp:19-25``: one line per tracked frame,

    timestamp tx ty tz qx qy qz qw

holding **T_w_c** (the written pose is ``frame->GetPose().inverse()``,
``run_vo.cpp:116``), with the quaternion in xyzw order.  Internally poses are
(qw qx qy qz tx ty tz) arrays; this module converts at the boundary.
"""

from __future__ import annotations

import numpy as np


def pose_to_tum_line(timestamp: float, pose_w_c: np.ndarray) -> str:
    q = np.asarray(pose_w_c[:4], dtype=np.float64)  # (w, x, y, z)
    t = np.asarray(pose_w_c[4:7], dtype=np.float64)
    return (
        f"{timestamp:.4f} {t[0]:.7f} {t[1]:.7f} {t[2]:.7f} "
        f"{q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}"
    )


class TrajectoryWriter:
    """Streaming writer mirroring run_vo's output file handling
    (``run_vo.cpp:67-70,116``)."""

    def __init__(self, path: str):
        import os

        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self.path = path
        self._f = open(path, "w", encoding="utf-8")
        self._write_header()

    def _write_header(self):
        self._f.write("# estimated trajectory \n")
        self._f.write("# timestamp tx ty tz qx qy qz qw\n")

    def write(self, timestamp: float, pose_w_c: np.ndarray):
        self._f.write(pose_to_tum_line(timestamp, pose_w_c) + "\n")

    def rewrite(self, entries):
        """Replace the file's contents with ``entries`` = [(ts, pose_w_c)].

        Used after an online loop-closure relaxation: poses streamed before
        the relax carry pre-relax values, so the whole file is re-emitted
        from the corrected in-memory results (the reference's live viewer
        analogously always shows current poses, ``src/viewer.cpp:34-54``).
        Subsequent :meth:`write` calls keep appending."""
        self._f.close()
        self._f = open(self.path, "w", encoding="utf-8")
        self._write_header()
        for ts, pose in entries:
            self.write(ts, pose)
        self._f.flush()

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def read_trajectory(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Read a TUM trajectory file -> (timestamps [N], poses_w_c [N, 7] in
    internal (qw qx qy qz tx ty tz) order)."""
    ts, poses = [], []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(v) for v in line.split()]
            t, tx, ty, tz, qx, qy, qz, qw = vals[:8]
            ts.append(t)
            poses.append([qw, qx, qy, qz, tx, ty, tz])
    return np.asarray(ts), np.asarray(poses)
