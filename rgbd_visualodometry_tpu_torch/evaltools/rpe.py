"""Relative pose error over pose pairs - full contract of the reference's
``tools/evaluate_rpe.py``.

The port's own copy of ``rgbd_visualodometry_tpu/evaltools/rpe.py``
(``tests/test_torch_evaltools.py`` holds the two equal).

Semantics mirrored from ``evaluate_trajectory`` (``tools/evaluate_rpe.py:204-297``):

- **fixed-delta mode**: pairs ``(i, j)`` where ``j`` is the pose closest to
  ``index[i] + delta`` along the chosen delta unit; the pair is dropped when
  ``j`` is the last pose (reference quirk at ``evaluate_rpe.py:264``), and at
  most ``max_pairs`` pairs are randomly sampled.
- **random mode** (``fixed_delta=False``): all ``N^2`` pairs when small,
  otherwise ``max_pairs`` uniformly random pairs (``evaluate_rpe.py:256-260``).
- **delta units** (``evaluate_rpe.py:243-252``): ``"s"`` seconds, ``"m"``
  meters of cumulative translation along the estimated trajectory, ``"rad"``
  / ``"deg"`` cumulative rotation, ``"f"`` frames.
- ground truth is associated per estimated stamp to the closest ground-truth
  stamp, tolerance = 2x the median ground-truth interval
  (``evaluate_rpe.py:270-279``).
- the error motion is ``E = (scale(P_i^-1 P_j))^-1 (Q_i^-1 Q_j)`` with
  translational error ``||trans(E)||`` and rotational error ``angle(E)``
  (``evaluate_rpe.py:281-289``, ``ominus`` at ``:138-149``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


def _quat_to_matrix(q):
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def _pose_to_matrix(pose7):
    """(qw qx qy qz tx ty tz) -> 4x4 homogeneous matrix."""
    M = np.eye(4)
    M[:3, :3] = _quat_to_matrix(np.asarray(pose7[:4], np.float64))
    M[:3, 3] = pose7[4:7]
    return M


def _ominus(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Relative motion a^-1 b (evaluate_rpe.py:138-149)."""
    return np.linalg.inv(a) @ b


def _scale(a: np.ndarray, s: float) -> np.ndarray:
    out = a.copy()
    out[:3, 3] *= s
    return out


def _angle(E: np.ndarray) -> float:
    return float(np.arccos(np.clip((np.trace(E[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)))


def _find_closest_index(sorted_vals: np.ndarray, target: float) -> int:
    """Index of the entry closest to target (evaluate_rpe.py:121-136)."""
    i = int(np.searchsorted(sorted_vals, target))
    if i == 0:
        return 0
    if i >= len(sorted_vals):
        return len(sorted_vals) - 1
    return i if abs(sorted_vals[i] - target) < abs(sorted_vals[i - 1] - target) else i - 1


def _index_along(P: list[np.ndarray], ts: np.ndarray, unit: str) -> np.ndarray:
    """The pairing index per delta unit (evaluate_rpe.py:243-252)."""
    if unit == "s":
        return np.asarray(ts, np.float64)
    if unit == "f":
        return np.arange(len(P), dtype=np.float64)
    motions = [_ominus(P[i + 1], P[i]) for i in range(len(P) - 1)]
    if unit == "m":
        steps = [np.linalg.norm(m[:3, 3]) for m in motions]
    elif unit in ("rad", "deg"):
        k = 1.0 if unit == "rad" else 180.0 / np.pi
        steps = [_angle(m) * k for m in motions]
    else:
        raise ValueError(f"unknown delta unit {unit!r}")
    return np.concatenate([[0.0], np.cumsum(steps)])


class RPEResult(NamedTuple):
    trans_rmse: float
    trans_mean: float
    trans_median: float
    trans_std: float
    trans_min: float
    trans_max: float
    rot_rmse: float  # radians
    rot_mean: float
    rot_median: float
    rot_std: float
    rot_min: float
    rot_max: float
    num_pairs: int
    # per-pair data backing the reference's --save / --plot outputs
    # (``evaluate_rpe.py:347-360``); trailing fields with defaults so
    # stats-only callers are unaffected
    pair_stamps: np.ndarray | None = None  # [N, 4] est_i est_j gt_i gt_j
    trans_errors: np.ndarray | None = None  # [N] meters
    rot_errors: np.ndarray | None = None  # [N] radians


def relative_pose_error(
    est_ts: np.ndarray,
    est_poses: np.ndarray,  # [N, 7] T_w_c in (qw qx qy qz tx ty tz)
    gt_ts: np.ndarray,
    gt_poses: np.ndarray,
    delta: float = 1.0,
    delta_unit: str = "s",
    fixed_delta: bool = True,
    max_pairs: int = 10000,
    offset: float = 0.0,
    scale: float = 1.0,
    seed: int = 0,
) -> RPEResult:
    est_ts = np.asarray(est_ts, np.float64)
    gt_ts = np.asarray(gt_ts, np.float64)
    order_e = np.argsort(est_ts)
    order_g = np.argsort(gt_ts)
    est_ts = est_ts[order_e]
    gt_ts = gt_ts[order_g]
    P = [_pose_to_matrix(p) for p in np.asarray(est_poses)[order_e]]
    Q = [_pose_to_matrix(p) for p in np.asarray(gt_poses)[order_g]]
    n = len(P)
    if n < 2 or len(Q) < 2:
        raise ValueError("trajectories too short")

    rng = np.random.default_rng(seed)
    if fixed_delta:
        index = _index_along(P, est_ts, delta_unit)
        pairs = []
        for i in range(n):
            j = _find_closest_index(index, index[i] + delta)
            if j != n - 1:  # reference quirk: drops pairs hitting the last pose
                pairs.append((i, j))
        if max_pairs and len(pairs) > max_pairs:
            sel = rng.choice(len(pairs), max_pairs, replace=False)
            pairs = [pairs[k] for k in sel]
    else:
        if max_pairs == 0 or n < np.sqrt(max_pairs):
            pairs = [(i, j) for i in range(n) for j in range(n)]
        else:
            pairs = list(
                zip(rng.integers(0, n, max_pairs), rng.integers(0, n, max_pairs))
            )

    gt_interval = float(np.median(np.diff(gt_ts))) if len(gt_ts) > 1 else 0.02
    gt_max_dt = 2 * gt_interval

    trans_err, rot_err, stamps = [], [], []
    for i, j in pairs:
        gi = _find_closest_index(gt_ts, est_ts[i] + offset)
        gj = _find_closest_index(gt_ts, est_ts[j] + offset)
        if (
            abs(gt_ts[gi] - (est_ts[i] + offset)) > gt_max_dt
            or abs(gt_ts[gj] - (est_ts[j] + offset)) > gt_max_dt
        ):
            continue
        E = _ominus(_scale(_ominus(P[j], P[i]), scale), _ominus(Q[gj], Q[gi]))
        trans_err.append(np.linalg.norm(E[:3, 3]))
        rot_err.append(_angle(E))
        stamps.append((est_ts[i], est_ts[j], gt_ts[gi], gt_ts[gj]))
    if len(trans_err) < 2:
        raise ValueError(
            "couldn't find matching timestamp pairs between groundtruth and "
            "estimated trajectory"
        )
    t = np.asarray(trans_err)
    r = np.asarray(rot_err)
    return RPEResult(
        trans_rmse=float(np.sqrt(np.mean(t**2))),
        trans_mean=float(np.mean(t)),
        trans_median=float(np.median(t)),
        trans_std=float(np.std(t)),
        trans_min=float(np.min(t)),
        trans_max=float(np.max(t)),
        rot_rmse=float(np.sqrt(np.mean(r**2))),
        rot_mean=float(np.mean(r)),
        rot_median=float(np.median(r)),
        rot_std=float(np.std(r)),
        rot_min=float(np.min(r)),
        rot_max=float(np.max(r)),
        num_pairs=len(t),
        pair_stamps=np.asarray(stamps, np.float64),
        trans_errors=t,
        rot_errors=r,
    )
