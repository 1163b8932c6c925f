"""Absolute trajectory error with closed-form Horn alignment.

The port's own copy of ``rgbd_visualodometry_tpu/evaltools/ate.py``
(``tests/test_torch_evaltools.py`` holds the two equal), plus
:func:`ate_rmse`, the headline number alone.

Metric contract of the reference's ``tools/evaluate_ate.py``: associate
estimated and ground-truth trajectories by timestamp (0.02 s window), find
the rigid transform aligning the estimate to ground truth with Horn's
closed-form SVD method (``evaluate_ate.py:47-79``), then report statistics
of the per-pose translational residuals, headline number =
``RMSE = sqrt(mean(||aligned_est - gt||^2))`` (``evaluate_ate.py:155``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from rgbd_visualodometry_tpu_torch.io.tum import associate


def horn_align(model: np.ndarray, data: np.ndarray):
    """Closed-form rigid alignment: find (R, t) minimizing
    ``sum ||R @ model_i + t - data_i||^2`` (no scale, like the reference).

    model, data: [N, 3].  Returns (R [3,3], t [3], residuals [N]).
    """
    model = np.asarray(model, np.float64)
    data = np.asarray(data, np.float64)
    mu_m = model.mean(axis=0)
    mu_d = data.mean(axis=0)
    W = (data - mu_d).T @ (model - mu_m)
    U, _, Vt = np.linalg.svd(W)
    S = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    R = U @ S @ Vt
    t = mu_d - R @ mu_m
    aligned = model @ R.T + t
    residuals = np.linalg.norm(aligned - data, axis=1)
    return R, t, residuals


class ATEResult(NamedTuple):
    rmse: float
    mean: float
    median: float
    std: float
    min: float
    max: float
    num_pairs: int
    # per-pair data backing the reference's --save / --save_associations /
    # --plot outputs (``evaluate_ate.py:164-186``); trailing fields with
    # defaults so stats-only callers are unaffected
    est_stamps: np.ndarray | None = None  # [N] matched estimate timestamps
    gt_stamps: np.ndarray | None = None  # [N] matched ground-truth timestamps
    est_aligned: np.ndarray | None = None  # [N, 3] estimate after Horn align
    gt_matched: np.ndarray | None = None  # [N, 3] associated ground truth


def absolute_trajectory_error(
    est_ts: np.ndarray,
    est_xyz: np.ndarray,
    gt_ts: np.ndarray,
    gt_xyz: np.ndarray,
    max_difference: float = 0.02,
    offset: float = 0.0,
    scale: float = 1.0,
) -> ATEResult:
    """Associate by timestamp, align, report the reference's statistics set
    (``evaluate_ate.py:155-162``).  ``scale`` multiplies the estimated
    positions before alignment (``evaluate_ate.py:134``)."""
    # the reference adds the offset to the ESTIMATE's stamps
    # (evaluate_ate.py:120,132: associate(gt, est, offset)); our associate()
    # adds it to its second argument, so the sign flips here
    pairs = associate(est_ts, gt_ts, offset=-offset, max_difference=max_difference)
    if len(pairs) < 2:
        raise ValueError(
            f"only {len(pairs)} associated pose pairs - trajectories do not overlap"
        )
    ei = np.asarray([i for i, _ in pairs])
    gi = np.asarray([j for _, j in pairs])
    est_m = np.asarray(est_xyz, np.float64)[ei] * float(scale)
    gt_m = np.asarray(gt_xyz, np.float64)[gi]
    R, t, residuals = horn_align(est_m, gt_m)
    return ATEResult(
        rmse=float(np.sqrt(np.mean(residuals**2))),
        mean=float(np.mean(residuals)),
        median=float(np.median(residuals)),
        std=float(np.std(residuals)),
        min=float(np.min(residuals)),
        max=float(np.max(residuals)),
        num_pairs=len(pairs),
        est_stamps=np.asarray(est_ts, np.float64)[ei],
        gt_stamps=np.asarray(gt_ts, np.float64)[gi],
        est_aligned=est_m @ R.T + t,
        gt_matched=gt_m,
    )


def ate_rmse(est_ts, est_xyz, gt_ts, gt_xyz, max_difference: float = 0.02) -> float:
    """The RMSE (m) of :func:`absolute_trajectory_error`: the same greedy
    association and alignment."""
    return absolute_trajectory_error(est_ts, est_xyz, gt_ts, gt_xyz, max_difference=max_difference).rmse
