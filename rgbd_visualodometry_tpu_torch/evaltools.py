"""Absolute trajectory error against ground truth sampled at the same stamps.

The JAX package's ``evaltools.ate`` imports its ``io.tum`` module (and so
jax); this is the same statistic - Horn's closed-form rigid alignment, no
scale, then the RMSE of the residuals (``evaluate_ate.py:155-162``) - for
trajectories whose stamps are associated one to one.
"""

from __future__ import annotations

import numpy as np


def horn_align(model: np.ndarray, data: np.ndarray):
    """``(R, t, residuals)`` minimising ``sum ||R model_i + t - data_i||^2``."""
    model = np.asarray(model, np.float64)
    data = np.asarray(data, np.float64)
    mu_m, mu_d = model.mean(axis=0), data.mean(axis=0)
    U, _, Vt = np.linalg.svd((data - mu_d).T @ (model - mu_m))
    S = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    R = U @ S @ Vt
    t = mu_d - R @ mu_m
    return R, t, np.linalg.norm(model @ R.T + t - data, axis=1)


def ate_rmse(est_ts, est_xyz, gt_ts, gt_xyz, max_difference: float = 0.02) -> float:
    """RMSE (m) of the aligned estimate; each estimate stamp is paired with
    the nearest ground-truth stamp within ``max_difference`` seconds."""
    est_ts, gt_ts = np.asarray(est_ts, np.float64), np.asarray(gt_ts, np.float64)
    j = np.abs(est_ts[:, None] - gt_ts[None, :]).argmin(axis=1)
    ok = np.abs(gt_ts[j] - est_ts) <= max_difference
    if ok.sum() < 2:
        raise ValueError("fewer than 2 associated poses")
    _, _, res = horn_align(np.asarray(est_xyz)[ok], np.asarray(gt_xyz)[j[ok]])
    return float(np.sqrt(np.mean(res**2)))
