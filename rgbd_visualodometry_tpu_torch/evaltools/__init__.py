"""Offline evaluation: ATE (Horn alignment), RPE, trajectory tooling.

The port's own copy of ``rgbd_visualodometry_tpu/evaltools``: the metric
definitions of the reference's ``tools/evaluate_ate.py`` and
``tools/evaluate_rpe.py`` (the standard TUM benchmark tools).  Plotting
imports matplotlib and Pillow only when asked to plot."""

from rgbd_visualodometry_tpu_torch.evaltools.ate import absolute_trajectory_error, ate_rmse, horn_align
from rgbd_visualodometry_tpu_torch.evaltools.rpe import relative_pose_error

__all__ = ["absolute_trajectory_error", "ate_rmse", "horn_align", "relative_pose_error"]
