"""RANSAC PnP in the two pose rounds (``ops/pnp.py`` ``ransac_pnp``, which
``frontend._match_and_estimate`` calls through its module): stage time per
frame or step."""

from vobench.metrics import _stage

SPANS = {"pose_ransac": ("rgbd_visualodometry_tpu_torch.ops.pnp", "ransac_pnp")}


def read(run):
    return _stage.per_step_ms(run, "pose_ransac")
