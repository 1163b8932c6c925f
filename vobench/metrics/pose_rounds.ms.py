"""The two pose rounds (``pipeline/frontend.py`` ``_match_and_estimate``: the
gate, the compaction, RANSAC PnP and LM): stage time per frame or step."""

from vobench.metrics import _stage

SPANS = {"pose_rounds": ("rgbd_visualodometry_tpu_torch.pipeline.frontend", "_match_and_estimate")}


def read(run):
    return _stage.per_step_ms(run, "pose_rounds")
