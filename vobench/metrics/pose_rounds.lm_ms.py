"""The LM pose refinement in the two pose rounds (``ops/lm.py``
``refine_pose``, which ``frontend._match_and_estimate`` calls through its
module): stage time per frame or step."""

from vobench.metrics import _stage

SPANS = {"pose_lm": ("rgbd_visualodometry_tpu_torch.ops.lm", "refine_pose")}


def read(run):
    return _stage.per_step_ms(run, "pose_lm")
