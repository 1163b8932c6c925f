"""The map update (``pipeline/frontend.py`` ``apply_updates``: keyframe
insert, observations, new map points, triangulation): stage time per
frame or step."""

from vobench.metrics import _stage

SPANS = {"map_update": ("rgbd_visualodometry_tpu_torch.pipeline.frontend", "apply_updates")}


def read(run):
    return _stage.per_step_ms(run, "map_update")
