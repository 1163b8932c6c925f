"""Local BA (``pipeline/backend.py`` ``ba_step``, vmapped and masked under
``MultiStreamVO``): stage time per dispatch."""

from vobench.metrics import _stage

SPANS = {"ba": ("rgbd_visualodometry_tpu_torch.pipeline.backend", "ba_step")}


def read(run):
    return _stage.per_call_ms(run, "ba")
