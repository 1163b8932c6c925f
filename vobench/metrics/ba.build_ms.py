"""Local BA's problem (``pipeline/backend.py`` ``build_problem``, once in each
``ba_step``: the window, its points and the incidence product): stage time
per dispatch."""

from vobench.metrics import _stage

SPANS = {"ba_build": ("rgbd_visualodometry_tpu_torch.pipeline.backend", "build_problem")}


def read(run):
    return _stage.per_call_ms(run, "ba_build")
