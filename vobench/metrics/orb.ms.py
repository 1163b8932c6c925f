"""ORB extraction (``ops/orb.py`` ``extract``: pyramid, FAST/NMS, Harris,
BRIEF): stage time per frame or step."""

from vobench.metrics import _stage

SPANS = {"orb": ("rgbd_visualodometry_tpu_torch.ops.orb", "extract")}


def read(run):
    return _stage.per_step_ms(run, "orb")
