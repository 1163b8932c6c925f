"""Local BA's two LM rounds (``pipeline/backend.py`` ``_lm_phase``, twice in
each ``ba_step``): their stage time per dispatch."""

from vobench.metrics import _stage

SPANS = {"ba_lm": ("rgbd_visualodometry_tpu_torch.pipeline.backend", "_lm_phase")}
ROUNDS = 2  # _lm_phase calls a dispatch


def read(run):
    per_round = _stage.per_call_ms(run, "ba_lm")
    return None if per_round is None else ROUNDS * per_round
