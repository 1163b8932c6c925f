"""Online loop closure's apply on the frame loop: the stage times of
``globalopt.apply_relaxation`` (the live map deformed) and of
``VisualOdometry._apply_relax_correction`` (the materialized poses moved
with their keyframes), per relaxation applied in the traced window."""

SPANS = {"relax_apply": ("rgbd_visualodometry_tpu_torch.pipeline.globalopt", "apply_relaxation"),
         "relax_correct": ("rgbd_visualodometry_tpu_torch.pipeline.system", "VisualOdometry._apply_relax_correction")}


def read(run):
    t = run.trace
    if t is None or not t.spans.get("relax_apply"):
        return None
    stage = sum(s.stage_s for s in t.spans["relax_apply"]) + sum(s.stage_s for s in t.spans.get("relax_correct", []))
    return 1e3 * stage / len(t.spans["relax_apply"])
