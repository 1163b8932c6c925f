"""Online loop closure's relaxation (``pipeline/globalopt.py``
``compute_relaxation``, on ``VisualOdometry.run``'s worker thread): the
stage time of its ``vobench.*`` span on that thread, from the call to the
later of its return and the end of the last device op it launched (on the
worker's own stream), per relaxation computed in the traced window.  The
traced window of a relaxing cell records every thread."""

SPANS = {"relax_compute": ("rgbd_visualodometry_tpu_torch.pipeline.globalopt", "compute_relaxation")}


def read(run):
    t = run.trace
    if t is None or not t.worker_spans.get("relax_compute"):
        return None
    got = t.worker_spans["relax_compute"]
    return 1e3 * sum(s.stage_s for s in got) / len(got)
