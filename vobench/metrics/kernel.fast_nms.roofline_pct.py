"""Share of its roofline of the FAST-9/NMS work (``ops/fast.py``
``fast_nms_pyramid``): the bound computed from the pyramid's shapes for
every stream, over the device time of every kernel launched inside the
call, whichever kernels those are."""

from vobench import roofline


def _facts(args, kwargs):
    levels = args[0] if args else kwargs["levels"]
    return {"pixels": sum(int(g.shape[-2]) * int(g.shape[-1]) for g in levels)}


SPANS = {"fast_nms": ("rgbd_visualodometry_tpu_torch.ops.fast", "fast_nms_pyramid", _facts)}


def read(run):
    t = run.trace
    calls = t.spans.get("fast_nms", []) if t is not None else []
    device_s = sum(s.device_s for s in calls)
    if not calls or device_s <= 0:
        return None
    bound = sum(roofline.fast_nms_bound_s(s.facts["pixels"] * run.streams) for s in calls)
    return 100.0 * bound / device_s
