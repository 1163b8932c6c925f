"""Share of its roofline of the nearest-keypoint matcher's work
(``ops/matching.py`` ``nearest_keypoints_packed``): the bound computed
from the pool's and the keypoints' shapes for every stream, over the
device time of every kernel launched inside the call."""

from vobench import roofline


def _facts(args, kwargs):
    cand, kp = args[0], args[1]
    return {"rows": int(cand.shape[-2]), "keypoints": int(kp.shape[-2])}


SPANS = {"hamming_nn": ("rgbd_visualodometry_tpu_torch.ops.matching", "nearest_keypoints_packed", _facts)}


def read(run):
    t = run.trace
    calls = t.spans.get("hamming_nn", []) if t is not None else []
    device_s = sum(s.device_s for s in calls)
    if not calls or device_s <= 0:
        return None
    bound = sum(roofline.hamming_nn_bound_s(s.facts["rows"], s.facts["keypoints"], run.streams) for s in calls)
    return 100.0 * bound / device_s
