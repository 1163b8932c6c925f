"""PyTorch/CUDA port of rgbd_visualodometry_tpu's single-stream VO.

One RGB-D frame in, one camera pose out: ORB extraction, exact Hamming
matching, lane-parallel RANSAC with two-round pose LM, the fixed-capacity
map state, keyframe policy, relocalization and localization-only mode,
local bundle adjustment after keyframes, and loop closure (pose-graph
relaxation of the keyframes, offline or every few keyframes online).  On a CUDA device the FAST-9 + NMS
score map (kernel K1), the packed-Hamming nearest-keypoint search (K2) and
the packed-Hamming distance matrix (K3) run as hand-written CUDA kernels
built at first use from ``csrc/``; everything else is plain torch.

Around the pipeline sit the user-facing surfaces: the ``rgbd-vo-torch``
command line (``cli.py``; ``python -m rgbd_visualodometry_tpu_torch``),
the TUM dataset reader (``io/tum.py``) with its PNG codec (``io/png.py``)
and the prefetching native loader (``native/``, built with g++ and libpng
where they exist), map checkpoints in the JAX package's format
(``io/checkpoint.py``), ATE/RPE and the eval command line (``evaltools/``),
stage timers and profiler traces (``utils/``) and the map viewer
(``viz/``).

The package imports torch and numpy, never jax, PyYAML or OpenCV, and no
file of the JAX package: the configuration and its YAML parser
(``config.py``) and every module above are its own copies.  matplotlib and
Pillow are imported only to render map views and plots.  Its entry points
run on the CUDA device unless the caller passes ``device="cpu"`` (the CLI:
``--cpu``).
"""

from rgbd_visualodometry_tpu_torch.config import VOConfig, load_config
from rgbd_visualodometry_tpu_torch.pipeline.system import FrameResult, VisualOdometry

__all__ = ["VOConfig", "load_config", "VisualOdometry", "FrameResult"]
