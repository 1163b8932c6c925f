"""PyTorch/CUDA port of rgbd_visualodometry_tpu's single-stream VO.

One RGB-D frame in, one camera pose out: ORB extraction, exact Hamming
matching, lane-parallel RANSAC with two-round pose LM, the fixed-capacity
map state, keyframe policy, relocalization and localization-only mode,
local bundle adjustment after keyframes, and loop closure (pose-graph
relaxation of the keyframes, offline or every few keyframes online).  On a CUDA device the FAST-9 + NMS
score map (kernel K1), the packed-Hamming nearest-keypoint search (K2) and
the packed-Hamming distance matrix (K3) run as hand-written CUDA kernels
built at first use from ``csrc/``; everything else is plain torch.  The
package imports torch, numpy and PyYAML, never jax and no file of the JAX
package: the configuration (``config.py``), the synthetic scenes
(``io/synthetic.py``) and the trajectory writer (``io/trajectory.py``) are
its own copies.  Its entry points run on the CUDA device unless the caller
passes ``device="cpu"``.
"""

from rgbd_visualodometry_tpu_torch.config import VOConfig, load_config
from rgbd_visualodometry_tpu_torch.pipeline.system import FrameResult, VisualOdometry

__all__ = ["VOConfig", "load_config", "VisualOdometry", "FrameResult"]
