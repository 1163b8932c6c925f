"""PyTorch/CUDA port of rgbd_visualodometry_tpu's tracking path.

One RGB-D frame in, one camera pose out: ORB extraction, exact Hamming
matching, lane-parallel RANSAC with two-round pose LM, the fixed-capacity
map state, keyframe policy, relocalization and localization-only mode.  On
a CUDA device the FAST-9 + NMS score map (kernel K1) and the packed-Hamming
nearest-keypoint search (kernel K2) run as hand-written CUDA kernels built
at first use from ``csrc/``; everything else is plain torch.  The package
imports torch and numpy and never jax; the JAX package's pure-Python
configuration and synthetic-data modules are loaded by file path
(``_shared.py``).
"""

from rgbd_visualodometry_tpu_torch._shared import VOConfig, load_config
from rgbd_visualodometry_tpu_torch.pipeline.system import FrameResult, VisualOdometry

__all__ = ["VOConfig", "load_config", "VisualOdometry", "FrameResult"]
