"""Shared utilities: stage timing and profiler traces.  The JAX package's
XLA compile cache (``utils/cache.py``) has no counterpart."""

from rgbd_visualodometry_tpu_torch.utils.profiling import StageTimer, torch_trace

__all__ = ["StageTimer", "torch_trace"]
