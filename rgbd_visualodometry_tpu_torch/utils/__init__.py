"""Shared utilities: the program's trace spans and profiler traces.  The
JAX package's XLA compile cache (``utils/cache.py``) has no counterpart."""

from rgbd_visualodometry_tpu_torch.utils.profiling import span, spanned, torch_trace

__all__ = ["span", "spanned", "torch_trace"]
