"""Host-side visualization (replaces the reference's Pangolin/OpenGL render
thread, ``src/viewer.cpp`` - out of the device hot path by design)."""

from rgbd_visualodometry_tpu_torch.viz.viewer import MapViewer

__all__ = ["MapViewer"]
