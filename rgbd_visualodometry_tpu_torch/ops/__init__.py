"""Tensor operations of the tracking path (counterparts of ``rgbd_visualodometry_tpu/ops``)."""
