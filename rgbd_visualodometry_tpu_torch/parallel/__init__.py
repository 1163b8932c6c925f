"""Many streams on one device: ``MultiStreamVO``, the counterpart of
``rgbd_visualodometry_tpu.parallel`` without a device mesh."""

from rgbd_visualodometry_tpu_torch.parallel.mesh import MultiStreamVO

__all__ = ["MultiStreamVO"]
