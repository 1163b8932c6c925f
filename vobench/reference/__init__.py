"""The plain reference the benchmark holds the program to.

A frozen copy of the port's tracking step, local BA and map state
(``camera``, ``config``, ``mapstate``, ``random``, ``ops/``,
``pipeline/frontend.py``, ``pipeline/backend.py``), with the plain
PyTorch versions of kernels K1 (FAST-9 + NMS) and K2 (nearest Hamming
keypoint) in place of the CUDA kernels, no ``torch.func.vmap`` batching over
streams and no CUDA graphs.  It imports torch and numpy only: nothing of
``rgbd_visualodometry_tpu_torch``, ``rgbd_visualodometry_tpu`` or jax.  A
later change to the program does not change it, so the benchmark keeps
judging against the algorithm as it stands here.
"""
