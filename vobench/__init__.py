"""The benchmark of the PyTorch and CUDA port (``rgbd_visualodometry_tpu_torch``).

``python3 vobench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` on the CUDA device and prints its
result line.  See ``vobench/run.py``.
"""
