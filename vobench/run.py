"""Run one cell of the port's benchmark on the CUDA device and print its result.

    python3 vobench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The run renders its frames on the card from
``--seed``, builds the cell's port entry, warms it up, measures for
``--seconds``, and (``--trace 1``) profiles a few steps inside the window
for the per-layer metrics.  Then it holds what the window produced to the
plain reference (``vobench/check.py``) and prints, as the last line of
standard output, one JSON object with ``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, (``--trace 1``) ``breakdown``, and
last ``checks``: each compared number beside its limit, which also end
standard error.  It exits non-zero, printing no result, without a CUDA
device or with fewer than the cell asks for, and when the process holds a
module of jax, jaxlib, flax or the JAX package once the window has closed.

Build and kernel caches stay inside the checkout: the port builds its
kernels under ``rgbd_visualodometry_tpu_torch/_build/``, and
``TORCH_EXTENSIONS_DIR`` and ``TRITON_CACHE_DIR`` point under
``.vobench_cache/`` unless set.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ.setdefault(var, str(ROOT / ".vobench_cache" / sub))
os.environ.setdefault("USE_FLAX", "0")
# load from one process with few threads: the program is bound by its
# host launches, and idle pool threads only contend with them
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(var, "1")
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    torch.set_num_threads(1)
    from vobench import harness

    cell = harness.load_cell(args.workload)
    chips = cell.chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"vobench: the cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), device="cuda", t_process=T_PROCESS)
    banned = harness.banned_modules()
    if banned:
        print(f"vobench: the process holds {', '.join(banned)} after the window", file=sys.stderr)
        return 3
    print(f"vobench: process wall {time.perf_counter() - T_PROCESS:.1f} s", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
