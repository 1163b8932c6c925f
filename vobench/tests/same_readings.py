"""Do two copies of the benchmark read the same on the tiny cells?

    python3 vobench/tests/same_readings.py OTHER [--seed N] [--seconds S]

``OTHER`` is another checkout (its ``BENCHMARK.json`` and ``vobench/``, for
instance an older commit unpacked by ``git archive``); where it holds no
port, both sides run this checkout's.  The script runs
``tiny_single`` and ``tiny_fleet`` (``tiny.py``) on the CPU, untraced, once
with each checkout's own harness, in a process of its own, on the same
seed, and prints the check's readings side by side.  It exits 1 where a
reading, ``correct`` or a sample count differs.  The fleet's
``pose_gap_um`` and ``rot_gap_urad`` are printed only: which of its steps is
sampled follows the CPU's pace, so they move from run to run on either
side.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile

HERE = pathlib.Path(__file__).resolve().parents[2]
CELLS = ("tiny_single", "tiny_fleet")
PACE = {"tiny_fleet": ("pose_gap_um", "rot_gap_urad")}

RUN = """
import json, pathlib, sys
sys.path.insert(0, {root!r})
sys.path.append({here!r})  # the port, where the other checkout holds none
from vobench import harness
from vobench.tests.tiny import tiny_copy
assert harness.__file__.startswith({root!r})
here = tiny_copy(pathlib.Path({tmp!r}))
out = {{}}
for cell in {cells!r}:
    r = harness.run_cell(harness.load_cell(cell, here), {seed}, {seconds}, False, device="cpu")
    out[cell] = dict(correct=r["correct"], readings=r["readings"],
                     samples=r["checks"]["samples"]["value"], ba_samples=r["checks"]["ba_samples"]["value"])
print(json.dumps(out))
"""


def readings(root: pathlib.Path, seed: int, seconds: float) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        code = RUN.format(root=str(root), here=str(HERE), tmp=tmp, cells=CELLS, seed=seed, seconds=seconds)
        p = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                           env={**os.environ, "JAX_PLATFORMS": "cpu"})
    if p.returncode:
        raise SystemExit(f"{root}: exit {p.returncode}\n{p.stderr[-4000:]}")
    return json.loads(p.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", type=pathlib.Path)
    ap.add_argument("--seed", type=int, default=2**31 + 977)
    ap.add_argument("--seconds", type=float, default=4.0)
    a = ap.parse_args()
    mine, theirs = readings(HERE, a.seed, a.seconds), readings(a.other.resolve(), a.seed, a.seconds)
    differ = 0
    for cell in CELLS:
        x, y = mine[cell], theirs[cell]
        for key in ("correct", "samples", "ba_samples"):
            same = x[key] == y[key]
            differ += not same
            print(f"{cell} {key}: {x[key]} | {y[key]}{'' if same else '  DIFFERS'}")
        for key in sorted(set(x["readings"]) | set(y["readings"])):
            u, v = x["readings"].get(key), y["readings"].get(key)
            pace = key in PACE.get(cell, ())
            same = u == v or pace
            differ += not same
            print(f"{cell} {key}: {u} | {v}{'  (pace, not compared)' if pace else '' if same else '  DIFFERS'}")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
