"""Readings for the limits of ``correct``: the program's and the control's.

    python3 vobench/control.py --workload <cell> --seeds 1,2,3 --seconds 10 --out FILE [--fault NAME]

For each seed, one run of the cell at its own size and load (a short
window), in one process.  Each run's compared numbers are the program's
lower readings; the control, the reference computed in TF32 put in the
program's place on the same sampled states and frames, gives the upper
ones.  With ``--fault NAME`` (``vobench/faults.py``) the fault is planted
under the timed path first, and the program's readings are the fault's.
One JSON line per seed goes to ``--out``.  The benchmark's own runs do not
run the control.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--out", required=True)
    p.add_argument("--fault", default=None, help="a fault of vobench/faults.py to plant")
    args = p.parse_args(argv)

    import torch

    from vobench import faults, harness

    if not torch.cuda.is_available():
        print("vobench control: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    if args.fault:
        faults.FAULTS[args.fault]()
    with open(args.out, "a", encoding="utf-8") as f:
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            r = harness.run_cell(cell, seed, args.seconds, False, device="cuda", control=True)
            line = dict(workload=cell.name, seed=seed, fault=args.fault, correct=r["correct"], seconds=time.perf_counter() - t0, program=r["readings"],
                        control=r["control"], metrics=r["metrics"], device=r["device"])
            f.write(json.dumps(line) + "\n")
            f.flush()
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
