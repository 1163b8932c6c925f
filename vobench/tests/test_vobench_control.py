"""The control on the card: the reference in TF32, put in the program's
place on the states and frames a short window samples, fails the cell's
limits on three seeds, while the program passes them.  Needs a CUDA device:
``python3 -m pytest vobench/tests/test_vobench_control.py -m gpu -q``."""

import json
import pathlib

import pytest
import torch

from vobench import check, harness

CELLS = [w["name"] for w in json.loads((pathlib.Path(__file__).resolve().parents[2] / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control's TF32 exists only on the card")
    c = harness.load_cell(cell)
    # a window that holds a BA dispatch (one every 15 steps of ~0.85 s at 8
    # streams) and a relaxation (one every ~40 frames)
    seconds = 40.0 if c.config["settings"].get("relax_every_kf") else 20.0
    for seed in (2**31 + 101, 2**31 + 202, 2**31 + 303):
        r = harness.run_cell(c, seed, seconds, False, device="cuda", control=True)
        assert r["correct"], r["checks"]
        ctl = dict(r["control"], init_off=0, carry_off=0, ba_schedule_off=0)
        ok, shown = check.verdict(ctl, c.limits, False, r["checks"]["samples"]["value"], 0)
        assert not ok, shown
