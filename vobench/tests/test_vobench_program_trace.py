"""A traced run of the tiny cells on the CPU reports the stage metrics of the
pose rounds' and local BA's parts, and the benchmark's reduction of a trace
is unmoved by the program's own ``vo.*`` spans."""

import pytest

from vobench import harness, trace
from vobench.tests.tiny import tiny_copy

SEED = 2**31 + 977
POSE = {"pose_rounds.ransac_ms", "pose_rounds.lm_ms"}
BA = {"ba.build_ms", "ba.lm_ms"}
PROGRAM = {"vo.step", "vo.readback", "vo.orb", "vo.fast_nms", "vo.match", "vo.pose_round", "vo.pose.ransac",
           "vo.pose.lm", "vo.map_update", "vo.ba", "vo.ba.build", "vo.ba.lm"}


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """``{cell: (the result line's object, the traced window's profiler events)}``."""
    here = tiny_copy(tmp_path_factory.mktemp("vobench"))
    out = {}
    for cell in ("tiny_fleet", "tiny_single"):
        events = []
        reduce = trace.reduce

        def keep(evs, facts):
            events[:] = list(evs)
            return reduce(events, facts)

        trace.reduce = keep
        try:
            got = harness.run_cell(harness.load_cell(cell, here), SEED, 14.0, True, device="cpu")
        finally:
            trace.reduce = reduce
        out[cell] = (got, events)
    return out


@pytest.mark.parametrize("cell", ["tiny_fleet", "tiny_single"])
def test_the_parts_of_the_pose_rounds_and_of_ba_are_read(traced, cell):
    got, events = traced[cell]
    metrics = {k: v["value"] for k, v in got["metrics"].items()}
    dispatched = "ba.ms_per_dispatch" in metrics
    assert dispatched or cell == "tiny_single"  # the fleet's window waits for a dispatch
    assert set(metrics) >= (POSE | BA if dispatched else POSE)
    assert all(metrics[m] > 0 for m in POSE | (BA if dispatched else set()))
    # on the CPU a stage is its host time, and the parts lie inside the whole
    assert metrics["pose_rounds.ransac_ms"] + metrics["pose_rounds.lm_ms"] <= metrics["pose_rounds.ms"]
    if dispatched:
        assert metrics["ba.build_ms"] + metrics["ba.lm_ms"] <= metrics["ba.ms_per_dispatch"]
    names = {e.name() for e in events if e.name().startswith("vo.")}
    assert names == (PROGRAM if dispatched else PROGRAM - {"vo.ba", "vo.ba.build", "vo.ba.lm"})


@pytest.mark.parametrize("cell", ["tiny_fleet", "tiny_single"])
def test_reduce_is_the_same_without_the_program_spans(traced, cell):
    _, events = traced[cell]
    assert any(e.name().startswith("vo.") for e in events)
    kept = trace.reduce(events, {})
    stripped = trace.reduce([e for e in events if not e.name().startswith("vo.")], {})
    for field in ("steps", "busy_s", "window_s", "spans", "launch_calls", "kernel_counts"):
        assert getattr(kept, field) == getattr(stripped, field), field
    assert kept.breakdown["device_ops"] == stripped.breakdown["device_ops"]
    # a gap's label names the innermost host op at its midpoint, which can be
    # a program span: the benchmark's span and the gap's length are the same
    for (a, ta), (b, tb) in zip(kept.breakdown["idle_gaps"], stripped.breakdown["idle_gaps"]):
        assert ta == tb and a.split(":")[0] == b.split(":")[0]
        assert a == b or a.split(": ")[1].startswith("vo.")
