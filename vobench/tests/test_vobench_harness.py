"""The harness's control flow on the CPU at a tiny size (the port's plain
kernels), and the faults that must make ``correct`` false.  ``tiny_loop``
drives ``VisualOdometry.run`` with online loop closure every 2 keyframes."""

import pytest

from vobench import faults, harness
from vobench.tests.tiny import tiny_copy

SEED = 2**31 + 977  # past 32 bits


@pytest.fixture(scope="module")
def here(tmp_path_factory):
    return tiny_copy(tmp_path_factory.mktemp("vobench"))


def _run(here, cell, traced=False, seconds=None):
    # the loop cell's window holds a relaxation from its start to its apply
    seconds = seconds or (10.0 if cell == "tiny_loop" else 4.0)
    return harness.run_cell(harness.load_cell(cell, here), SEED, seconds, traced, device="cpu")


@pytest.mark.parametrize("cell", ["tiny_fleet", "tiny_single"])
def test_untraced_run(here, cell):
    r = _run(here, cell)
    assert r["correct"], r["checks"]
    assert set(r) >= {"correct", "attempted", "failed", "metrics", "device", "checks"}
    assert list(r)[-1] == "checks"
    assert set(r["metrics"]) == {"frames_per_s", "pose_latency_ms_p90", "setup_s"}
    assert r["attempted"] > 0 and r["failed"] == 0
    assert r["checks"]["samples"]["value"] >= 1 and r["checks"]["ba_samples"]["value"] >= 1
    assert all(v["value"] is not None for v in r["checks"].values())


@pytest.mark.parametrize("traced", [False, True])
def test_loop_run(here, traced):
    """Relaxations computed in the window are held to the reference, and a
    traced run reads both relax metrics."""
    r = _run(here, "tiny_loop", traced=traced, seconds=14.0 if traced else None)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["checks"]["relax_samples"]["value"] >= 1
    got = r["readings"]
    assert got["relax_acted"] >= 1 and got["relax_max_correction_um"] > 0
    assert {"relax_edges_off", "relax_kf_gap_um", "relax_map_off", "relax_map_gap_um", "relax_traj_gap_um"} <= set(got)
    if traced:
        assert r["metrics"]["relax.compute_ms"]["value"] > 0 and r["metrics"]["relax.apply_ms"]["value"] > 0
        # the entry span holds process_async alone, not the relaxation's wait
        assert r["metrics"]["host.enqueue_ms"]["value"] < r["metrics"]["relax.compute_ms"]["value"]
    else:
        assert set(r["metrics"]) == {"frames_per_s", "pose_latency_ms_p90", "setup_s"}


def test_traced_run(here):
    r = _run(here, "tiny_fleet", traced=True, seconds=14.0)
    assert r["correct"], r["checks"]
    # on the CPU no device op runs: the device readers find nothing to read
    assert {"host.enqueue_ms", "orb.ms", "pose_rounds.ms", "map_update.ms"} <= set(r["metrics"])
    assert not {"kernel.fast_nms.roofline_pct", "kernel.hamming_nn.roofline_pct", "device.idle_pct"} & set(r["metrics"])
    assert r["device"]["window_s"] > 0 and "breakdown" in r


@pytest.mark.parametrize("cell,fault,number", [
    ("tiny_fleet", "state_unchanged", None), ("tiny_single", "state_unchanged", None),
    ("tiny_fleet", "answer_altered", "pose_gap_um"), ("tiny_single", "answer_altered", "pose_gap_um"),
    ("tiny_fleet", "map_moved", "map_gap_um"), ("tiny_single", "map_moved", "map_gap_um"),
    ("tiny_fleet", "half_left_out", None),
    ("tiny_loop", "relax_altered", "relax_kf_gap_um"), ("tiny_loop", "relax_dropped", "relax_map_gap_um"),
    ("tiny_loop", "relax_uncorrected", "relax_traj_gap_um"),
])
def test_fault_is_not_correct(here, cell, fault, number):
    undo = faults.FAULTS[fault]()
    try:
        r = _run(here, cell)
    finally:
        undo()
    assert r["correct"] is False, r["checks"]
    if number is not None:
        c = r["checks"][number]
        assert c["value"] > c["limit"], r["checks"]
