"""``strict_parity=True``, the port against the JAX package end to end.

``VOConfig(strict_parity=True)`` flips every documented improvement back to
the reference C++ program's behaviour.  This run covers the three flags
that change what a tracking run computes or writes:

- ``compat_single_triangulation``: at most one point is triangulated per
  keyframe (``frontend.cpp:501``), and the run triangulates at least one;
- ``compat_double_lost_increment``: a bad frame adds 2 to the lost counter
  (``frontend.cpp:113-114``).  With ``max_num_lost=2`` one bad frame keeps
  the stream TRACKING and a second in a row makes it LOST, where a single
  increment would keep it TRACKING; without relocalization it stays LOST
  (the run stops once it reads that record, 3 frames late);
- ``compat_write_untracked_poses``: every frame that is not LOST is written
  to the trajectory (``run_vo.cpp:116``), the untracked ones included.

24 frames of the 320x240 synthetic sequence (``torch_parity.small_scene``)
with a gray image (no keypoint, so no estimate) at frames 12, 20 and 21,
through both ``VisualOdometry.run`` on the reference's pyramid levels, no
local BA: tracked / fsm / is_keyframe and every count equal on every frame,
poses within 1 mm and 0.05 degrees (``test_torch_system.py``), and the
trajectory files' rows the same frames, their poses in the same tolerance.
"""

import numpy as np
import pytest

from torch_parity import quat_angle_deg, reference_pyramid, small_cfgs, small_scene, x64_off  # noqa: F401
from rgbd_visualodometry_tpu.io.trajectory import read_trajectory as jax_read_trajectory
from rgbd_visualodometry_tpu.pipeline.system import VisualOdometry as JaxVO
from rgbd_visualodometry_tpu_torch import VisualOdometry
from rgbd_visualodometry_tpu_torch.io import synthetic
from rgbd_visualodometry_tpu_torch.io.trajectory import read_trajectory
from rgbd_visualodometry_tpu_torch.mapstate import LOST, TRACKING

pytestmark = pytest.mark.usefixtures("x64_off")

BAD = (12, 20, 21)


@pytest.fixture(scope="module")
def frames():
    seq = synthetic.generate_sequence(24, scene=small_scene())
    return [(np.full_like(f.rgb, 128) if i in BAD else f.rgb, f.depth, f.timestamp) for i, f in enumerate(seq)]


@pytest.fixture(scope="module")
def runs(frames, tmp_path_factory, x64_off):
    from rgbd_visualodometry_tpu_torch.ops import image as tim

    tmp = tmp_path_factory.mktemp("strict")
    cfg, jcfg = small_cfgs(strict_parity=True, max_num_lost=2)
    assert cfg.compat_single_triangulation and cfg.compat_double_lost_increment and cfg.compat_write_untracked_poses
    want = JaxVO(jcfg).run(iter(frames), trajectory_path=str(tmp / "jax.txt"))
    saved = tim.build_pyramid
    tim.build_pyramid = reference_pyramid
    try:
        got = VisualOdometry(cfg, device="cpu").run(iter(frames), trajectory_path=str(tmp / "port.txt"))
    finally:
        tim.build_pyramid = saved
    return got, want, read_trajectory(str(tmp / "port.txt")), jax_read_trajectory(str(tmp / "jax.txt"))


def _close(a, b):
    return np.abs(a[4:] - b[4:]).max() < 1e-3 and quat_angle_deg(a[:4], b[:4]) < 0.05


def test_strict_parity_records_match(runs):
    got, want, _, _ = runs
    assert len(got) == len(want) == 24
    for a, b in zip(got, want):
        assert (a.tracked, a.fsm, a.is_keyframe) == (b.tracked, b.fsm, b.is_keyframe)
        assert a.stats == b.stats
        assert _close(a.pose_w_c, b.pose_w_c)


def test_single_triangulation(runs):
    got, _, _, _ = runs
    tri = [r.stats["num_triangulated"] for r in got]
    assert max(tri) == 1, tri


def test_double_lost_increment(runs):
    got, _, _, _ = runs
    assert [r.tracked for r in got[: BAD[2] + 1]].count(False) == len(BAD)
    assert got[BAD[0]].fsm == got[BAD[1]].fsm == TRACKING  # one bad frame: lost_count 2, not above 2
    assert got[BAD[0] + 1].tracked  # a good frame resets the count
    assert got[BAD[2]].fsm == LOST  # the second in a row: 4 > 2
    assert all(r.fsm == LOST for r in got[BAD[2]:])  # no relocalization


def test_untracked_poses_written(runs):
    got, want, (ts, poses), (jts, jposes) = runs
    rows = [r.timestamp for r in got if r.fsm != LOST]  # the untracked frames 12 and 20 among them
    assert len(rows) == BAD[2] and not got[BAD[0]].tracked and not got[BAD[1]].tracked
    np.testing.assert_allclose(ts, rows, rtol=0, atol=5e-5)  # the file keeps 4 decimals
    np.testing.assert_allclose(jts, ts, rtol=0, atol=0)
    assert all(_close(a, b) for a, b in zip(poses, jposes))
