"""The port's ``VisualOdometry`` end to end against the JAX package's, and
the surfaces around it (jax-free import, chip_smoke's workload, files,
unsupported options).

Whole slice, 10 frames of the small synthetic sequence through both
``VisualOdometry.run``:
- on the reference's pyramid levels (see ``torch_parity.reference_pyramid``):
  tracked / fsm / is_keyframe and every count equal on every frame, poses
  within 1 mm and 0.05 degrees;
- on the port's own pyramid (its resize differs by ~1e-4 gray levels, which
  moves a few keypoints): the flags equal on every frame and the port's ATE
  at most 1.05x the JAX package's + 0.5 mm.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from torch_parity import quat_angle_deg, reference_pyramid, small_cfgs, small_scene, x64_off  # noqa: F401
from rgbd_visualodometry_tpu.io.trajectory import read_trajectory
from rgbd_visualodometry_tpu.pipeline.system import VisualOdometry as JaxVO
from rgbd_visualodometry_tpu_torch import VisualOdometry, _shared
from rgbd_visualodometry_tpu_torch.evaltools import ate_rmse
from rgbd_visualodometry_tpu_torch.mapstate import LOST

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.usefixtures("x64_off")


@pytest.fixture(scope="module")
def seq():
    return _shared.generate_sequence(10, scene=small_scene())


@pytest.fixture(scope="module")
def jax_results(x64_off, seq):
    _, jcfg = small_cfgs()
    return JaxVO(jcfg).run((f.rgb, f.depth, f.timestamp) for f in seq)


def _ate(results, seq):
    gt = [_shared.pose_inverse(f.T_c_w)[4:7] for f in seq]
    tr = [r for r in results if r.tracked]
    return ate_rmse([r.timestamp for r in tr], [r.pose_w_c[4:7] for r in tr], [f.timestamp for f in seq], gt)


def _run(seq, **kw):
    cfg, _ = small_cfgs(**kw)
    vo = VisualOdometry(cfg)
    return vo, vo.run((f.rgb, f.depth, f.timestamp) for f in seq)


def test_slice_matches_on_the_same_pyramid(monkeypatch, seq, jax_results):
    from rgbd_visualodometry_tpu_torch.ops import image as tim

    monkeypatch.setattr(tim, "build_pyramid", reference_pyramid)
    _, res = _run(seq)
    assert len(res) == len(jax_results) == len(seq)
    for a, b in zip(res, jax_results):
        assert (a.tracked, a.fsm, a.is_keyframe) == (b.tracked, b.fsm, b.is_keyframe)
        assert a.stats == b.stats
        assert np.abs(a.pose_w_c[4:] - b.pose_w_c[4:]).max() < 1e-3
        assert quat_angle_deg(a.pose_w_c[:4], b.pose_w_c[:4]) < 0.05
    assert _ate(res, seq) <= 1.05 * _ate(jax_results, seq) + 5e-4


def test_slice_on_its_own_pyramid(seq, jax_results):
    _, res = _run(seq)
    assert all(r.tracked for r in res)
    for a, b in zip(res, jax_results):
        assert (a.tracked, a.fsm, a.is_keyframe) == (b.tracked, b.fsm, b.is_keyframe)
    ate, ate_ref = _ate(res, seq), _ate(jax_results, seq)
    assert ate <= 1.05 * ate_ref + 5e-4, (ate, ate_ref)
    assert ate < 0.03  # the bound of tests/test_pipeline.py::test_frontend_only_mode


def test_evaltools_ate_matches_reference():
    from rgbd_visualodometry_tpu.evaltools import absolute_trajectory_error

    rng = np.random.default_rng(0)
    ts = np.arange(30) / 30.0
    gt = np.cumsum(rng.normal(0, 0.02, (30, 3)), axis=0)
    est = gt + rng.normal(0, 0.005, (30, 3))
    want = absolute_trajectory_error(ts, est, ts, gt).rmse
    assert abs(ate_rmse(ts, est, ts, gt) - want) < 1e-12


def test_port_runs_without_jax():
    code = (
        "import sys\n"
        "import rgbd_visualodometry_tpu_torch as port\n"
        "from rgbd_visualodometry_tpu_torch import _shared\n"
        "import torch; torch.set_num_threads(2)\n"
        "cfg = _shared.VOConfig(image_width=160, image_height=120, camera_fx=129.3, camera_fy=129.1,"
        " camera_cx=79.6, camera_cy=63.8, number_of_features=150, level_pyramid=3, max_keyframes=8,"
        " max_mappoints=1024, packed_matching=True, enable_local_optimization=False)\n"
        "sc = _shared.SyntheticScene(width=160, height=120, fx=129.3, fy=129.1, cx=79.6, cy=63.8)\n"
        "res = port.VisualOdometry(cfg).run((f.rgb, f.depth, f.timestamp) for f in _shared.generate_sequence(3, scene=sc))\n"
        "assert len(res) == 3 and res[0].tracked, res\n"
        "assert 'jax' not in sys.modules and 'rgbd_visualodometry_tpu' not in sys.modules\n"
        "print('ok', sorted(m for m in sys.modules if m.startswith('jax')))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "ok []"


def test_chip_smoke_runs_the_bench_workload():
    sys.path.insert(0, REPO)
    try:
        import bench
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    from rgbd_visualodometry_tpu.config import VOConfig as JaxVOConfig

    want = bench.single_stream_cfg(JaxVOConfig()).replace(packed_matching=True, enable_local_optimization=False)
    got = chip_smoke.slice_config()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.image_width, got.image_height, got.number_of_features, got.level_pyramid, got.max_mappoints) == (640, 480, 500, 8, 16384)
    for a, b in zip(chip_smoke.make_frames(got, 3), bench._make_frames(want, 3)):
        assert a.timestamp == b.timestamp
        np.testing.assert_array_equal(a.rgb, b.rgb)
        np.testing.assert_array_equal(a.depth, b.depth)
        np.testing.assert_array_equal(a.T_c_w, b.T_c_w)


def test_trajectory_and_stats_files(tmp_path, seq):
    cfg, _ = small_cfgs()
    traj, stats = str(tmp_path / "traj.txt"), str(tmp_path / "stats.jsonl")
    res = VisualOdometry(cfg).run(((f.rgb, f.depth, f.timestamp) for f in seq[:5]), trajectory_path=traj, stats_path=stats)
    ts, poses = read_trajectory(traj)
    assert len(ts) == 5
    np.testing.assert_allclose(poses[0], [1, 0, 0, 0, 0, 0, 0], atol=1e-6)
    np.testing.assert_allclose(poses[-1], res[-1].pose_w_c, atol=1e-6)
    lines = [json.loads(x) for x in open(stats, encoding="utf-8")]
    assert len(lines) == 5 and lines[0]["num_new_mappoints"] > 100
    assert {"step_seconds", "num_matches", "fsm"} <= set(lines[1])


def test_staged_frames_match_numpy_path(seq):
    cfg, _ = small_cfgs()
    a = VisualOdometry(cfg)
    for f in seq[:4]:
        a.process_async(f.rgb, f.depth, f.timestamp)
    a.drain(0)
    b = VisualOdometry(cfg)
    staged = [(b.put_frame(f.rgb, f.depth, f.timestamp), f.timestamp) for f in seq[:4]]
    for fr, ts in staged:
        b.process_async(fr, timestamp=ts)
    b.drain(0)
    for x, y in zip(a.results, b.results):
        assert x.timestamp == y.timestamp and x.stats == y.stats
        np.testing.assert_array_equal(x.pose_w_c, y.pose_w_c)


def test_lost_is_terminal_without_relocalization(seq):
    cfg, _ = small_cfgs(max_num_lost=2, enable_relocalization=False)
    vo = VisualOdometry(cfg)
    for f in seq[:3]:
        vo.process(f.rgb, f.depth, f.timestamp)
    assert not vo.lost
    black, nodepth = np.zeros((240, 320, 3), np.uint8), np.zeros((240, 320), np.uint16)
    for i in range(5):
        if vo.process(black, nodepth, 1.0 + i).fsm == LOST:
            break
    assert vo.lost
    res = vo.process(seq[0].rgb, seq[0].depth, 99.0)
    assert res.fsm == LOST and not res.tracked


def test_unsupported_options_raise(seq):
    for kw in (dict(enable_viewer=True), dict(relax_every_kf=4)):
        cfg, _ = small_cfgs(**kw)
        with pytest.raises(NotImplementedError):
            VisualOdometry(cfg)
    cfg, _ = small_cfgs(enable_local_optimization=True)
    vo = VisualOdometry(cfg)
    with pytest.raises(NotImplementedError, match="local BA"):
        vo.run((f.rgb, f.depth, f.timestamp) for f in seq)
    # the frames before the first keyframe that requests BA went through
    assert vo.results and not any(r.is_keyframe for r in vo.results)
