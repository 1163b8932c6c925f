"""The port's ``VisualOdometry`` end to end against the JAX package's, and
the surfaces around it (jax-free import, chip_smoke's workloads, files,
unsupported options).

Whole slice without local BA, 10 frames of the small synthetic sequence
through both ``VisualOdometry.run``:
- on the reference's pyramid levels (see ``torch_parity.reference_pyramid``):
  tracked / fsm / is_keyframe and every count equal on every frame, poses
  within 1 mm and 0.05 degrees;
- on the port's own pyramid (its resize differs by ~1e-4 gray levels, which
  moves a few keypoints): the flags equal on every frame and the port's ATE
  at most 1.05x the JAX package's + 0.5 mm.

Full VO (local BA after every keyframe), 15 frames on the reference's
pyramid: the flags equal on every frame, the same number of BA dispatches,
poses within 1 mm and 0.05 degrees (BA's float32 sums run in another order
in torch and XLA, and its bf16 blocks round at other points, so keyframe
poses and points differ in the last bits and tracking inherits that), the
port's ATE at most 1.05x the JAX package's + 0.5 mm and < 2 cm.
"""

import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from torch_parity import quat_angle_deg, reference_pyramid, small_cfgs, small_scene, x64_off  # noqa: F401
from rgbd_visualodometry_tpu.io.trajectory import read_trajectory
from rgbd_visualodometry_tpu.pipeline.system import VisualOdometry as JaxVO
from rgbd_visualodometry_tpu_torch import VisualOdometry
from rgbd_visualodometry_tpu_torch.io import synthetic
from rgbd_visualodometry_tpu_torch.evaltools import ate_rmse
from rgbd_visualodometry_tpu_torch.mapstate import LOST
from rgbd_visualodometry_tpu_torch.pipeline import system

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.usefixtures("x64_off")


@pytest.fixture(scope="module")
def seq():
    return synthetic.generate_sequence(10, scene=small_scene())


@pytest.fixture(scope="module")
def jax_results(x64_off, seq):
    _, jcfg = small_cfgs()
    return JaxVO(jcfg).run((f.rgb, f.depth, f.timestamp) for f in seq)


def _ate(results, seq):
    gt = [synthetic._pose_inverse(f.T_c_w)[4:7] for f in seq]
    tr = [r for r in results if r.tracked]
    return ate_rmse([r.timestamp for r in tr], [r.pose_w_c[4:7] for r in tr], [f.timestamp for f in seq], gt)


def _run(seq, **kw):
    cfg, _ = small_cfgs(**kw)
    vo = VisualOdometry(cfg, device="cpu")
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


def test_full_vo_matches_on_the_same_pyramid(monkeypatch):
    from rgbd_visualodometry_tpu_torch.ops import image as tim

    seq = synthetic.generate_sequence(15, scene=small_scene())
    cfg, jcfg = small_cfgs(enable_local_optimization=True)
    jvo = JaxVO(jcfg)
    jax_ba = jvo._ba
    jax_dispatches = []

    def counted(*a):
        jax_dispatches.append(1)
        return jax_ba(*a)

    jvo._ba = counted
    want = jvo.run((f.rgb, f.depth, f.timestamp) for f in seq)
    monkeypatch.setattr(tim, "build_pyramid", reference_pyramid)
    vo = VisualOdometry(cfg, device="cpu")
    got = vo.run((f.rgb, f.depth, f.timestamp) for f in seq)
    assert len(got) == len(want) == len(seq) and all(r.tracked for r in got)
    for a, b in zip(got, want):
        assert (a.tracked, a.fsm, a.is_keyframe) == (b.tracked, b.fsm, b.is_keyframe)
        assert np.abs(a.pose_w_c[4:] - b.pose_w_c[4:]).max() < 1e-3
        assert quat_angle_deg(a.pose_w_c[:4], b.pose_w_c[:4]) < 0.05
    assert vo.ba_dispatches == len(jax_dispatches) == sum(r.is_keyframe for r in got) >= 2
    ate, ate_ref = _ate(got, seq), _ate(want, seq)
    assert ate <= 1.05 * ate_ref + 5e-4, (ate, ate_ref)
    assert ate < 0.02  # the bound of tests/test_pipeline.py::test_tracks_synthetic_sequence
    snap = vo.map_snapshot()
    assert snap["mappoints"].shape[0] > 300 and snap["mappoints"].shape[1] == 3
    assert snap["num_keyframes"] >= 3 and snap["keyframe_poses"].shape == (snap["num_keyframes"], 7)


def test_evaltools_ate_matches_reference():
    from rgbd_visualodometry_tpu.evaltools import absolute_trajectory_error

    rng = np.random.default_rng(0)
    ts = np.arange(30) / 30.0
    gt = np.cumsum(rng.normal(0, 0.02, (30, 3)), axis=0)
    est = gt + rng.normal(0, 0.005, (30, 3))
    want = absolute_trajectory_error(ts, est, ts, gt).rmse
    assert abs(ate_rmse(ts, est, ts, gt) - want) < 1e-12


def test_port_runs_without_jax():
    """The port, imported and run for 8 CPU frames with BA, one
    ``global_relax`` (``ops.posegraph``, ``ops.loopclosure``,
    ``pipeline.globalopt``), 2 batched steps of two streams
    (``parallel.MultiStreamVO``), 2 frames of ``parallel.ShardedMapVO`` on
    a one-rank gloo group (``ops.collectives``), then the user-facing surfaces - ``cli.main``
    on a config file with ``--synthetic 4 --cpu --save-map``, the
    checkpoint's ``load_state``, ``evaltools``, a TUM directory through
    ``io.tum`` (``io.png``, ``native``), ``viz`` and ``utils`` - in a fresh
    process, loads no file of the JAX package - neither through an import
    nor by file path - and never imports jax or PyYAML."""
    code = (
        "import os, sys\n"
        "import rgbd_visualodometry_tpu_torch as port\n"
        "from rgbd_visualodometry_tpu_torch.io import synthetic\n"
        "import torch; torch.set_num_threads(2)\n"
        "cfg = port.VOConfig(image_width=160, image_height=120, camera_fx=129.3, camera_fy=129.1,"
        " camera_cx=79.6, camera_cy=63.8, number_of_features=150, level_pyramid=3, max_keyframes=8,"
        " max_mappoints=1024, ba_max_points=256, packed_matching=True, enable_local_optimization=True)\n"
        "sc = synthetic.SyntheticScene(width=160, height=120, fx=129.3, fy=129.1, cx=79.6, cy=63.8)\n"
        "vo = port.VisualOdometry(cfg, device='cpu')\n"
        "seq = synthetic.generate_sequence(9, scene=sc)\n"
        "res = vo.run((f.rgb, f.depth, f.timestamp) for f in seq[:8])\n"
        "assert len(res) == 8 and res[0].tracked and vo.ba_dispatches > 0, (res, vo.ba_dispatches)\n"
        "from rgbd_visualodometry_tpu_torch.ops import loopclosure, posegraph\n"
        "from rgbd_visualodometry_tpu_torch.pipeline import globalopt\n"
        "rep = vo.global_relax()\n"
        "assert rep.num_edges >= 1 and rep.kf_ts.size >= 2 and isinstance(rep, globalopt.RelaxReport), rep\n"
        "assert vo.process(seq[8].rgb, seq[8].depth, seq[8].timestamp).tracked\n"
        "import numpy as np\n"
        "from rgbd_visualodometry_tpu_torch.parallel import MultiStreamVO\n"
        "ms = MultiStreamVO(cfg, 2, device='cpu')\n"
        "seqs = [synthetic.generate_sequence(2, scene=synthetic.SyntheticScene(width=160, height=120, fx=129.3,"
        " fy=129.1, cx=79.6, cy=63.8, seed=s)) for s in range(2)]\n"
        "for i in range(2):\n"
        "    out = ms.step(np.stack([q[i].rgb for q in seqs]), np.stack([q[i].depth for q in seqs]),"
        " np.array([q[i].timestamp for q in seqs]))\n"
        "ms.finish()\n"
        "assert out.packed.shape == (2, 32) and bool(out.tracked.all()), out.packed\n"
        "import tempfile\n"
        "from rgbd_visualodometry_tpu_torch.ops import collectives\n"
        "from rgbd_visualodometry_tpu_torch.parallel import ShardedMapVO, map_partition_specs, open_group\n"
        "from rgbd_visualodometry_tpu_torch.parallel import sharded_match_descriptors\n"
        "tp = ShardedMapVO(cfg, open_group('gloo', 'file://' + tempfile.mkdtemp() + '/rdv', 1, 0), device='cpu')\n"
        "assert all(tp.process(f.rgb, f.depth, f.timestamp).tracked for f in seq[:2]) and tp.shard.world == 1\n"
        "assert map_partition_specs().A_inc == 1 and callable(sharded_match_descriptors) and collectives.MapShard\n"
        "torch.distributed.destroy_process_group()\n"
        "from rgbd_visualodometry_tpu_torch import cli, evaltools, native, viz\n"
        "from rgbd_visualodometry_tpu_torch.io import checkpoint, png, trajectory, tum\n"
        "from rgbd_visualodometry_tpu_torch.utils import StageTimer\n"
        "d = tempfile.mkdtemp()\n"
        "open(d + '/cfg.yaml', 'w').write('%YAML:1.0\\nimage_width: 160\\nimage_height: 120\\ncamera.fx: 129.3\\n'\n"
        "    'camera.fy: 129.1\\ncamera.cx: 79.6\\ncamera.cy: 63.8\\nnumber_of_features: 150\\nlevel_pyramid: 3\\n'\n"
        "    'max_keyframes: 8\\nmax_mappoints: 1024\\nba_max_points: 256 # comment\\n')\n"
        "timer = StageTimer()\n"
        "with timer.stage('cli'):\n"
        "    rc = cli.main([d + '/cfg.yaml', '--synthetic', '4', '--cpu', '--quiet', '--save-map', d + '/m.npz', '--output', d + '/t.txt'])\n"
        "assert rc == 0 and timer.counts['cli'] == 1\n"
        "state, c, meta = checkpoint.load_state(d + '/m.npz', with_meta=True, device='cpu')\n"
        "assert c.max_mappoints == 1024 and int(state.num_kf) >= 1 and 'time_base' in meta\n"
        "ts, poses = trajectory.read_trajectory(d + '/t.txt')\n"
        "assert len(ts) >= 2 and evaltools.ate_rmse(ts, poses[:, 4:], ts, poses[:, 4:]) < 1e-9\n"
        "os.makedirs(d + '/tum/rgb'); os.makedirs(d + '/tum/depth')\n"
        "for i, f in enumerate(seq[:2]):\n"
        "    png.write(f'{d}/tum/rgb/{i}.png', f.rgb); png.write(f'{d}/tum/depth/{i}.png', f.depth)\n"
        "open(d + '/tum/rgb.txt', 'w').write('0.0 rgb/0.png\\n0.1 rgb/1.png\\n')\n"
        "open(d + '/tum/depth.txt', 'w').write('0.0 depth/0.png\\n0.1 depth/1.png\\n')\n"
        "for use_native in (True, False):\n"
        "    got = list(tum.iter_dataset(d + '/tum', 160, 120, use_native=use_native))\n"
        "    assert len(got) == 2 and (got[1][1] == seq[1].rgb).all() and (got[1][2] == seq[1].depth).all()\n"
        "v = viz.MapViewer(d + '/viz')\n"
        "v.export_html(vo.map_snapshot()); v.render_overlay(seq[0].rgb, np.zeros((3, 2)))\n"
        "assert sorted(os.listdir(d + '/viz')) == ['frame_00000.png', 'map.html'], native.available()\n"
        "ref = os.path.join(sys.argv[1], 'rgbd_visualodometry_tpu') + os.sep\n"
        "loaded = sorted(n for n, m in list(sys.modules.items())\n"
        "                if os.path.abspath(getattr(m, '__file__', None) or '').startswith(ref))\n"
        "print('ok', loaded, sorted(m for m in sys.modules if m in ('jax', 'yaml') or m.startswith(('jax.', 'yaml.'))))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code, REPO], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "ok [] []", proc.stdout[-3000:]


def test_default_device_is_the_card():
    """The entry points default to CUDA; without a card they raise instead
    of running on the CPU."""
    import torch

    from rgbd_visualodometry_tpu_torch import mapstate

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    cfg, _ = small_cfgs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VisualOdometry(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mapstate.init_state(cfg)
    leaves = {k: v.numpy() for k, v in vars(mapstate.init_state(cfg, device="cpu")).items()}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mapstate.state_from_numpy(leaves)


def test_chip_smoke_runs_the_bench_workload():
    sys.path.insert(0, REPO)
    try:
        import bench
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    from rgbd_visualodometry_tpu.config import VOConfig as JaxVOConfig

    full = bench.single_stream_cfg(JaxVOConfig())
    assert dataclasses.asdict(chip_smoke.full_vo_config()) == dataclasses.asdict(full)
    assert full.enable_local_optimization and full.ba_min_frame_gap == 0 and full.ba_bf16
    want = full.replace(packed_matching=True, enable_local_optimization=False)
    got = chip_smoke.slice_config()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.image_width, got.image_height, got.number_of_features, got.level_pyramid, got.max_mappoints) == (640, 480, 500, 8, 16384)
    ms = bench.multistream_cfg(JaxVOConfig(), full_vo=True)
    assert dataclasses.asdict(chip_smoke.multistream_config()) == dataclasses.asdict(ms)
    assert ms.packed_matching and ms.enable_local_optimization and ms.ba_min_frame_gap == 14
    assert (chip_smoke.MS_STREAMS, chip_smoke.MS_WARMUP) == (bench.FULL_VO_STREAMS, bench.WARMUP_FRAMES)
    assert chip_smoke.TRACKING_STREAMS == bench.TRACKING_STREAMS
    # the bench phase's result line carries bench.py's keys, in its order
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        bench._Reporter().add({"median": 2.0, "best": 2.5, "passes": 1}, 3.45, "single-stream full VO")
    assert list(json.loads(text.getvalue())) == chip_smoke.BENCH_KEYS
    for a, b in zip(chip_smoke.make_frames(got, 3), bench._make_frames(want, 3)):
        assert a.timestamp == b.timestamp
        np.testing.assert_array_equal(a.rgb, b.rgb)
        np.testing.assert_array_equal(a.depth, b.depth)
        np.testing.assert_array_equal(a.T_c_w, b.T_c_w)


def test_chip_smoke_runs_the_fullres_loop_workload():
    """chip_smoke's loop-closure phase is the JAX package's slow
    ``test_online_relax_fullres_closed_loop``: the same config and the same
    faulted circuit (here 8 frames: the fault covers frames 2-5)."""
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    from rgbd_visualodometry_tpu.config import VOConfig as JaxVOConfig
    from rgbd_visualodometry_tpu.io import synthetic as jsyn

    want = JaxVOConfig(
        image_width=640, image_height=480, camera_fx=517.3, camera_fy=516.5, camera_cx=318.6, camera_cy=255.3,
        number_of_features=500, level_pyramid=8, max_keyframes=64, max_mappoints=16384, max_obs_per_mappoint=8,
        pnp_max_points=512, triangulation_batch=128, ransac_hypotheses=64, ba_max_poses=8, ba_max_points=1024,
        relax_every_kf=6, relax_loop_gap_s=1.0,
    )
    cfg = chip_smoke.loop_config()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want)
    assert cfg.relax_async and chip_smoke.LOOP_FRAMES == 64
    frames, depths = chip_smoke.loop_frames(cfg, 8)
    scene = jsyn.SyntheticScene(width=640, height=480, fx=517.3, fy=516.5, cx=318.6, cy=255.3)
    for i, (f, d, T) in enumerate(zip(frames, depths, jsyn.loop_trajectory(8, step=0.03))):
        g = scene.render(T, timestamp=i / 30.0)
        assert f.timestamp == g.timestamp
        np.testing.assert_array_equal(f.rgb, g.rgb)
        faulted = np.clip(g.depth.astype(np.float32) * 1.05, 0, 65535).astype(np.uint16)
        np.testing.assert_array_equal(d, faulted if 2 <= i < 6 else g.depth)


def test_trajectory_and_stats_files(tmp_path, seq):
    cfg, _ = small_cfgs()
    traj, stats = str(tmp_path / "traj.txt"), str(tmp_path / "stats.jsonl")
    res = VisualOdometry(cfg, device="cpu").run(((f.rgb, f.depth, f.timestamp) for f in seq[:5]), trajectory_path=traj, stats_path=stats)
    ts, poses = read_trajectory(traj)
    assert len(ts) == 5
    np.testing.assert_allclose(poses[0], [1, 0, 0, 0, 0, 0, 0], atol=1e-6)
    np.testing.assert_allclose(poses[-1], res[-1].pose_w_c, atol=1e-6)
    lines = [json.loads(x) for x in open(stats, encoding="utf-8")]
    assert len(lines) == 5 and lines[0]["num_new_mappoints"] > 100
    # the JAX package's record: no host timing in it
    assert list(lines[1]) == ["timestamp", "tracked", "fsm", "is_keyframe", *system._STATS]


def test_staged_frames_match_numpy_path(seq):
    cfg, _ = small_cfgs()
    a = VisualOdometry(cfg, device="cpu")
    for f in seq[:4]:
        a.process_async(f.rgb, f.depth, f.timestamp)
    a.drain(0)
    b = VisualOdometry(cfg, device="cpu")
    staged = [(b.put_frame(f.rgb, f.depth, f.timestamp), f.timestamp) for f in seq[:4]]
    for fr, ts in staged:
        b.process_async(fr, timestamp=ts)
    b.drain(0)
    for x, y in zip(a.results, b.results):
        assert x.timestamp == y.timestamp and x.stats == y.stats
        np.testing.assert_array_equal(x.pose_w_c, y.pose_w_c)


def test_lost_is_terminal_without_relocalization(seq):
    cfg, _ = small_cfgs(max_num_lost=2, enable_relocalization=False)
    vo = VisualOdometry(cfg, device="cpu")
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

