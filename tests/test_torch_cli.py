"""The port's command line (``cli.py``) end to end on the CPU (``--cpu``),
modelled on ``tests/test_cli_dataset.py``: a TUM-layout directory on disk
(PNGs from the port's writer, real epoch stamps ~1.3e9 s), association,
decode, tracking, the trajectory, ``--evaluate``, map save and resume,
localization against a frozen map, ``--synthetic`` with ``--global-relax``
and ``--stats``, and the viewer with and without matplotlib.

The JAX package's ``cli.main`` runs on the same YAML and inputs (the TUM
directory, and ``--synthetic 6 --global-relax``; one compile of its
tracking step, in its float32 production mode): the exit codes, the
printed lines with their numbers masked, the frames tracked, the
trajectory's stamps and the stats records are equal, and the
trajectories, the relaxed one included, agree within 2 mm.  These runs of
the port take the JAX package's pyramid levels
(``torch_parity.reference_pyramid``): the port's own resize is not
bit-exact, which moves a few keypoints and the poses by up to ~1 cm.  The
other runs here use the port's own pyramid.
"""

import contextlib
import io
import json
import os
import re
import sys

import numpy as np
import pytest

from torch_parity import reference_pyramid, x64_off  # noqa: F401
from rgbd_visualodometry_tpu import cli as jcli
from rgbd_visualodometry_tpu_torch import cli
from rgbd_visualodometry_tpu_torch.evaltools import absolute_trajectory_error
from rgbd_visualodometry_tpu_torch.io import png, synthetic
from rgbd_visualodometry_tpu_torch.io.trajectory import read_trajectory
from rgbd_visualodometry_tpu_torch.ops import image as timage

T0 = 1305031102.175304  # the first stamp of TUM fr1/xyz
POSE_TOL_M = 0.002  # port vs JAX camera positions, per frame (0.53 mm seen)


def small_yaml(tmp_path, dataset_dir, output, **extra):
    """The config of ``tests/test_cli_dataset.py::small_yaml`` (reference
    keys + the port's extra keys), plus ``extra`` lines."""
    text = f"""%YAML:1.0
dataset_dir: {dataset_dir}
output_file: {output}
camera.fx: 258.6
camera.fy: 258.2
camera.cx: 159.3
camera.cy: 127.6
camera.depth_scale: 5000
number_of_features: 300
scale_factor: 1.2
level_pyramid: 4
match_ratio: 2.0
max_num_lost: 10
min_inliers: 10
keyframe_rotation: 0.05
keyframe_translation: 0.05
enable_local_optimization: 1
chi2_th: 1
enable_viewer: 0
image_width: 320
image_height: 240
max_keyframes: 32
max_mappoints: 4096
max_obs_per_mappoint: 8
pnp_max_points: 512
triangulation_batch: 256
ransac_hypotheses: 64
ba_max_poses: 8
ba_max_points: 2048
""" + "".join(f"{k}: {v}\n" for k, v in extra.items())
    p = tmp_path / "cfg.yaml"
    p.write_text(text)
    return str(p)


def run_cli(argv, main=cli.main):
    """``main(argv)`` (the port's ``cli.main`` by default) -> (exit code,
    what it printed)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def masked(text, paths):
    """The printed lines with the run's own file paths and every number
    masked."""
    for p in paths:
        text = text.replace(p, "<path>")
    return [re.sub(r"\d+(\.\d+)?", "#", ln) for ln in text.splitlines()]


def tracked_line(text):
    return re.search(r"^(\d+/\d+) frames tracked in ", text, re.M).group(1)


def assert_same_trajectory(port_path, jax_path):
    """The same stamps, and camera positions within ``POSE_TOL_M``."""
    pts, pposes = read_trajectory(port_path)
    jts, jposes = read_trajectory(jax_path)
    np.testing.assert_array_equal(pts, jts)
    err = np.linalg.norm(pposes[:, 4:7] - jposes[:, 4:7], axis=1)
    print(f"port vs JAX: {len(pts)} poses, positions differ by up to {err.max() * 100:.3f} cm")
    assert err.max() < POSE_TOL_M, f"port vs JAX positions differ by up to {err.max() * 100:.3f} cm"


@pytest.fixture(scope="module")
def tum_dir(tmp_path_factory):
    """8 synthetic 320x240 frames as a TUM directory with epoch stamps."""
    d = tmp_path_factory.mktemp("tum_seq")
    (d / "rgb").mkdir()
    (d / "depth").mkdir()
    seq = synthetic.generate_sequence(8, scene=synthetic.SyntheticScene(
        width=320, height=240, fx=258.6, fy=258.2, cx=159.3, cy=127.6))
    rgb_lines, depth_lines, gt_lines = [], [], []
    for f in seq:
        ts = f"{T0 + f.timestamp:.6f}"
        png.write(str(d / "rgb" / f"{ts}.png"), f.rgb)
        png.write(str(d / "depth" / f"{ts}.png"), f.depth)
        rgb_lines.append(f"{ts} rgb/{ts}.png")
        depth_lines.append(f"{ts} depth/{ts}.png")
        T_w_c = synthetic._pose_inverse(f.T_c_w)
        q, t = T_w_c[:4], T_w_c[4:7]
        gt_lines.append(f"{ts} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f} {q[0]:.6f}")
    (d / "rgb.txt").write_text("\n".join(rgb_lines) + "\n")
    (d / "depth.txt").write_text("\n".join(depth_lines) + "\n")
    (d / "groundtruth.txt").write_text("\n".join(gt_lines) + "\n")
    return d


def _ate(traj, tum_dir):
    est_ts, est = read_trajectory(traj)
    gt_ts, gt = read_trajectory(str(tum_dir / "groundtruth.txt"))
    return len(est_ts), absolute_trajectory_error(est_ts, est[:, 4:7], gt_ts, gt[:, 4:7]).rmse


def _tum_run(main, d, tum_dir):
    """A mapping run over the directory: ``--evaluate``, ``--save-map``,
    ``--stats``."""
    out, ckpt, stats = str(d / "out" / "traj.txt"), str(d / "map.npz"), str(d / "stats.jsonl")
    cfg_path = small_yaml(d, str(tum_dir), out)
    rc, text = run_cli([cfg_path, "--cpu", "--quiet", "--evaluate", str(tum_dir / "groundtruth.txt"),
                        "--save-map", ckpt, "--stats", stats], main)
    return dict(rc=rc, text=text, out=out, ckpt=ckpt, stats=stats, cfg=cfg_path, paths=[out, ckpt, stats])


def _synthetic_run(main, d):
    """``--synthetic 6 --global-relax --stats`` on the same YAML."""
    out, stats = str(d / "syn.txt"), str(d / "syn.jsonl")
    cfg_path = small_yaml(d, "", out)
    rc, text = run_cli([cfg_path, "--cpu", "--quiet", "--synthetic", "6", "--global-relax", "--stats", stats], main)
    return dict(rc=rc, text=text, out=out, stats=stats, paths=[out, stats])


@contextlib.contextmanager
def jax_pyramid():
    """The port on the JAX package's pyramid levels, so its ORB output is
    identical and its runs can be held to the JAX ones tightly."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(timage, "build_pyramid", reference_pyramid)
        yield


@pytest.fixture(scope="module")
def mapped(x64_off, tum_dir, tmp_path_factory):
    with jax_pyramid():
        return _tum_run(cli.main, tmp_path_factory.mktemp("mapped"), tum_dir)


@pytest.fixture(scope="module")
def synthetic_relaxed(x64_off, tmp_path_factory):
    with jax_pyramid():
        return _synthetic_run(cli.main, tmp_path_factory.mktemp("synthetic"))


@pytest.fixture(scope="module")
def jax_cli(x64_off, tum_dir, tmp_path_factory):
    """The JAX package's ``cli.main`` on the same YAML and inputs."""
    return dict(tum=_tum_run(jcli.main, tmp_path_factory.mktemp("jax_mapped"), tum_dir),
                synthetic=_synthetic_run(jcli.main, tmp_path_factory.mktemp("jax_synthetic")))


def test_cli_end_to_end_on_disk_dataset(mapped, tum_dir, jax_cli):
    assert mapped["rc"] == 0
    n, ate = _ate(mapped["out"], tum_dir)
    assert n == 8 and ate < 0.02, f"ATE {ate * 100:.2f} cm"
    est_ts, _ = read_trajectory(mapped["out"])
    np.testing.assert_allclose(est_ts, T0 + np.arange(8) / 30.0, atol=1e-4)  # epoch stamps kept
    lines = mapped["text"].splitlines()
    assert any(ln.startswith("8/8 frames tracked in ") for ln in lines)
    assert f"trajectory written to {mapped['out']}" in lines
    assert f"map checkpoint written to {mapped['ckpt']}" in lines
    assert any(ln.startswith("ATE rmse: ") and ln.endswith("n=8)") for ln in lines)
    assert any(ln.startswith("RPE(1s): ") for ln in lines)
    ref = jax_cli["tum"]
    assert mapped["rc"] == ref["rc"] == 0
    assert masked(mapped["text"], mapped["paths"]) == masked(ref["text"], ref["paths"])
    assert tracked_line(mapped["text"]) == tracked_line(ref["text"]) == "8/8"
    assert_same_trajectory(mapped["out"], ref["out"])


def test_cli_stats_keys_equal_the_jax_ones(mapped, jax_cli):
    records = [json.loads(ln) for ln in open(mapped["stats"], encoding="utf-8")]
    ref = [json.loads(ln) for ln in open(jax_cli["tum"]["stats"], encoding="utf-8")]
    assert len(records) == len(ref) == 8 and all(r["tracked"] for r in records)
    assert all(list(r) == list(ref[0]) for r in records + ref)
    assert [r["timestamp"] for r in records] == [r["timestamp"] for r in ref]
    assert records[0]["timestamp"] == pytest.approx(T0, abs=1e-6)
    assert records[0]["num_new_mappoints"] > 100 and records[-1]["num_matches"] > 100
    assert records == ref  # on the same pyramid levels, every count of every frame


def test_cli_save_and_load_map(tmp_path, tum_dir):
    out = str(tmp_path / "t.txt")
    ckpt = str(tmp_path / "map.npz")
    cfg_path = small_yaml(tmp_path, str(tum_dir), out)
    rc, _ = run_cli([cfg_path, "--cpu", "--quiet", "--max-frames", "4", "--save-map", ckpt])
    assert rc == 0 and os.path.getsize(ckpt) > 1000
    assert len(read_trajectory(out)[0]) == 4
    with np.load(ckpt) as data:
        assert json.loads(bytes(data["__meta__"]).decode()) == {"time_base": float(f"{T0:.6f}")}
    # resume and continue on the sequence
    rc, text = run_cli([cfg_path, "--cpu", "--quiet", "--load-map", ckpt, "--no-backend"])
    assert rc == 0 and "8/8 frames tracked" in text
    n, ate = _ate(out, tum_dir)
    assert n == 8 and ate < 0.02


def test_cli_localize_only(mapped, tum_dir, tmp_path):
    """Localize against the frozen map from a kidnapped start (--load-map
    --localize-only): every frame tracked, the map's keyframe, mappoint and
    observation leaves unchanged."""
    loc_out, loc_ckpt = str(tmp_path / "loc_run.txt"), str(tmp_path / "after_loc.npz")
    rc, _ = run_cli([mapped["cfg"], "--cpu", "--quiet", "--load-map", mapped["ckpt"], "--localize-only",
                     "--output", loc_out, "--save-map", loc_ckpt])
    assert rc == 0
    n, ate = _ate(loc_out, tum_dir)
    assert n == 8 and ate < 0.02, f"localization ATE {ate * 100:.2f} cm"
    from rgbd_visualodometry_tpu_torch.io.checkpoint import LEAVES

    with np.load(mapped["ckpt"]) as before, np.load(loc_ckpt) as after:
        for i, name in enumerate(LEAVES):
            if name.startswith(("kf_", "mp_", "obs_")) or name in ("num_kf", "A_inc"):
                np.testing.assert_array_equal(before[f"leaf_{i}"], after[f"leaf_{i}"], err_msg=name)
        assert int(after[f"leaf_{LEAVES.index('fsm')}"]) == 1  # TRACKING


def test_cli_synthetic_global_relax_and_stats(synthetic_relaxed, jax_cli):
    """``--global-relax`` rewrites the trajectory over the frames ``run``
    wrote, with the relaxed poses: as the JAX package's CLI does."""
    got, ref = synthetic_relaxed, jax_cli["synthetic"]
    assert got["rc"] == ref["rc"] == 0
    lines = got["text"].splitlines()
    relax = [ln for ln in lines if ln.startswith("global relax: ")]
    assert len(relax) == 1 and "co-obs edges" in relax[0] and relax[0].endswith(" cm")
    assert any(ln.startswith("ATE vs exact ground truth: rmse=") and ln.endswith("over 6 poses") for ln in lines)
    assert masked(got["text"], got["paths"]) == masked(ref["text"], ref["paths"])
    assert tracked_line(got["text"]) == tracked_line(ref["text"]) == "6/6"
    ts, poses = read_trajectory(got["out"])
    assert len(ts) == 6 and np.isfinite(poses).all()
    assert_same_trajectory(got["out"], ref["out"])
    assert len(open(got["stats"], encoding="utf-8").readlines()) == 6


@pytest.mark.parametrize("matplotlib", [True, False], ids=["matplotlib", "no matplotlib"])
def test_cli_viewer(tmp_path, monkeypatch, capsys, matplotlib):
    """``enable_viewer: 1``: an overlay per frame, a map render every
    ``viewer_map_every`` frames, ``map.html`` and the CLI's final render.
    Where matplotlib does not import, the map renders are skipped, with a
    note once and a printed line in place of "map rendered to"; the
    overlays and ``map.html`` are written all the same."""
    if not matplotlib:
        monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.chdir(tmp_path)
    cfg_path = small_yaml(tmp_path, "", str(tmp_path / "t.txt"), enable_viewer=1, viewer_map_every=3)
    rc, text = run_cli([cfg_path, "--cpu", "--quiet", "--synthetic", "4"])
    assert rc == 0 and "4/4 frames tracked" in text
    maps = ["map_00000.png", "map_00003.png"] if matplotlib else []
    assert sorted(os.listdir(tmp_path / "viewer_out")) == (
        [f"frame_{i:05d}.png" for i in range(4)] + ["map.html"] + maps)
    final = "map rendered to viewer_out/map_00000.png" if matplotlib else "map not rendered: matplotlib does not import here"
    assert final in text.splitlines()
    assert capsys.readouterr().err.count("matplotlib does not import here") == (0 if matplotlib else 1)


def test_cli_runs_on_the_card_unless_cpu(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    cfg_path = small_yaml(tmp_path, "", str(tmp_path / "t.txt"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_cli([cfg_path, "--synthetic", "2", "--quiet"])
    with pytest.raises(SystemExit):  # no dataset and no --synthetic
        run_cli([cfg_path, "--cpu"])


def test_profiling_stage_timer_and_trace(tmp_path):
    """``utils.profiling``: stages accumulate (a CPU result is not waited
    for), the summary lists them slowest first, and ``torch_trace`` writes
    a Chrome trace of the ops it saw."""
    import torch

    from rgbd_visualodometry_tpu_torch.utils import StageTimer, torch_trace

    t = StageTimer()
    for _ in range(3):
        with t.stage("matmul") as h:
            h["result"] = torch.ones(64, 64) @ torch.ones(64, 64)
    with t.stage("nothing", block_on={"a": [torch.zeros(2)]}):
        pass
    assert dict(t.counts) == {"matmul": 3, "nothing": 1} and t.totals["matmul"] > 0
    lines = t.summary().splitlines()
    assert len(lines) == 2 and lines[0].startswith("matmul: ") and "(n=3)" in lines[0]
    with torch_trace(str(tmp_path / "trace")) as path:
        torch.ones(8, 8).mm(torch.ones(8, 8))
    events = json.load(open(path, encoding="utf-8"))["traceEvents"]
    assert path == str(tmp_path / "trace" / "trace.json") and any("mm" in e.get("name", "") for e in events)


def test_chip_smoke_drives_the_cli_on_the_default_config():
    """``chip_smoke.py``'s CLI phase: ``configs/default.yaml`` is the
    full-width default (640x480, fr1 intrinsics, 500 features over 8 levels,
    local BA), 60 synthetic and 30 TUM frames."""
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    try:
        import chip_smoke
    finally:
        sys.path.remove(repo)
    from rgbd_visualodometry_tpu_torch import VOConfig, load_config

    cfg = load_config(os.path.join(repo, "configs", "default.yaml"))
    assert cfg == VOConfig().replace(dataset_dir="") and cfg.enable_local_optimization and not cfg.enable_viewer
    assert (cfg.image_width, cfg.image_height, cfg.number_of_features, cfg.level_pyramid) == (640, 480, 500, 8)
    assert (cfg.camera_fx, cfg.camera_fy, cfg.camera_cx, cfg.camera_cy) == (517.3, 516.5, 318.6, 255.3)
    assert (chip_smoke.CLI_FRAMES, chip_smoke.TUM_FRAMES) == (60, 30)
