"""The port's ``evaltools`` package against the JAX package's: the same
``ATEResult`` and ``RPEResult`` on the same trajectories (every field, the
per-pair arrays included), ``ate_rmse`` on the greedy association of
``absolute_trajectory_error``, and the eval CLI's printed lines, ``--save``
and ``--save_associations`` files and ``associate`` output byte-equal.
Every comparison is exact: the port's modules are copies.
"""

import os

import numpy as np
import pytest

from rgbd_visualodometry_tpu import evaltools as jev
from rgbd_visualodometry_tpu.evaltools import cli as jcli
from rgbd_visualodometry_tpu.evaltools import plot_trajectory as jplot
from rgbd_visualodometry_tpu_torch import evaltools as tev
from rgbd_visualodometry_tpu_torch.evaltools import cli as tcli
from rgbd_visualodometry_tpu_torch.evaltools import plot_trajectory as tplot
from rgbd_visualodometry_tpu_torch.io.trajectory import pose_to_tum_line

T0 = 1305031102.175304  # a TUM epoch stamp


def _results_equal(a, b):
    assert type(a).__name__ == type(b).__name__ and a._fields == b._fields
    for name, x, y in zip(a._fields, a, b):
        if isinstance(y, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, name
            np.testing.assert_array_equal(x, y, err_msg=name)
        else:
            assert x == y, name


def _trajectory(n, seed, dt=1 / 30.0, jitter=0.0):
    """``(stamps [n], poses [n, 7])``: a random walk with rotations."""
    rng = np.random.default_rng(seed)
    ts = T0 + np.arange(n) * dt + rng.uniform(-jitter, jitter, n)
    q = np.cumsum(rng.normal(0, 0.03, (n, 4)), axis=0) + [1.0, 0, 0, 0]
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    t = np.cumsum(rng.normal(0, 0.01, (n, 3)), axis=0)
    return ts, np.concatenate([q, t], axis=1)


@pytest.mark.parametrize("kw", [{}, dict(offset=0.01), dict(scale=1.3), dict(max_difference=0.005)])
@pytest.mark.parametrize("jitter", [0.0, 0.012])
def test_ate_equal(kw, jitter):
    gt_ts, gt = _trajectory(60, 0)
    est_ts, est = _trajectory(55, 1, jitter=jitter)
    est[:, 4:] = gt[:55, 4:] @ np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1.0]]) + 0.01 * est[:, 4:]
    want = jev.absolute_trajectory_error(est_ts, est[:, 4:], gt_ts, gt[:, 4:], **kw)
    _results_equal(tev.absolute_trajectory_error(est_ts, est[:, 4:], gt_ts, gt[:, 4:], **kw), want)
    if "offset" not in kw and "scale" not in kw:
        assert tev.ate_rmse(est_ts, est[:, 4:], gt_ts, gt[:, 4:], **kw) == want.rmse
    R, t, r = tev.horn_align(est[:20, 4:], gt[:20, 4:])
    R2, t2, r2 = jev.horn_align(est[:20, 4:], gt[:20, 4:])
    assert R.tobytes() == R2.tobytes() and t.tobytes() == t2.tobytes() and r.tobytes() == r2.tobytes()


def test_ate_rmse_pairs_greedily():
    """Two estimate stamps near one ground-truth stamp: the greedy
    association pairs it once (nearest-stamp pairing would use it twice)."""
    gt_ts = T0 + np.array([0.0, 0.1, 0.2, 0.3])
    gt = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0.0]])
    est_ts = T0 + np.array([0.0, 0.1, 0.105, 0.2, 0.3])
    est = np.array([[0, 0, 0], [1, 0, 0], [5, 5, 5], [1, 1, 0], [0, 1, 0.0]])
    want = jev.absolute_trajectory_error(est_ts, est, gt_ts, gt)
    assert want.num_pairs == 4 and want.rmse < 1e-9
    assert tev.ate_rmse(est_ts, est, gt_ts, gt) == want.rmse
    with pytest.raises(ValueError):
        tev.ate_rmse(est_ts[:1], est[:1], gt_ts, gt)


@pytest.mark.parametrize("kw", [
    dict(delta=1.0, delta_unit="s"), dict(delta=3, delta_unit="f"), dict(delta=0.05, delta_unit="m"),
    dict(delta=0.1, delta_unit="rad"), dict(delta=5.0, delta_unit="deg"),
    dict(fixed_delta=False, max_pairs=0), dict(fixed_delta=False, max_pairs=500, seed=3),
    dict(delta=0.5, offset=0.01, scale=1.1), dict(delta=2, delta_unit="f", max_pairs=20),
])
def test_rpe_equal(kw):
    gt_ts, gt = _trajectory(90, 2)
    est_ts, est = _trajectory(80, 3, jitter=0.005)
    est[:, 4:] += gt[:80, 4:]
    want = jev.relative_pose_error(est_ts, est, gt_ts, gt, **kw)
    assert want.num_pairs >= 2
    _results_equal(tev.relative_pose_error(est_ts, est, gt_ts, gt, **kw), want)


def test_rpe_errors_equal():
    ts, poses = _trajectory(10, 4)
    for args in ((ts[:1], poses[:1], ts, poses), (ts, poses, ts + 100.0, poses)):
        with pytest.raises(ValueError) as want:
            jev.relative_pose_error(*args)
        with pytest.raises(ValueError) as got:
            tev.relative_pose_error(*args)
        assert str(got.value) == str(want.value)


def _write_tum(path, ts, poses):
    with open(path, "w") as f:
        for t, p in zip(ts, poses):
            f.write(pose_to_tum_line(t, p) + "\n")


@pytest.fixture
def traj_files(tmp_path):
    gt_ts, gt = _trajectory(90, 5)
    est_ts, est = _trajectory(84, 6, jitter=0.004)
    est[:, 4:] = 0.2 * est[:, 4:] + gt[:84, 4:]
    gt_f, est_f = str(tmp_path / "gt.txt"), str(tmp_path / "est.txt")
    _write_tum(gt_f, gt_ts, gt)
    _write_tum(est_f, est_ts, est)
    return tmp_path, gt_f, est_f


def _both(capsys, argv):
    """Run both eval CLIs on ``argv`` (with ``{}`` in a path replaced by the
    package's name); returns their (rc, stdout)."""
    out = {}
    for name, main in (("port", tcli.main), ("jax", jcli.main)):
        rc = main([a.replace("{}", name) for a in argv])
        out[name] = (rc, capsys.readouterr().out)
    return out["port"], out["jax"]


@pytest.mark.parametrize("extra", [[], ["--verbose"], ["--offset", "0.01", "--scale", "1.2", "--max_difference", "0.01"]])
def test_eval_cli_ate_equal(capsys, traj_files, extra):
    d, gt_f, est_f = traj_files
    argv = ["ate", gt_f, est_f, "--save", str(d / "{}_aligned.txt"), "--save_associations", str(d / "{}_assoc.txt")]
    port, jax = _both(capsys, argv + extra)
    assert port == jax and port[0] == 0 and port[1]
    for f in ("aligned", "assoc"):
        assert (d / f"port_{f}.txt").read_bytes() == (d / f"jax_{f}.txt").read_bytes()
        assert len((d / f"port_{f}.txt").read_text().splitlines()) > 20


@pytest.mark.parametrize("extra", [[], ["--verbose"], ["--fixed_delta", "--delta", "10", "--delta_unit", "f", "--verbose"],
                                   ["--fixed_delta", "--delta", "0.5", "--offset", "0.005", "--scale", "0.9"]])
def test_eval_cli_rpe_equal(capsys, traj_files, extra):
    d, gt_f, est_f = traj_files
    port, jax = _both(capsys, ["rpe", gt_f, est_f, "--save", str(d / "{}_rpe.txt")] + extra)
    assert port == jax and port[0] == 0 and port[1]
    assert (d / "port_rpe.txt").read_bytes() == (d / "jax_rpe.txt").read_bytes()


@pytest.mark.parametrize("extra", [[], ["--first_only"], ["--offset", "0.5", "--max_difference", "0.05"]])
def test_eval_cli_associate_equal(capsys, tmp_path, extra):
    rng = np.random.default_rng(7)
    a = T0 + np.sort(rng.uniform(0, 2, 40))
    b = np.sort(a[:30] + rng.normal(0, 0.01, 30) + (0.5 if "--offset" in extra else 0.0))
    (tmp_path / "rgb.txt").write_text("# rgb\n" + "".join(f"{t:.6f} rgb/{t:.6f}.png\n" for t in a))
    (tmp_path / "depth.txt").write_text("".join(f"{t:.6f} depth/{t:.6f}.png x\n" for t in b))
    port, jax = _both(capsys, ["associate", str(tmp_path / "rgb.txt"), str(tmp_path / "depth.txt")] + extra)
    assert port == jax and port[0] == 0 and len(port[1].splitlines()) > 10


def test_eval_cli_rpe_plot_needs_fixed_delta(traj_files):
    d, gt_f, est_f = traj_files
    for main in (tcli.main, jcli.main):
        with pytest.raises(SystemExit):
            main(["rpe", gt_f, est_f, "--plot", str(d / "x.png")])


def test_draw_axes_equal():
    rng = np.random.default_rng(8)
    rgb = rng.integers(0, 256, (100, 120, 3), dtype=np.uint8)
    _, poses = _trajectory(6, 9)
    poses[:, 6] += 1.0
    cur = np.array([1.0, 0, 0, 0, 0, 0, 0])
    got = tplot.draw_axes_into_image(rgb, cur, poses, 100, 100, 60, 50, axis_length=0.3)
    want = jplot.draw_axes_into_image(rgb, cur, poses, 100, 100, 60, 50, axis_length=0.3)
    assert (got != rgb).any()
    np.testing.assert_array_equal(got, want)


def test_plot_sequence_equal(tmp_path):
    pytest.importorskip("PIL")
    rgb = np.zeros((60, 80, 3), np.uint8)
    poses = np.stack([np.array([1.0, 0, 0, 0, 0.05 * i, 0, 0]) for i in range(3)])
    frames = [(0.0, rgb), (0.1, rgb), (0.2, rgb)]
    args = (np.array([0.0, 0.1, 0.2]), poses, frames)
    got = tplot.plot_trajectory_sequence(*args, str(tmp_path / "port"), 100, 100, 40, 30)
    want = jplot.plot_trajectory_sequence(*args, str(tmp_path / "jax"), 100, 100, 40, 30)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want] and len(got) == 3
    for a, b in zip(got, want):
        assert open(a, "rb").read() == open(b, "rb").read()
