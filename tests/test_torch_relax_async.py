"""Online loop closure with ``relax_async`` (the default) end to end in the
port: the faulted 64-frame circuit of ``tests/test_torch_relax_online.py``
at 320x240, relaxed every 6 keyframes on a worker thread (at most one in
flight, computed from a clone of the state and applied to the live state
when done), and once more synchronously at run close.

The reference's ``test_async_relax_does_not_stall_frame_loop`` also bounds
frame times; these tests keep its correctness assertions and carry no
wall-clock limit, which the test workers' load could break.

- Gated: the frame stream waits for the relaxation in flight before it
  hands over the next frame, so every relaxation lands on the frame after
  the one it was started on.  Where an ungated relaxation lands depends on
  thread timing, and the ATE with it.  Asserted: every frame tracked, at
  least 2 relaxations on the worker, each consumed, plus the final one,
  the ATE below 5 cm, the trajectory file equal to the corrected in-memory
  poses (1e-6), no worker left after the run.
- Ungated: what holds whenever relaxations land: every frame tracked, at
  least one relaxation, finite poses, the file equal to memory.
- Error path: the frame stream raises while a relaxation is held in flight
  (``compute_relaxation`` gated by an ``Event``).  As the JAX package does
  (``pipeline/system.py:373-381``), ``run`` waits for it, applies it to the
  state, corrects the results and rewrites the trajectory file before the
  error propagates; the JAX package's own ``run`` is driven through the
  same sequence of events with its tracking step and relaxation stubbed
  (nothing compiled) and counts and rewrites the same way.
"""

import threading
import types

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from torch_parity import faulted_depth, ground_truth, loop_frames, relax_cfgs
from rgbd_visualodometry_tpu_torch import VOConfig, VisualOdometry
from rgbd_visualodometry_tpu_torch.evaltools import ate_rmse
from rgbd_visualodometry_tpu_torch.io.trajectory import read_trajectory

N_FRAMES = 64


def _run(tmp_path, gated: bool):
    frames = loop_frames(N_FRAMES, step=0.03)
    cfg, _ = relax_cfgs(triangulation_batch=128, ba_max_points=1024, relax_every_kf=6,
                        relax_loop_gap_s=1.0, relax_async=True)
    assert cfg.relax_async
    vo = VisualOdometry(cfg, device="cpu")
    started = []
    start = vo._start_async_relax

    def counted_start():
        started.append(len(vo.results))
        start()

    vo._start_async_relax = counted_start

    def stream():
        for i, f in enumerate(frames):
            if gated and vo._relax_thread is not None:
                vo._relax_thread.join()
            yield f.rgb, faulted_depth(i, N_FRAMES, f.depth), f.timestamp

    traj = str(tmp_path / "traj.txt")
    results = vo.run(stream(), trajectory_path=traj)
    assert len(results) == N_FRAMES and all(r.tracked for r in results)
    assert vo._relax_thread is None  # no worker outlives the run
    file_ts, file_poses = read_trajectory(traj)
    entries = vo._trajectory_entries()
    assert len(file_ts) == len(entries) == N_FRAMES
    np.testing.assert_allclose(file_poses, np.asarray([p for _, p in entries]), atol=1e-6)
    est = np.asarray([r.pose_w_c for r in results])
    assert np.isfinite(est).all()
    gt_ts, gt_xyz = ground_truth(frames)
    return vo, started, ate_rmse([r.timestamp for r in results], est[:, 4:7], gt_ts, gt_xyz)


def test_async_relax_lands_and_corrects(tmp_path):
    vo, started, ate = _run(tmp_path, gated=True)
    assert len(started) >= 2
    assert vo.num_auto_relaxes == len(started) + 1  # each worker's relaxation, then the final one
    assert ate < 0.05, f"post-relax ATE {ate * 100:.2f} cm"


def test_async_relax_ungated(tmp_path):
    vo, started, _ = _run(tmp_path, gated=False)
    assert vo.num_auto_relaxes >= 1 and len(started) >= 1


class _Unplugged(RuntimeError):
    pass


def _gated(real):
    """``compute_relaxation`` that waits for ``release`` before it computes;
    ``started`` is set when a relaxation is in flight."""
    started, release = threading.Event(), threading.Event()

    def compute(*a, **kw):
        started.set()
        assert release.wait(60), "the relaxation was never released"
        return real(*a, **kw)

    return compute, started, release


def _failing_stream(frames, vo, started, release, seen):
    """Yield frames until a relaxation is in flight, then raise (releasing
    the worker as the error leaves), recording the live state and results."""
    for f in frames:
        if started.is_set() and vo._relax_thread is not None:
            seen.append((pytree.tree_map(torch.clone, vo.state) if isinstance(vo, VisualOdometry) else None,
                         [r.pose_w_c.copy() for r in vo.results]))
            release.set()
            raise _Unplugged("camera unplugged")
        yield f


def test_error_path_applies_the_relaxation_in_flight(tmp_path, monkeypatch):
    from rgbd_visualodometry_tpu_torch.io import synthetic
    from rgbd_visualodometry_tpu_torch.pipeline import globalopt

    cfg = VOConfig(
        image_width=128, image_height=96, camera_fx=100.0, camera_fy=100.0, camera_cx=64.0, camera_cy=48.0,
        number_of_features=64, level_pyramid=2, edge_threshold=16, max_keyframes=8, max_mappoints=512,
        max_obs_per_mappoint=4, pnp_max_points=128, triangulation_batch=64, ransac_hypotheses=16,
        tracking_map_min_points=10, packed_matching=True, enable_local_optimization=False,
        relax_every_kf=1, relax_async=True,
    )
    seq = synthetic.generate_sequence(
        14, scene=synthetic.SyntheticScene(width=128, height=96, fx=100.0, fy=100.0, cx=64.0, cy=48.0, cell_size=0.12),
        step_t=(0.03, 0.004, 0.0), step_r=(0.0, 0.0, 0.006))
    real = globalopt.compute_relaxation
    # an acting relaxation without loop evidence: the short run has none
    compute, started, release = _gated(lambda *a, **kw: real(*a, **dict(kw, require_loop=False)))
    monkeypatch.setattr(globalopt, "compute_relaxation", compute)
    rlxs = []
    finish = VisualOdometry._finish_async_relax

    def spy_finish(self, wait=False):
        rlx = finish(self, wait)
        if rlx is not None:
            rlxs.append(rlx)
        return rlx

    monkeypatch.setattr(VisualOdometry, "_finish_async_relax", spy_finish)
    vo = VisualOdometry(cfg, device="cpu")
    seen = []
    traj = str(tmp_path / "traj.txt")
    with pytest.raises(_Unplugged):
        vo.run(_failing_stream(((f.rgb, f.depth, f.timestamp) for f in seq), vo, started, release, seen),
               trajectory_path=traj)
    assert len(seen) == 1 and len(rlxs) == 1 and vo._relax_thread is None
    assert vo.num_auto_relaxes == 1
    state_at_error, poses_at_error = seen[0]
    rlx = rlxs[0]
    assert rlx.report.kf_ts.size >= 2
    want = globalopt.apply_relaxation(state_at_error, rlx)
    assert torch.equal(vo.state.kf_pose, want.kf_pose) and not torch.equal(want.kf_pose, state_at_error.kf_pose)
    file_ts, file_poses = read_trajectory(traj)
    entries = vo._trajectory_entries()
    assert len(file_ts) == len(entries) == len(poses_at_error) >= 2
    np.testing.assert_allclose(file_poses, np.asarray([p for _, p in entries]), atol=1e-6)
    assert np.abs(file_poses - np.asarray(poses_at_error)).max() > 1e-6  # the corrected poses, rewritten
    assert _jax_error_path(tmp_path, monkeypatch) == (vo.num_auto_relaxes, 1, True)


def _jax_error_path(tmp_path, monkeypatch):
    """The JAX package's ``run`` through the same events: a stub tracking
    step (every frame a tracked keyframe), a gated stub relaxation that
    moves every pose 1 cm.  Returns (num_auto_relaxes, apply calls, whether
    the trajectory file holds the corrected in-memory poses)."""
    import jax.numpy as jnp

    from rgbd_visualodometry_tpu.config import VOConfig as JaxVOConfig
    from rgbd_visualodometry_tpu.pipeline import frontend, globalopt
    from rgbd_visualodometry_tpu.pipeline.system import VisualOdometry as JaxVO

    record = np.zeros(32, np.float32)
    record[[0, 7]] = 1.0  # identity poses
    record[[14, 15, 16]] = 1.0  # tracked, TRACKING, keyframe
    report = types.SimpleNamespace(kf_ts=np.zeros(2), num_loop_edges=1, num_appearance_edges=0, max_correction_m=0.01)
    compute, started, release = _gated(lambda *a, **kw: types.SimpleNamespace(report=report))
    applied = []
    monkeypatch.setattr(globalopt, "compute_relaxation", compute)
    monkeypatch.setattr(globalopt, "apply_relaxation", lambda state, rlx: applied.append(rlx) or state)
    monkeypatch.setattr(globalopt, "correct_trajectory", lambda rep, ts, poses: poses + [0, 0, 0, 0, 0.01, 0, 0])
    vo = JaxVO(JaxVOConfig(image_width=32, image_height=24, max_keyframes=4, max_mappoints=64,
                           enable_local_optimization=False, relax_every_kf=1, relax_async=True))
    vo._step = lambda state, frame: (state, frontend.StepOutput(packed=jnp.asarray(record)))
    frames = [(np.zeros((24, 32, 3), np.uint8), np.zeros((24, 32), np.uint16), 0.1 * i) for i in range(12)]
    traj = str(tmp_path / "jax_traj.txt")
    with pytest.raises(_Unplugged):
        vo.run(_failing_stream(frames, vo, started, release, []), trajectory_path=traj)
    _, file_poses = read_trajectory(traj)
    memory = np.asarray([p for _, p in vo._trajectory_entries()])
    return vo.num_auto_relaxes, len(applied), bool(len(file_poses) == len(memory) and np.allclose(file_poses, memory, atol=1e-6)
                                                   and np.allclose(memory[:, 4], 0.01))
