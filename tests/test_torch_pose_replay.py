"""The tracking step's pose rounds replayed from captured CUDA graphs.

``ops.pnp.ransac_pnp`` and ``ops.lm.refine_pose`` hand their bodies
(``pnp._ransac``, ``lm._refine``) to ``ops.replay.replayed`` when their
tensors are CUDA tensors outside ``torch.func.vmap``
(``replay.maybe_replayed``): eager at a new key, captured at its second
call, replayed from then on.  On the CPU and under vmap they run eagerly.

- CPU: every stage call of a few tracked frames at the main path's shapes
  (1024 correspondences, 128 RANSAC lanes, 10+10 LM iterations, coarse and
  fine rounds), its body called as ``replay._Captured`` calls it (cloned
  inputs, the keyword values of its key), equals the stage's result and the
  plain reference's (``vobench/reference/ops``: the stages as they were
  before their capture-safety repairs) to the bit.  Neither a CPU
  ``VisualOdometry`` step nor a vmapped ``MultiStreamVO`` step enters
  ``replay.replayed``.
- On the card (marked ``gpu``): ``VisualOdometry`` over the benchmark's
  sweep (``vobench/frames.py``), with the replays, equals the same run with
  ``replay.replayed`` calling its function eagerly, to the bit in every
  record and every state leaf; so does ``VisualOdometry.run`` with a
  synchronous relaxation every 6 keyframes, whose own stages replay beside
  the rounds.

The module imports no jax, so on a machine without jax:

    python3 -m pytest tests/test_torch_pose_replay.py -m gpu -q --noconftest
"""

import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from rgbd_visualodometry_tpu_torch import VOConfig, VisualOdometry
from rgbd_visualodometry_tpu_torch.io import synthetic
from rgbd_visualodometry_tpu_torch.ops import lm, pnp, replay
from vobench.reference.ops import lm as ref_lm
from vobench.reference.ops import pnp as ref_pnp

ROOT = pathlib.Path(__file__).resolve().parents[1]
CAM = dict(width=320, height=240, fx=258.6, fy=258.2, cx=159.3, cy=127.6)
# the pose rounds at the main path's shapes (VOConfig's): 1024 PnP points,
# 128 hypotheses, 10 LM iterations a round; the image and the map smaller
SMALL = dict(image_width=320, image_height=240, camera_fx=258.6, camera_fy=258.2, camera_cx=159.3, camera_cy=127.6,
             number_of_features=300, level_pyramid=4, max_keyframes=32, max_mappoints=4096, max_obs_per_mappoint=8,
             triangulation_batch=128, ba_max_poses=8, ba_max_points=1024)
REFERENCE = {pnp._ransac: ref_pnp.ransac_pnp, lm._refine: ref_lm.refine_pose}


def _bits(x) -> bytes:
    return x.detach().cpu().contiguous().numpy().tobytes()


def _same(a, b) -> bool:
    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and x.dtype == y.dtype and _bits(x) == _bits(y) for x, y in zip(la, lb))


def _spy(monkeypatch, name):
    """Record ``(fn, cloned args, kw, result)`` of every call of
    ``replay.<name>`` and pass it on."""
    real, calls = getattr(replay, name), []

    def spied(fn, *args, **kw):
        clones = [a.clone() for a in args]
        out = real(fn, *args, **kw)
        calls.append((fn, clones, kw, out))
        return out

    monkeypatch.setattr(replay, name, spied)
    return calls


def _frames(n):
    scene = synthetic.SyntheticScene(**CAM)
    return [scene.render(T, timestamp=i / 30.0) for i, T in enumerate(synthetic.loop_trajectory(n, step=0.02))]


@pytest.mark.parametrize("coarse", [{}, dict(coarse_ransac_hypotheses=64, coarse_pose_ba_iterations=5)],
                         ids=["shared_key", "coarse_key"])
def test_bodies_as_captured_equal_the_stages_and_the_reference(monkeypatch, coarse):
    cfg = VOConfig(**SMALL, **coarse)
    assert (cfg.pnp_max_points, cfg.ransac_hypotheses, cfg.pose_ba_iterations) == (1024, 128, 10)
    calls = _spy(monkeypatch, "maybe_replayed")
    vo = VisualOdometry(cfg, device="cpu")
    for f in _frames(3):
        res = vo.process(f.rgb, f.depth, f.timestamp)
    assert res.tracked and res.stats["num_inliers"] > 50, res.stats
    assert [fn for fn, *_ in calls] == [pnp._ransac, lm._refine] * 6  # two rounds a frame
    keys = {(fn, tuple(sorted(kw.items()))) for fn, _, kw, _ in calls}
    assert len(keys) == (4 if coarse else 2)
    for fn, args, kw, got in calls:
        assert all(a.shape[0] == 1024 for a in args[1:6]), [tuple(a.shape) for a in args]
        as_captured = fn(*[a.clone() for a in args], **kw)
        assert _same(as_captured, got), fn.__name__
        assert _same(REFERENCE[fn](*args, **kw), got), fn.__name__


def test_cpu_and_vmapped_steps_do_not_enter_replayed(monkeypatch):
    from rgbd_visualodometry_tpu_torch.parallel import MultiStreamVO

    entered = _spy(monkeypatch, "replayed")
    real, batched = replay.maybe_replayed, []

    def noting(fn, *args, **kw):
        batched.append(any(torch._C._functorch.is_batchedtensor(a) for a in args))
        return real(fn, *args, **kw)

    monkeypatch.setattr(replay, "maybe_replayed", noting)
    frames = _frames(2)
    vo = VisualOdometry(VOConfig(**SMALL), device="cpu")
    for f in frames:
        vo.process(f.rgb, f.depth, f.timestamp)
    assert batched == [False] * 8
    fleet = MultiStreamVO(VOConfig(**SMALL), 2, device="cpu")
    for f in frames:
        fleet.step(np.stack([f.rgb] * 2), np.stack([f.depth] * 2), np.array([f.timestamp] * 2))
    fleet.finish()
    assert batched[8:] == [True] * 8  # every stage call of the two vmapped steps
    assert entered == []


# ------------------------------------------------------------------ the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the rounds are captured as CUDA graphs")
    return torch.device("cuda")


def _eager(fn, *args, **kw):
    return fn(*args, **kw)


def _sweep(n, cuda):
    """The first ``n`` frames of the benchmark's single-camera sweep
    (``vobench/traffic/xyz_sweep_1.json``), rendered on the card."""
    from vobench import frames

    cfg = VOConfig()
    camera = dict(width=cfg.image_width, height=cfg.image_height, fx=cfg.camera_fx, fy=cfg.camera_fy,
                  cx=cfg.camera_cx, cy=cfg.camera_cy, depth_scale=cfg.camera_depth_scale)
    traffic = json.loads((ROOT / "vobench" / "traffic" / "xyz_sweep_1.json").read_text())
    ring = frames.Ring(20261018, traffic, camera, cuda, max_frames=n)
    seq = []
    for i in range(n):
        rgb, depth, _ = ring.frame(i, False)
        seq.append((rgb.cpu().numpy(), depth.cpu().numpy(), ring.timestamp(i)))
    return seq


def _assert_runs_equal(a, b):
    assert len(a.results) == len(b.results)
    for i, (x, y) in enumerate(zip(a.results, b.results)):
        assert (x.tracked, x.fsm, x.is_keyframe, x.stats) == (y.tracked, y.fsm, y.is_keyframe, y.stats), i
        assert x.pose_w_c.tobytes() == y.pose_w_c.tobytes() and x.pose_c_w.tobytes() == y.pose_c_w.tobytes(), i
    for f in dataclasses.fields(a.state):
        assert _same(getattr(a.state, f.name), getattr(b.state, f.name)), f.name


@pytest.mark.gpu
def test_replayed_rounds_equal_eager_rounds_gpu(cuda, monkeypatch):
    """24 frames of the sweep at ``VOConfig()`` (BA after every keyframe):
    the rounds replayed equal the rounds eager, every record and state leaf."""
    seq = _sweep(24, cuda)
    runs = []
    for patched in (False, True):
        with monkeypatch.context() as m:
            if patched:
                m.setattr(replay, "replayed", _eager)
            calls = _spy(m, "maybe_replayed")
            vo = VisualOdometry(VOConfig(), device=cuda)
            for rgb, depth, ts in seq:
                vo.process_async(rgb, depth, ts)
                vo.drain(3)
            vo.drain(0)
            torch.cuda.synchronize()
        assert len(calls) == 4 * len(seq)
        runs.append(vo)
    assert sum(r.tracked for r in runs[0].results) >= len(seq) - 1 and runs[0].ba_dispatches >= 1
    _assert_runs_equal(*runs)


@pytest.mark.gpu
def test_replayed_rounds_beside_the_relaxation_gpu(cuda, monkeypatch):
    """``VisualOdometry.run`` over 60 frames of the sweep, relaxing
    synchronously every 6 keyframes (the relaxation's stages replay from
    their own graphs): equal to the same run with every replay eager."""
    seq = _sweep(60, cuda)
    cfg = VOConfig(relax_every_kf=6, relax_async=False, relax_loop_gap_s=1.0)
    runs = []
    for patched in (False, True):
        with monkeypatch.context() as m:
            if patched:
                m.setattr(replay, "replayed", _eager)
            calls = _spy(m, "replayed")
            vo = VisualOdometry(cfg, device=cuda)
            vo.run(iter(seq))
            torch.cuda.synchronize()
        runs.append((vo, calls))
    (vo, calls), (eager, _) = runs
    fns = {fn for fn, *_ in calls}
    assert {pnp._ransac, lm._refine} < fns, fns  # the rounds and a relaxation stage
    assert vo.num_auto_relaxes >= 2
    _assert_runs_equal(vo, eager)


@pytest.mark.gpu
def test_only_the_single_stream_replays_gpu(cuda, monkeypatch):
    """On the card a ``VisualOdometry`` step hands its four stage calls to
    ``replay.replayed``; a vmapped ``MultiStreamVO`` step hands none."""
    from rgbd_visualodometry_tpu_torch.parallel import MultiStreamVO

    entered = _spy(monkeypatch, "replayed")
    frames = _frames(2)
    vo = VisualOdometry(VOConfig(**SMALL), device=cuda)
    for f in frames:
        vo.process(f.rgb, f.depth, f.timestamp)
    assert [fn for fn, *_ in entered] == [pnp._ransac, lm._refine] * 4
    fleet = MultiStreamVO(VOConfig(**SMALL), 2, device=cuda)
    for f in frames:
        fleet.step(np.stack([f.rgb] * 2), np.stack([f.depth] * 2), np.array([f.timestamp] * 2))
    fleet.finish()
    torch.cuda.synchronize()
    assert len(entered) == 8
