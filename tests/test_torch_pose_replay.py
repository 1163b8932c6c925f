"""The tracking step's pose rounds replayed from captured CUDA graphs.

``ops.pnp.ransac_pnp`` and ``ops.lm.refine_pose`` hand their bodies
(``pnp._ransac``, ``lm._refine``) to ``ops.replay.maybe_replayed``: on
CUDA tensors ``replay.replayed`` runs them eager at a new key, captures
them at its second call and replays them from then on; under
``torch.func.vmap`` (``MultiStreamVO``) the vmap rule of
``replay._Vmapped`` hands ``replayed`` the vmapped body
(``replay.vmapped``) on the plain ``[S, ...]`` tensors.  On the CPU they
run eagerly.

- CPU: every stage call of a few tracked frames at the main path's shapes
  (1024 correspondences, 128 RANSAC lanes, 10+10 LM iterations, coarse and
  fine rounds), its body called as ``replay._Captured`` calls it (cloned
  inputs, the keyword values of its key), equals the stage's result and the
  plain reference's (``vobench/reference/ops``: the stages as they were
  before their capture-safety repairs) to the bit.  Neither a CPU
  ``VisualOdometry`` step nor a vmapped ``MultiStreamVO`` step enters
  ``replay.replayed``.  The vmap rule's eager fallback (on the CPU, or
  under a second vmap) equals the plain vmapped body to the bit, in a
  fleet step and in a stage vmapped twice.  ``counters()`` counts four
  stage calls a step and no replay.
- On the card (marked ``gpu``): ``VisualOdometry`` over the benchmark's
  sweep (``vobench/frames.py``), with the replays, equals the same run with
  ``replay.replayed`` calling its function eagerly, to the bit in every
  record and every state leaf; so does ``VisualOdometry.run`` with a
  synchronous relaxation every 6 keyframes, whose own stages replay beside
  the rounds; and a 3-stream ``MultiStreamVO`` over the fleet's sweep
  without local BA equals the same run with ``maybe_replayed`` eager (the
  vmapped body inline, as before its replay); with BA, whose vmapped sums
  add atomically on the card, each replayed stage call equals the vmapped
  body run eagerly on its inputs.  Each step hands ``replayed`` its four
  stage calls, the fleet's as the cached vmapped bodies, and every call
  after the first two at a key is a replay.

The module imports no jax, so on a machine without jax:

    python3 -m pytest tests/test_torch_pose_replay.py -m gpu -q --noconftest
"""

import dataclasses
import functools
import json
import pathlib

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from rgbd_visualodometry_tpu_torch import VOConfig, VisualOdometry
from rgbd_visualodometry_tpu_torch.io import synthetic
from rgbd_visualodometry_tpu_torch.ops import lm, pnp, replay
from rgbd_visualodometry_tpu_torch.parallel import MultiStreamVO
from rgbd_visualodometry_tpu_torch.pipeline.frontend import POSE_STAGES, StepOutput
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
TRACKED = StepOutput._FIELDS["tracked"]


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


def _frames(n, seed=0):
    scene = synthetic.SyntheticScene(**CAM, seed=seed)
    return [scene.render(T, timestamp=i / 30.0) for i, T in enumerate(synthetic.loop_trajectory(n, step=0.02))]


def _fleet_frames(n, streams):
    """``n`` ``[S, ...]`` batches of ``streams`` scenes, one texture each."""
    seqs = [_frames(n, seed=s) for s in range(streams)]
    return [(np.stack([q[i].rgb for q in seqs]), np.stack([q[i].depth for q in seqs]),
             np.array([q[i].timestamp for q in seqs])) for i in range(n)]


def _fleet_run(cfg, seq, device):
    """``MultiStreamVO`` over the batches ``seq``: the object and every
    step's ``[S, 32]`` record."""
    fleet = MultiStreamVO(cfg, len(seq[0][2]), device=device)
    records = [fleet.step(rgb, depth, ts).packed.clone() for rgb, depth, ts in seq]
    fleet.finish()
    return fleet, records


def _assert_fleets_equal(a, b):
    (fa, ra), (fb, rb) = a, b
    assert len(ra) == len(rb) and all(_bits(x) == _bits(y) for x, y in zip(ra, rb))
    for f in dataclasses.fields(fa.states):
        assert _same(getattr(fa.states, f.name), getattr(fb.states, f.name)), f.name


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


def test_vmap_rule_eager_fallback_equals_the_vmapped_body_in_a_fleet_step(monkeypatch):
    """A 2-stream ``MultiStreamVO`` on the CPU whose batched stage calls go
    through ``replay._Vmapped`` (which the CPU path skips): its vmap rule
    runs the cached vmapped bodies eagerly, and every record and state leaf
    equals the run with the bodies inline under the vmap, to the bit."""
    cfg, seq = VOConfig(**SMALL), _fleet_frames(3, 2)
    plain = _fleet_run(cfg, seq, "cpu")
    real = replay.maybe_replayed

    def routed(fn, *args, **kw):
        if any(torch._C._functorch.is_batchedtensor(a) for a in args):
            return replay._Vmapped.apply(fn, kw, *args)
        return real(fn, *args, **kw)

    monkeypatch.setattr(replay, "maybe_replayed", routed)
    ran = []
    eager = replay._eager
    monkeypatch.setattr(replay, "_eager", lambda fn, args, kw: ran.append(fn) or eager(fn, args, kw))
    ruled = _fleet_run(cfg, seq, "cpu")
    assert [replay._bodies.get(fn) for fn in ran] == [pnp._ransac, lm._refine] * 2 * len(seq)
    assert all(bool((rec[:, TRACKED] > 0.5).all()) for rec in plain[1])
    _assert_fleets_equal(plain, ruled)


@pytest.mark.parametrize("body", [pnp._ransac, lm._refine], ids=["ransac", "lm"])
def test_vmap_rule_eager_fallback_under_a_second_vmap(monkeypatch, body):
    """A stage's four calls of two CPU frames stacked ``[2, 2, ...]`` and
    vmapped twice: through ``replay._Vmapped`` (the inner rule sees tensors
    still batched by the outer vmap and runs the vmapped body eagerly)
    equal to the body vmapped twice, to the bit."""
    calls = _spy(monkeypatch, "maybe_replayed")
    vo = VisualOdometry(VOConfig(**SMALL), device="cpu")
    for f in _frames(2):
        vo.process(f.rgb, f.depth, f.timestamp)
    mine = [(args, kw) for fn, args, kw, _ in calls if fn is body]
    assert len(mine) == 4 and all(kw == mine[0][1] for _, kw in mine)
    kw = mine[0][1]
    stacked = [torch.stack(parts).reshape(2, 2, *parts[0].shape) for parts in zip(*[args for args, _ in mine])]
    got = torch.func.vmap(torch.func.vmap(lambda *a: replay._Vmapped.apply(body, kw, *a)))(*stacked)
    want = torch.func.vmap(torch.func.vmap(functools.partial(body, **kw)))(*stacked)
    assert _same(got, want)
    assert not _same(pytree.tree_leaves(want)[0][0, 0], pytree.tree_leaves(want)[0][1, 1])  # four distinct calls


def test_pose_stage_counters_on_the_cpu():
    """On the CPU every stage call counts and none replays: four a frame
    or a fleet step, in ``counters()`` and in ``replay.tally``."""
    before = replay.tally(*POSE_STAGES)
    vo = VisualOdometry(VOConfig(**SMALL), device="cpu")
    for f in _frames(2):
        vo.process(f.rgb, f.depth, f.timestamp)
    fleet, _ = _fleet_run(VOConfig(**SMALL), _fleet_frames(2, 2), "cpu")
    for obj in (vo, fleet):
        c = obj.counters()
        assert (c["pose_stage_calls"], c["pose_stage_replays"]) == (8, 0)
    assert replay.tally(*POSE_STAGES) - before == dict(calls=16, eager=16)


# ------------------------------------------------------------------ the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the rounds are captured as CUDA graphs")
    return torch.device("cuda")


def _eager(fn, *args, **kw):
    return fn(*args, **kw)


def _sweep(n, cuda, cfg=None, streams=None):
    """The first ``n`` frames of the benchmark's single-camera sweep
    (``vobench/traffic/xyz_sweep_1.json``), rendered on the card at
    ``cfg``'s camera (``VOConfig()``'s by default); with ``streams``, the
    fleet's sweep (``xyz_sweep_8.json``, each stream at its own phase and
    texture) cut to that many streams, as ``[S, ...]`` batches."""
    from vobench import frames

    cfg = cfg or VOConfig()
    camera = dict(width=cfg.image_width, height=cfg.image_height, fx=cfg.camera_fx, fy=cfg.camera_fy,
                  cx=cfg.camera_cx, cy=cfg.camera_cy, depth_scale=cfg.camera_depth_scale)
    traffic = json.loads((ROOT / "vobench" / "traffic" / f"xyz_sweep_{1 if streams is None else 8}.json").read_text())
    if streams is not None:
        traffic["streams"] = streams
    ring = frames.Ring(20261018, traffic, camera, cuda, max_frames=n)
    seq = []
    for i in range(n):
        rgb, depth, _ = ring.frame(i, streams is not None)
        ts = ring.timestamp(i)
        seq.append((rgb.cpu().numpy(), depth.cpu().numpy(), ts if streams is None else np.full(streams, ts)))
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
    """(Named when the fleet's rounds stayed eager.)  On the card a
    ``VisualOdometry`` step hands its four stage calls to
    ``replay.replayed``, and so does a vmapped ``MultiStreamVO`` step: its
    functions are the cached vmapped bodies, its tensors the plain
    ``[S, ...]`` ones below the vmap."""
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
    batched = entered[8:]
    assert [replay._bodies.get(fn) for fn, *_ in batched] == [pnp._ransac, lm._refine] * 4
    in_dims = {vfn: dims for (_, dims), vfn in replay._vmapped.items()}
    assert len({fn for fn, *_ in batched}) == 2  # one cached body each: the coarse and fine rounds share it
    for fn, args, kw, out in batched:
        assert len(in_dims[fn]) == len(args)
        assert all(a.is_cuda and not torch._C._functorch.is_batchedtensor(a) for a in args)
        assert all(d is None or a.shape[d] == 2 for a, d in zip(args, in_dims[fn]))
        assert all(not torch._C._functorch.is_batchedtensor(o) and o.shape[0] == 2 for o in pytree.tree_leaves(out))


@pytest.mark.gpu
def test_replayed_fleet_equals_eager_fleet_gpu(cuda, monkeypatch):
    """``MultiStreamVO(VOConfig(**SMALL), 3)`` over 24 steps of the fleet's
    sweep.  Without local BA, the rounds replayed from the vmapped bodies'
    graphs equal the run with ``maybe_replayed`` eager (the bodies inline
    under the vmap), every ``[S, 32]`` record and state leaf, to the bit.
    With it, two eager runs already part at the first step after a BA
    dispatch (the vmapped BA's sums add atomically on the card), so there
    each replayed stage call is held to the vmapped body run eagerly on
    its inputs, to the bit."""
    seq = _sweep(24, cuda, VOConfig(**SMALL), streams=3)
    for ba in (False, True):
        cfg = VOConfig(**SMALL, enable_local_optimization=ba)
        runs = []
        for eager in (False, True):
            if ba and eager:
                break
            with monkeypatch.context() as m:
                if eager:
                    m.setattr(replay, "maybe_replayed", _eager)
                calls = _spy(m, "replayed")
                runs.append(_fleet_run(cfg, seq, cuda))
                torch.cuda.synchronize()
            assert len(calls) == (0 if eager else 4 * len(seq))
        (fleet, records) = runs[0]
        assert sum(int((r[:, TRACKED] > 0.5).sum()) for r in records) >= 3 * (len(seq) - 1)
        if not ba:
            _assert_fleets_equal(*runs)
            continue
        assert fleet.ba_dispatches >= 1
        for fn, args, kw, got in calls:
            assert _same(fn(*args, **kw), got), replay._bodies[fn].__name__


@pytest.mark.gpu
def test_pose_stage_counters_gpu(cuda, monkeypatch):
    """On the card, at keys new to the process, every stage call after the
    first two at its key (eager, captured) replays: ``pose_stage_replays
    == pose_stage_calls - 2 * keys``, for a fleet and for one camera."""
    monkeypatch.setattr(replay, "_graphs", {})
    monkeypatch.setattr(replay, "_seen", set())
    n, cfg = 5, VOConfig(**SMALL)
    for make in ("fleet", "single"):
        with monkeypatch.context() as m:
            calls = _spy(m, "replayed")
            if make == "fleet":
                obj, _ = _fleet_run(cfg, _fleet_frames(n, 2), cuda)
            else:
                obj = VisualOdometry(cfg, device=cuda)
                for f in _frames(n):
                    obj.process(f.rgb, f.depth, f.timestamp)
            torch.cuda.synchronize()
        keys = {(fn, tuple((a.shape, a.dtype) for a in args), tuple(sorted(kw.items()))) for fn, args, kw, _ in calls}
        c = obj.counters()
        assert len(keys) == 2 and c["pose_stage_calls"] == 4 * n == len(calls), (make, keys, c)
        assert c["pose_stage_replays"] == c["pose_stage_calls"] - 2 * len(keys), (make, c)
