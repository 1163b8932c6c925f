"""The port's own trace spans (``utils.profiling.span``, the ``vo.*`` ranges
opened where each layer's work runs) and its BA work counters
(``counters()``), on the CPU at 160x120.

- While no profiler records, a span is one shared null context.
- Under ``torch.profiler``, one ``VisualOdometry`` frame and one 2-stream
  ``MultiStreamVO`` step (the vmapped path) open every span, nested as the
  layers nest, a BA dispatch included.
- Records, poses and every state leaf are equal to the bit with the
  profiler on and off.
- ``counters()``: dispatches, streams solved and kept, LM iterations and
  steps taken, against a hand count from per-stream ``ba_step`` calls; and
  ``BAOutput.lm_steps`` against a plain recount of the steps ``_lm_phase``
  took.
"""

import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rgbd_visualodometry_tpu_torch import VOConfig, VisualOdometry, mapstate
from rgbd_visualodometry_tpu_torch.camera import Camera
from rgbd_visualodometry_tpu_torch.io import synthetic
from rgbd_visualodometry_tpu_torch.parallel import MultiStreamVO, mesh
from rgbd_visualodometry_tpu_torch.pipeline import backend, frontend
from rgbd_visualodometry_tpu_torch.utils import profiling, span, spanned

# every keyframe asks for BA: a BA dispatch on every frame after the first
TINY = dict(image_width=160, image_height=120, camera_fx=129.3, camera_fy=129.1, camera_cx=79.6, camera_cy=63.8,
            number_of_features=150, level_pyramid=3, max_keyframes=8, max_mappoints=1024, max_obs_per_mappoint=4,
            pnp_max_points=128, triangulation_batch=64, ransac_hypotheses=16, ba_max_poses=4, ba_max_points=256,
            packed_matching=True, keyframe_translation=0.0, keyframe_rotation=0.0, ba_bf16=False)
FRAMES = 6
S = 2

# span -> the innermost span around it; the record's read and BA run in
# ``drain`` for one stream and inside ``step`` for the fleet
NESTING = {"vo.step": None, "vo.orb": "vo.step", "vo.fast_nms": "vo.orb", "vo.match": "vo.step",
           "vo.pose_round": "vo.step", "vo.pose.ransac": "vo.pose_round", "vo.pose.lm": "vo.pose_round",
           "vo.map_update": "vo.step", "vo.readback": None, "vo.ba": None, "vo.ba.build": "vo.ba",
           "vo.ba.lm": "vo.ba"}
PER_STEP = {"vo.pose_round": 2, "vo.pose.ransac": 2, "vo.pose.lm": 2, "vo.ba.lm": 2}


def _cfg():
    return VOConfig(**TINY)


def _seqs(n_streams):
    return [synthetic.generate_sequence(FRAMES, scene=synthetic.SyntheticScene(
        width=160, height=120, fx=129.3, fy=129.1, cx=79.6, cy=63.8, seed=s)) for s in range(n_streams)]


def _batch(seqs, i):
    return (np.stack([q[i].rgb for q in seqs]), np.stack([q[i].depth for q in seqs]),
            np.array([q[i].timestamp for q in seqs]))


def _program_spans(prof):
    """``[(name, parent)]`` of the ``vo.*`` ranges in a profile, in start
    order, the parent the innermost ``vo.*`` range around each."""
    ranges = sorted((e.start_ns(), -e.end_ns(), e.name()) for e in prof.profiler.kineto_results.events()
                    if e.name().startswith("vo."))
    out, stack = [], []
    for s0, neg_end, name in ranges:
        while stack and stack[-1][0] <= s0:
            stack.pop()
        out.append((name, stack[-1][1] if stack else None))
        stack.append((-neg_end, name))
    return out


def _run(kind, profiled):
    """``FRAMES`` frames (single) or steps of ``S`` streams (fleet), each
    under its own profiler where ``profiled``; returns the records, the
    state, the counters and the last frame's spans."""
    cfg = _cfg()
    seqs = _seqs(1 if kind == "single" else S)
    vo = VisualOdometry(cfg, device="cpu") if kind == "single" else MultiStreamVO(cfg, S, device="cpu")
    records, spans = [], None
    for i in range(FRAMES):
        with profile(activities=[ProfilerActivity.CPU]) if profiled else contextlib.nullcontext() as prof:
            if kind == "single":
                f = seqs[0][i]
                r = vo.process(f.rgb, f.depth, f.timestamp)
                records.append(np.concatenate([r.pose_c_w, r.pose_w_c, [r.tracked, r.fsm, r.is_keyframe],
                                               [r.stats[k] for k in sorted(r.stats)]]))
            else:
                records.append(vo.step(*_batch(seqs, i)).packed.numpy().copy())
        if profiled:
            spans = _program_spans(prof)
    state = vo.state if kind == "single" else vo.states
    return np.stack(records), mapstate.state_to_numpy(state), vo.counters(), spans


@pytest.fixture(scope="module", params=["single", "fleet"])
def runs(request):
    return request.param, _run(request.param, False), _run(request.param, True)


def test_span_is_one_null_context_while_no_profiler_records():
    off = span("vo.a")
    assert off is span("vo.b") is profiling._OFF
    with off:
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = span("vo.a")
        assert on is not off
        with on:
            torch.ones(2) + 1
    assert span("vo.a") is off
    assert [n for n, _ in _program_spans(prof)] == ["vo.a"]

    @spanned("vo.f")
    def f(x):
        """doc"""
        return x + 1

    assert f(1) == 2 and f.__name__ == "f" and f.__doc__ == "doc"


def test_every_span_nests_as_the_layers_do(runs):
    kind, _, (_, _, counters, spans) = runs
    want = dict(NESTING)
    if kind == "fleet":  # the lagged record's read and the masked BA run inside the step
        want.update({"vo.readback": "vo.step", "vo.ba": "vo.step"})
    assert counters["ba_dispatches"] >= 2
    assert {n for n, _ in spans} == set(want), spans
    for name, parent in spans:
        assert parent == want[name], (name, parent)
    for name in want:
        assert sum(n == name for n, _ in spans) == PER_STEP.get(name, 1), (name, spans)


def test_the_profiler_changes_no_bit(runs):
    _, (rec0, state0, c0, _), (rec1, state1, c1, _) = runs
    np.testing.assert_array_equal(rec0, rec1)
    assert set(state0) == set(state1)
    for name in state0:
        np.testing.assert_array_equal(state0[name], state1[name], err_msg=name)
    assert c0 == c1 and c0["ba_dispatches"] >= 2


def test_single_stream_counters(monkeypatch):
    cfg = _cfg()
    steps = []
    real = backend.ba_step

    def counted(*args, **kwargs):
        state, out = real(*args, **kwargs)
        steps.append(int(out.lm_steps))
        return state, out

    monkeypatch.setattr(backend, "ba_step", counted)
    vo = VisualOdometry(cfg, device="cpu")
    assert vo.counters() == dict(ba_dispatches=0, ba_streams_solved=0, ba_streams_kept=0, ba_lm_iterations=0,
                                 ba_lm_steps=0)
    for f in _seqs(1)[0][:4]:
        vo.process(f.rgb, f.depth, f.timestamp)
    n = len(steps)
    assert n == vo.ba_dispatches == 3
    assert vo.counters() == dict(ba_dispatches=n, ba_streams_solved=n, ba_streams_kept=n,
                                 ba_lm_iterations=2 * cfg.ba_iterations * n, ba_lm_steps=sum(steps))


def test_masked_fleet_dispatch_counts_the_kept_streams():
    """One dispatch whose lagged record asks BA of streams 0 and 2 of 3:
    every stream is solved, two are kept, and the counted LM steps are the
    sum of those two streams' ``BAOutput.lm_steps`` from ``ba_step`` on the
    same batch of 3.  (A batch of 3 rounds its float sums otherwise than a
    batch of 1, which moves where LM stops: one stream's ``ba_step`` alone
    can count other steps.)"""
    cfg = _cfg()
    seqs = _seqs(3)
    vo = MultiStreamVO(cfg, 3, device="cpu")
    for i in range(mesh.BA_LAG):  # records still in flight: no dispatch yet
        vo.step(*_batch(seqs, i))
    assert vo.counters()["ba_dispatches"] == 0
    before = [mapstate.unstack_state(vo.states, s) for s in range(3)]
    # the map moved 1 cm, so that LM takes steps
    before = [s.replace(mp_pos=s.mp_pos + 0.01 * torch.randn(s.mp_pos.shape, generator=torch.Generator().manual_seed(k)))
              for k, s in enumerate(before)]
    vo.states = mapstate.stack_states(before)
    f = frontend.StepOutput._FIELDS
    rec = torch.zeros(3, frontend.StepOutput.SIZE)
    rec[:, f["kf_slot"]] = vo.states.ref_kf.float()
    rec[[0, 2], f["needs_ba"]] = 1.0
    vo._ba_pending.clear()
    vo._ba_pending.append(mesh._HostRecord(rec))
    vo._drain_ba(0)
    camera = Camera.from_config(cfg)
    batched = torch.func.vmap(lambda st, kf: backend.ba_step(cfg, camera, st, kf)[1].lm_steps)
    per_stream = batched(mapstate.stack_states(before), torch.stack([s.ref_kf for s in before]).long()).tolist()
    lm_steps = per_stream[0] + per_stream[2]
    assert lm_steps > 0 and per_stream[1] > 0
    assert vo.counters() == dict(ba_dispatches=1, ba_streams_solved=3, ba_streams_kept=2,
                                 ba_lm_iterations=2 * cfg.ba_iterations * 2, ba_lm_steps=lm_steps)
    left = mapstate.state_to_numpy(mapstate.unstack_state(vo.states, 1))
    for name, value in mapstate.state_to_numpy(before[1]).items():
        np.testing.assert_array_equal(left[name], value, err_msg=name)


def test_ba_lm_steps_is_a_recount_of_the_steps_taken():
    """``BAOutput.lm_steps`` against the iterations ``k`` at which the
    ``_lm_phase`` iterate after ``k`` iterations differs from the one after
    ``k - 1``, both rounds (the CPU repeats itself to the bit)."""
    cfg = _cfg()
    vo = VisualOdometry(cfg, device="cpu")
    for f in _seqs(1)[0][:3]:
        vo.process(f.rgb, f.depth, f.timestamp)
    state = vo.state
    state = state.replace(mp_pos=state.mp_pos + 0.01 * torch.randn(state.mp_pos.shape,
                                                                   generator=torch.Generator().manual_seed(3)))
    kf = int(state.ref_kf)
    camera = Camera.from_config(cfg)
    _, out = backend.ba_step(cfg, camera, state, kf)

    prob = backend.build_problem(cfg, state, kf)
    poses, pts = state.kf_pose[prob.widx], state.mp_pos[prob.pidx]
    recount = 0
    for mask, delta in ((prob.o_valid, cfg.huber_delta), (None, None)):
        if mask is None:  # round 2: round 1's result, its chi2 outliers out
            mask = prob.o_valid & ~(backend._chi2(prob, poses, pts, camera) > cfg.chi2_th)
        its = [backend._lm_phase(cfg, camera, prob, poses, pts, mask, k, delta)[:2]
               for k in range(cfg.ba_iterations + 1)]
        recount += sum(not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])) for a, b in zip(its, its[1:]))
        poses, pts = its[-1]
    assert recount >= 3
    assert int(out.lm_steps) == recount
