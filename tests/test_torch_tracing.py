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
  steps taken, against a hand count from per-stream ``ba_step`` calls, and
  the pose stages' calls (four a step, none replayed on the CPU); and
  ``BAOutput.lm_steps`` against a plain recount of the steps ``_lm_phase``
  took.
- The fleet's BA dispatch solves only the streams its record asked for,
  as ``ba_step`` vmapped over them alone (a lone stream beside a copy of
  itself), leaves the others and its input untouched, and reads nothing
  back from the device.
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
                                 ba_lm_steps=0, pose_stage_calls=0, pose_stage_replays=0)
    for f in _seqs(1)[0][:4]:
        vo.process(f.rgb, f.depth, f.timestamp)
    n = len(steps)
    assert n == vo.ba_dispatches == 3
    assert vo.counters() == dict(ba_dispatches=n, ba_streams_solved=n, ba_streams_kept=n,
                                 ba_lm_iterations=2 * cfg.ba_iterations * n, ba_lm_steps=sum(steps),
                                 pose_stage_calls=4 * 4, pose_stage_replays=0)  # two rounds of two stages a frame


def _fleet_before_ba(n_streams):
    """A ``MultiStreamVO`` of ``n_streams`` after ``BA_LAG`` steps (no
    dispatch yet), its maps moved 1 cm so that LM takes steps; returns it
    and the per-stream states it now holds."""
    cfg = _cfg()
    seqs = _seqs(n_streams)
    vo = MultiStreamVO(cfg, n_streams, device="cpu")
    for i in range(mesh.BA_LAG):  # records still in flight: no dispatch yet
        vo.step(*_batch(seqs, i))
    assert vo.counters()["ba_dispatches"] == 0
    before = [mapstate.unstack_state(vo.states, s) for s in range(n_streams)]
    before = [s.replace(mp_pos=s.mp_pos + 0.01 * torch.randn(s.mp_pos.shape, generator=torch.Generator().manual_seed(k)))
              for k, s in enumerate(before)]
    vo.states = mapstate.stack_states(before)
    return vo, before


def _dispatch_ba(vo, asking):
    """One dispatch from a lagged record whose streams ``asking`` ask for BA
    at their reference keyframe."""
    f = frontend.StepOutput._FIELDS
    rec = torch.zeros(vo.n_streams, frontend.StepOutput.SIZE)
    rec[:, f["kf_slot"]] = vo.states.ref_kf.float()
    rec[asking, f["needs_ba"]] = 1.0
    vo._ba_pending.clear()
    vo._ba_pending.append(mesh._HostRecord(rec))
    vo._drain_ba(0)


def _batched_ba(cfg, states):
    """``ba_step`` vmapped over ``states`` at their reference keyframes:
    ``(states, lm_steps)``."""
    camera = Camera.from_config(cfg)

    def one(state, kf):
        new, out = backend.ba_step(cfg, camera, state, kf)
        return new, out.lm_steps

    stacked = mapstate.stack_states(states)
    return torch.func.vmap(one)(stacked, stacked.ref_kf.long())


def test_masked_fleet_dispatch_counts_the_kept_streams():
    """One dispatch whose lagged record asks BA of streams 0 and 2 of 3:
    those two are solved and kept, and the counted LM steps are the sum of
    their ``BAOutput.lm_steps`` from ``ba_step`` on the batch of those two.
    (A batch of 2 rounds its float sums otherwise than a batch of 1, which
    moves where LM stops: one stream's ``ba_step`` alone can count other
    steps.)  Stream 1, which would take steps of its own, is not counted."""
    vo, before = _fleet_before_ba(3)
    cfg = vo.cfg
    _dispatch_ba(vo, [0, 2])
    _, per_stream = _batched_ba(cfg, [before[0], before[2]])
    lm_steps = int(per_stream.sum())
    _, alone = backend.ba_step(cfg, Camera.from_config(cfg), before[1], before[1].ref_kf.long())
    assert lm_steps > 0 and int(alone.lm_steps) > 0
    assert vo.counters() == dict(ba_dispatches=1, ba_streams_solved=2, ba_streams_kept=2,
                                 ba_lm_iterations=2 * cfg.ba_iterations * 2, ba_lm_steps=lm_steps,
                                 pose_stage_calls=4 * mesh.BA_LAG, pose_stage_replays=0)
    left = mapstate.state_to_numpy(mapstate.unstack_state(vo.states, 1))
    for name, value in mapstate.state_to_numpy(before[1]).items():
        np.testing.assert_array_equal(left[name], value, err_msg=name)


@pytest.fixture(scope="module")
def fleet4():
    vo, before = _fleet_before_ba(4)
    return vo, before, vo._solve


def _fresh(fleet):
    """The fixture's fleet back at its states before BA, its counters at 0
    and ``_solve`` wrapped to record the leading dimension of each batch it
    receives; returns the fleet, the per-stream states and that record."""
    vo, before, solve = fleet
    vo.states = mapstate.stack_states(before)
    vo.ba_dispatches = vo.ba_streams_solved = vo.ba_streams_kept = 0
    vo._ba_lm_steps.zero_()
    sizes = []

    def spied(states, kf):
        sizes.append((states.kf_pose.shape[0], kf.shape[0]))
        return solve(states, kf)

    vo._solve = spied
    return vo, before, sizes


@pytest.mark.parametrize("asking, batch", [([1, 3], [1, 3]), ([2], [2, 2])])
def test_fleet_ba_solves_only_the_kept_streams(fleet4, asking, batch):
    """A 4-stream dispatch whose record asks BA of streams ``asking``: the
    vmapped solve receives the batch of those streams alone (a lone stream
    beside a copy of itself), their results equal ``ba_step`` vmapped over
    that batch to the bit, the other streams are left as they were, and
    the ``states`` handed to ``_ba`` are not written."""
    vo, before, sizes = _fresh(fleet4)
    handed = []
    ba = vo._ba

    def kept_args(states, kf, pred):
        handed.append((states, mapstate.state_to_numpy(states)))
        return ba(states, kf, pred)

    vo._ba = kept_args
    try:
        _dispatch_ba(vo, asking)
    finally:
        del vo._ba
    assert sizes == [(len(batch), len(batch))]
    want, lm_steps = _batched_ba(vo.cfg, [before[s] for s in batch])
    for k, s in enumerate(asking):
        got = mapstate.state_to_numpy(mapstate.unstack_state(vo.states, s))
        for name, value in mapstate.state_to_numpy(mapstate.unstack_state(want, k)).items():
            np.testing.assert_array_equal(got[name], value, err_msg=f"stream {s}: {name}")
    for s in sorted(set(range(4)) - set(asking)):
        got = mapstate.state_to_numpy(mapstate.unstack_state(vo.states, s))
        for name, value in mapstate.state_to_numpy(before[s]).items():
            np.testing.assert_array_equal(got[name], value, err_msg=f"stream {s}: {name}")
    (states, pre), = handed
    for name, value in mapstate.state_to_numpy(states).items():
        np.testing.assert_array_equal(value, pre[name], err_msg=name)
    assert not np.array_equal(mapstate.state_to_numpy(vo.states)["mp_pos"], pre["mp_pos"])  # BA moved points
    n = len(asking)
    assert vo.counters() == dict(ba_dispatches=1, ba_streams_solved=len(batch), ba_streams_kept=n,
                                 ba_lm_iterations=2 * vo.cfg.ba_iterations * n, ba_lm_steps=int(lm_steps[:n].sum()),
                                 pose_stage_calls=4 * mesh.BA_LAG, pose_stage_replays=0)


def test_fleet_ba_with_no_kept_stream_runs_no_solve(fleet4):
    """``_ba`` with an all-False ``pred`` (a rank whose own streams asked
    for nothing) runs no solve and returns the states unchanged."""
    vo, before, sizes = _fresh(fleet4)
    states = vo.states
    pre = mapstate.state_to_numpy(states)
    out = vo._ba(states, states.ref_kf.long(), torch.zeros(4, dtype=torch.bool))
    assert sizes == []
    for name, value in mapstate.state_to_numpy(out).items():
        np.testing.assert_array_equal(value, pre[name], err_msg=name)
    assert vo.counters()["ba_streams_solved"] == 0 and vo.counters()["ba_lm_steps"] == 0


READS = ("nonzero", "item", "cpu", "tolist", "numpy", "__bool__", "__int__", "__float__")


def test_fleet_ba_dispatch_reads_nothing_back(fleet4, monkeypatch):
    """The dispatch takes the kept rows from the host's record: inside the
    ``_ba`` that ``_drain_ba`` calls, no tensor is read back to the host
    (``nonzero``, ``item``, ``cpu``, ``tolist``, ``numpy``, truth or number
    conversion).  The same reads are allowed again once it returns."""
    vo, _, _ = _fresh(fleet4)
    ba, seen = vo._ba, []

    def guarded(*args):
        def refuse(name):
            def read(*a, **k):
                seen.append(name)
                raise AssertionError(f"{name} read a tensor back inside the BA dispatch")
            return read

        with monkeypatch.context() as m:
            for name in READS:
                m.setattr(torch.Tensor, name, refuse(name))
            m.setattr(torch, "nonzero", refuse("torch.nonzero"))
            m.setattr(torch, "argwhere", refuse("torch.argwhere"))
            return ba(*args)

    vo._ba = guarded
    try:
        _dispatch_ba(vo, [0, 3])
    finally:
        del vo._ba
    assert seen == [] and vo.counters()["ba_streams_solved"] == 2


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
