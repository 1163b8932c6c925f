"""The frozen reference against the port's CPU path (plain kernels there too):
at 160x120 over a few frames, every record and state leaf equal, a BA
dispatch equal, and a loop-closure relaxation, its apply and its trajectory
correction equal."""

import dataclasses

import numpy as np
import torch

from rgbd_visualodometry_tpu_torch.camera import Camera
from rgbd_visualodometry_tpu_torch.config import VOConfig
from rgbd_visualodometry_tpu_torch import mapstate
from rgbd_visualodometry_tpu_torch.pipeline import backend, frontend, globalopt
from vobench import check, frames
from vobench.tests.tiny import CAMERA, TINY

SWEEP = dict(streams=1, period=12, fps=30.0, peak_step_m=[0.012, 0.002, 0.0], peak_yaw_rad=0.003)


def _leaves(state):
    return {f.name: getattr(state, f.name) for f in dataclasses.fields(state)}


def test_reference_follows_the_port_on_the_cpu():
    cfg = VOConfig().replace(**TINY)
    ref = check.Reference(TINY, "cpu")
    ring = frames.Ring(11, SWEEP, CAMERA, "cpu", max_frames=16)
    cam = Camera.from_config(cfg)
    state = mapstate.init_state(cfg, 3, "cpu")
    rstate = ref.init_state(3, 0, batched=False)
    assert all(torch.equal(a, b) for a, b in zip(_leaves(state).values(), _leaves(rstate).values()))
    keyframes = 0
    for i in range(8):
        rgb, depth, ts = ring.frame(i, batched=False)
        state, out = frontend.track_step(cfg, cam, state, frontend.FrameInput(rgb, depth, ts))
        got = ref.track(rstate, rgb, depth, ts, "fp32")
        rstate = ref.m["mapstate"].VOState(**got["post"])
        assert torch.equal(out.packed.double(), torch.from_numpy(got["record"]))
        for name, leaf in _leaves(state).items():
            assert torch.equal(leaf, got["post"][name]), (i, name)
        keyframes += bool(out.is_keyframe)
        # the reference's ORB equals the program's keypoints
        assert check.compare_orb({n: got["inter"][n] for n in ("xy", "kp_valid", "desc")}, ref.orb(rgb, "fp32")) == \
            dict(kp_off=0, desc_bits_off=0)
    assert keyframes >= 1
    kf = int(state.num_kf) - 1
    state, _ = backend.ba_step(cfg, cam, state, kf)
    got = ref.ba(ref.m["mapstate"].VOState(**{n: v.clone() for n, v in _leaves(rstate).items()}), kf, "fp32")
    assert check.compare_ba(_leaves(state), got) == dict(ba_gap_um=0.0, ba_flags_off=0)
    assert all(torch.equal(leaf, got[n]) for n, leaf in _leaves(state).items())


def test_reference_relaxation_follows_the_port_on_the_cpu():
    settings = dict(TINY, relax_every_kf=2, relax_loop_gap_s=0.3)
    cfg = VOConfig().replace(**settings)
    ref = check.Reference(settings, "cpu")
    ring = frames.Ring(11, dict(SWEEP, period=120), CAMERA, "cpu", max_frames=32)
    cam = Camera.from_config(cfg)
    state = mapstate.init_state(cfg, 3, "cpu")
    for i in range(24):  # past the 0.3 s loop gap, so that loop edges exist
        state, _ = frontend.track_step(cfg, cam, state, frontend.FrameInput(*ring.frame(i, batched=False)))
    kw = dict(loop_gap_s=cfg.relax_loop_gap_s, require_loop=True)
    got = globalopt.compute_relaxation(state, cfg, **kw)
    want = ref.relax(ref.state({n: v[None] for n, v in _leaves(state).items()}, 0), kw, "fp32")
    assert got.report.num_loop_edges > 0 and got.report.kf_ts.size
    nums = check.compare_relax(got, want, state.kf_valid)
    assert nums == dict(relax_edges_off=0, relax_kf_gap_um=0.0, relax_rot_gap_urad=0.0)
    assert torch.equal(got.delta_w, want.delta_w) and torch.equal(got.ref_delta_w, want.ref_delta_w)
    post = _leaves(globalopt.apply_relaxation(state, got))
    assert check.compare_relax_map(post, ref.apply(ref.state({n: v[None] for n, v in _leaves(state).items()}, 0), want,
                                                   "fp32")) == dict(relax_map_off=0, relax_map_gap_um=0.0)
    ts = np.arange(24, dtype=np.float64) / 30.0
    poses = np.tile(np.asarray([1.0, 0, 0, 0, 0.1, 0.0, 0.0], np.float32), (24, 1))
    assert np.array_equal(globalopt.correct_trajectory(got.report, ts, poses), ref.correct(want.report, ts, poses))
