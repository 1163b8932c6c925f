"""The frozen reference against the port's CPU path (plain kernels there too):
at 160x120 over a few frames, every record and state leaf equal, and a BA
dispatch equal."""

import dataclasses

import torch

from rgbd_visualodometry_tpu_torch.camera import Camera
from rgbd_visualodometry_tpu_torch.config import VOConfig
from rgbd_visualodometry_tpu_torch import mapstate
from rgbd_visualodometry_tpu_torch.pipeline import backend, frontend
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
