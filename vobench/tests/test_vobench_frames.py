"""The frames rendered on the device against the port's synthetic scene, and
the ring they replay from."""

import math

import numpy as np
import torch

from rgbd_visualodometry_tpu_torch.io import synthetic
from vobench import frames
from vobench.tests.tiny import CAMERA

SWEEP = dict(streams=3, period=8, fps=30.0, peak_step_m=[0.012, 0.002, 0.0], peak_yaw_rad=0.003)


def test_render_matches_synthetic_scene():
    """Float64 ray casting as ``SyntheticScene.render`` does it: equal on every
    pixel here; on the card the floors at cell edges and the rounding of
    depth may differ on a few pixels (at most 0.01%, by one cell or one
    depth unit)."""
    c = CAMERA
    scene = synthetic.SyntheticScene(width=c["width"], height=c["height"], fx=c["fx"], fy=c["fy"], cx=c["cx"],
                                     cy=c["cy"], seed=5)
    poses = frames.sweep_poses(np.arange(6), 8, SWEEP["peak_step_m"], SWEEP["peak_yaw_rad"], 1.5)
    rgb, depth = frames.render(torch.from_numpy(scene.tex), torch.from_numpy(poses), c)
    for i, pose in enumerate(poses):
        want = scene.render(pose, timestamp=i / 30.0)
        assert np.array_equal(rgb[i].numpy(), want.rgb)
        assert np.array_equal(depth[i].numpy(), want.depth.astype(np.int32))


def test_sweep_pace():
    """Peak step (1.2, 0.2, 0) cm and 0.003 rad a frame; mean speed ~0.23 m/s
    at 30 Hz (TUM fr1/xyz: 0.24 m/s)."""
    poses = frames.sweep_poses(np.arange(121), 120, SWEEP["peak_step_m"], SWEEP["peak_yaw_rad"], 0.0)
    step = np.linalg.norm(np.diff(poses[:, 4:7], axis=0), axis=1)
    assert math.isclose(step.max(), math.hypot(0.012, 0.002), rel_tol=1e-3)
    assert 0.22 < step.mean() * 30.0 < 0.24
    yaw = 2 * np.arctan2(poses[:, 3], poses[:, 0])
    assert math.isclose(np.abs(np.diff(yaw)).max(), 0.003, rel_tol=1e-3)
    assert np.allclose(poses[0], poses[120])


def test_each_seed_and_stream_has_its_own_texture():
    tex = {(seed, st): frames.texture(seed, st, "cpu") for seed in (1, 2**33 + 7) for st in (0, 1)}
    assert len({t.numpy().tobytes() for t in tex.values()}) == 4
    assert torch.equal(tex[(1, 0)], frames.texture(1, 0, "cpu"))


def test_ring_replays_with_rising_stamps_and_phase_offsets():
    ring = frames.Ring(7, SWEEP, CAMERA, "cpu", max_frames=64)
    P, S = SWEEP["period"], SWEEP["streams"]
    for s in range(S):
        want = frames.sweep_poses(np.arange(P), P, SWEEP["peak_step_m"], SWEEP["peak_yaw_rad"], s * P / S)
        assert np.array_equal(ring.T_c_w[:, s], want)
        rgb, depth = frames.render(frames.texture(7, s, "cpu"), torch.from_numpy(want), CAMERA)
        assert torch.equal(ring.rgb[:, s], rgb) and torch.equal(ring.depth[:, s], depth)
    assert not torch.equal(ring.rgb[:, 0], ring.rgb[:, 1])  # each stream its own texture
    stamps = []
    for i in range(3 * P):
        rgb, depth, ts = ring.frame(i, batched=True)
        assert torch.equal(rgb, ring.rgb[i % P]) and torch.equal(depth, ring.depth[i % P])
        assert ts.shape == (S,) and float(ts[0]) == ring.timestamp(i)
        stamps.append(float(ts[0]))
    assert all(b > a for a, b in zip(stamps, stamps[1:]))
    one = frames.Ring(7, dict(SWEEP, streams=1), CAMERA, "cpu", max_frames=8)
    rgb, depth, ts = one.frame(3, batched=False)
    assert rgb.shape == (CAMERA["height"], CAMERA["width"], 3) and depth.dtype == torch.int32 and ts.dim() == 0
    assert torch.equal(one.rgb[:, 0], ring.rgb[:, 0])  # stream 0 of a seed, whatever the stream count
    other = frames.Ring(8, SWEEP, CAMERA, "cpu", max_frames=8)
    assert np.array_equal(other.T_c_w, ring.T_c_w) and not torch.equal(other.rgb[:, 0], ring.rgb[:, 0])
