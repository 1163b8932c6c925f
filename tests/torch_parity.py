"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

The same inputs, made with numpy from a seed, go through a JAX function and
its counterpart in ``rgbd_visualodometry_tpu_torch``; arrays cross between
the two as numpy.  JAX runs on the CPU as the JAX package's own tests run it.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbd_visualodometry_tpu.config import VOConfig as JaxVOConfig
from rgbd_visualodometry_tpu_torch import config as tconfig
from rgbd_visualodometry_tpu_torch.io import synthetic

# the suite runs in several worker processes: a few threads each
torch.set_num_threads(2)

SMALL = dict(
    image_width=320, image_height=240,
    camera_fx=258.6, camera_fy=258.2, camera_cx=159.3, camera_cy=127.6,
    number_of_features=300, level_pyramid=4,
    max_keyframes=32, max_mappoints=4096, max_obs_per_mappoint=8,
    pnp_max_points=512, triangulation_batch=256, ransac_hypotheses=64,
    ba_max_poses=8, ba_max_points=2048,
    packed_matching=True, enable_local_optimization=False,
)


def small_cfgs(**kw):
    """``(port VOConfig, JAX VOConfig)`` of the small test configuration
    (``tests/test_pipeline.py::small_cfg`` with packed matching, no BA)."""
    params = dict(SMALL, **kw)
    return tconfig.VOConfig(**params), JaxVOConfig(**params)


def small_scene(**kw):
    return synthetic.SyntheticScene(width=320, height=240, fx=258.6, fy=258.2, cx=159.3, cy=127.6, **kw)


@pytest.fixture(scope="module")
def x64_off():
    """The JAX package in its production float mode.  ``tests/conftest.py``
    turns on ``jax_enable_x64``, which makes ``jax.random.uniform`` draw
    float64 (different RANSAC samples) and the resize weights float64; the
    pipeline tests compare against the float32 program the package runs."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


@functools.lru_cache(maxsize=8)
def _jax_pyramid(nlevels: int, scale: float):
    from rgbd_visualodometry_tpu.ops import image as jim

    return jax.jit(lambda g: jim.build_pyramid(g, nlevels, scale))


def reference_pyramid(gray: torch.Tensor, nlevels: int, scale: float):
    """The JAX package's pyramid levels as torch tensors.  Injected into the
    port where a test needs bit-identical levels: the port's resize agrees
    with ``jax.image.resize`` to ~1e-4 gray levels only (XLA's CPU division
    and dot accumulation order are not reproduced), enough to reorder a few
    Harris-ranked keypoints."""
    levels = _jax_pyramid(nlevels, scale)(jnp.asarray(gray.detach().cpu().numpy()))
    return [torch.from_numpy(np.array(lv)).to(gray.device) for lv in levels]


@torch.library.custom_op("rgbdvo_tests::reference_pyramids", mutates_args=())
def _reference_pyramids(gray: torch.Tensor, nlevels: int, scale: float) -> list[torch.Tensor]:
    """:func:`reference_pyramid` of every image of ``gray [B, H, W]``: each
    level ``[B, h, w]``.  A custom op, so it also runs under vmap."""
    levels = jax.vmap(_jax_pyramid(nlevels, scale))(jnp.asarray(gray.detach().cpu().numpy()))
    return [torch.from_numpy(np.array(lv)).to(gray.device) for lv in levels]


@_reference_pyramids.register_vmap
def _(info, in_dims, gray, nlevels, scale):
    if in_dims[0] is None:
        out = _reference_pyramids(gray, nlevels, scale)
        return out, [None] * len(out)
    out = _reference_pyramids(gray.movedim(in_dims[0], 0).reshape(-1, *gray.shape[-2:]), nlevels, scale)
    return [lv.reshape(info.batch_size, -1, *lv.shape[1:]) for lv in out], [0] * len(out)


def reference_pyramid_vmappable(gray: torch.Tensor, nlevels: int, scale: float):
    """:func:`reference_pyramid` that also runs on the images of a vmapped
    batch (``MultiStreamVO``): inject it as ``image.build_pyramid``."""
    return [lv[0] for lv in _reference_pyramids(gray[None], nlevels, scale)]


@pytest.fixture
def inject_reference_pyramid(monkeypatch):
    from rgbd_visualodometry_tpu_torch.ops import image as tim

    monkeypatch.setattr(tim, "build_pyramid", reference_pyramid)


def quat_angle_deg(q1, q2) -> float:
    """Rotation angle between two unit quaternions (sign-insensitive)."""
    q1 = np.asarray(q1, np.float64) / np.linalg.norm(q1)
    q2 = np.asarray(q2, np.float64) / np.linalg.norm(q2)
    d = abs(float(np.dot(q1, q2)))
    c = np.linalg.norm(np.outer(q1, q2) - np.outer(q2, q1)) / np.sqrt(2.0)
    return float(np.degrees(2.0 * np.arctan2(c, d)))


def t(a, dtype=None) -> torch.Tensor:
    """numpy -> torch (CPU), copying so the tensor owns writable memory."""
    x = torch.from_numpy(np.array(a))
    return x if dtype is None else x.to(dtype)


def asnp(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def cfg_fields_equal(a, b) -> bool:
    return dataclasses.asdict(a) == dataclasses.asdict(b)


def relax_cfgs(**kw):
    """``(port VOConfig, JAX VOConfig)`` of ``tests/test_loopclosure.py``'s
    320x240 end-to-end runs (default matching, local BA)."""
    params = dict(SMALL, packed_matching=False, enable_local_optimization=True)
    params.update(kw)
    return tconfig.VOConfig(**params), JaxVOConfig(**params)


def loop_frames(n_frames: int, step: float):
    """The closed synthetic circuit of the loop-closure tests at 320x240."""
    scene = small_scene()
    return [scene.render(T, timestamp=i / 30.0) for i, T in enumerate(synthetic.loop_trajectory(n_frames, step=step))]


def faulted_depth(i: int, n_frames: int, depth: np.ndarray) -> np.ndarray:
    """A +5% depth-scale calibration fault over the middle half of the
    circuit (``tests/test_loopclosure.py``): the map grows at the wrong
    scale, the revisit duplicates landmarks, and only loop closure can
    reconcile the two map generations."""
    if n_frames // 4 <= i < 3 * n_frames // 4:
        return np.clip(depth.astype(np.float32) * 1.05, 0, 65535).astype(np.uint16)
    return depth


def ground_truth(frames):
    """(timestamps, camera centres) of synthetic frames."""
    return np.asarray([f.timestamp for f in frames]), np.asarray([synthetic._pose_inverse(f.T_c_w)[4:7] for f in frames])


def state_to_port(jax_state, device="cpu"):
    """A JAX ``VOState`` as the port's (``mapstate.state_from_numpy``)."""
    from rgbd_visualodometry_tpu_torch import mapstate

    return mapstate.state_from_numpy(jax.device_get(jax_state)._asdict(), device=device)


def graph_to_port(graph):
    """A JAX ``posegraph.PoseGraph`` as the port's (CPU tensors)."""
    from rgbd_visualodometry_tpu_torch.ops import posegraph

    return posegraph.PoseGraph(*(t(np.asarray(x)) for x in graph))


def graph_to_jax(graph):
    """The port's ``posegraph.PoseGraph`` as the JAX package's."""
    from rgbd_visualodometry_tpu.ops import posegraph

    return posegraph.PoseGraph(*(jnp.asarray(asnp(x)) for x in graph))
