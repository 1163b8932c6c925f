"""The port's local BA (``pipeline/backend.py``) against the JAX package's.

States: the hand-built scenes of ``tests/test_backend.py`` (every keyframe
observes every point, poses and points perturbed), one with corrupted
observations that BA prunes, and the JAX pipeline's own state after 10
frames at 320x240 with BA on.  Each is carried into the port with
``mapstate.state_from_numpy``; the JAX side runs jitted, in float32.

Tolerances:
- ``build_problem``: every field exactly equal (slots, masks, gathered
  pixels and depths are copies).
- ``ba_step`` with ``ba_bf16=False``: poses within 2e-5 and points within
  1e-4 (meters, quaternion components).  Both solve the same float32
  problem; torch and XLA sum the reductions in another order (and on CUDA
  ``index_add_`` sums with atomics), which moves the 20 LM iterations a few
  ulps apart.  ``num_pruned``, ``obs_valid``, ``mp_outlier``,
  ``mp_optimized`` and ``A_inc`` exactly equal.  Positions are compared on
  the points that stay in the map: a point whose every observation BA
  pruned was fit to contradictory pixels, is ill-conditioned (1.4e-4 apart
  in the corrupted scene) and leaves the map as an outlier.
- ``ba_step`` with ``ba_bf16=True``: poses within 1e-3, points within 5e-3,
  and the same pruned count.  bf16 rounds at other points in torch than in
  XLA (up to 1.7e-3 relative on the ``V`` blocks), so the damped steps
  differ by that much; both converge to the same minimum.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_backend import build_scene_state, perturb_state, small_cfg
from torch_parity import small_cfgs, small_scene, x64_off  # noqa: F401
from rgbd_visualodometry_tpu.pipeline import backend as jbackend
from rgbd_visualodometry_tpu.pipeline.system import VisualOdometry as JaxVO
from rgbd_visualodometry_tpu_torch import _shared
from rgbd_visualodometry_tpu_torch import mapstate as tms
from rgbd_visualodometry_tpu_torch.camera import Camera
from rgbd_visualodometry_tpu_torch.pipeline import backend as tbackend

pytestmark = pytest.mark.usefixtures("x64_off")

_EXACT = ("widx", "wval", "wfixed", "pidx", "pval", "o_valid", "o_pose_free", "o_uv", "o_depth")
_WRITE_BACK = ("obs_valid", "mp_outlier", "mp_optimized", "A_inc")


def leaves_of(state) -> dict:
    return {k: np.asarray(v) for k, v in jax.device_get(state)._asdict().items()}


def port_cfg(jcfg):
    return _shared.VOConfig(**dataclasses.asdict(jcfg))


def _scene(case):
    """``(JAX cfg, JAX camera, JAX state, BA keyframe)`` of a named case."""
    if case == "pipeline":
        _, jcfg = small_cfgs(enable_local_optimization=True)
        vo = JaxVO(jcfg)
        vo.run((f.rgb, f.depth, f.timestamp) for f in _shared.generate_sequence(10, scene=small_scene()))
        assert int(vo.state.num_kf) >= 2
        return jcfg, vo.camera, vo.state, int(vo.state.num_kf) - 1
    jcfg = small_cfg()
    cam, state, _, _ = build_scene_state(jcfg)
    if case == "perturbed":
        state = perturb_state(state, np.random.default_rng(1))
    elif case == "corrupted":
        bad = jnp.asarray([[80.0, -60.0], [-75.0, 90.0], [65.0, 70.0], [-80.0, -85.0]], jnp.float32)
        state = state._replace(obs_uv=state.obs_uv.at[:, :4, 0].add(bad.T).at[:, 2, 1].add(60.0))
    return jcfg, cam, state, 3


@pytest.fixture(scope="module")
def scenes(x64_off):
    return {case: _scene(case) for case in ("perturbed", "corrupted", "pipeline")}


@pytest.mark.parametrize("case", ["perturbed", "corrupted", "pipeline"])
def test_build_problem_matches(scenes, case):
    jcfg, _, state, kf = scenes[case]
    want = jbackend.build_problem(jcfg, state, jnp.int32(kf))
    got = tbackend.build_problem(port_cfg(jcfg), tms.state_from_numpy(leaves_of(state)), kf)
    for name in _EXACT:
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name)
    # the one-hot rows of the reference are the port's window positions
    onehot = np.asarray(want.o_onehot)
    P = onehot.shape[-1]
    wpos = got.o_wpos.numpy()
    np.testing.assert_array_equal(onehot.argmax(-1)[wpos < P], wpos[wpos < P])
    assert (onehot.sum(-1)[wpos == P] == 0).all()
    np.testing.assert_array_equal(got.fixed_poses.numpy(), np.asarray(want.fixed_poses))
    assert int(got.pval.sum()) > 100


def _both_ba(scene, **kw):
    jcfg, cam, state, kf = scene
    jcfg = jcfg.replace(**kw)
    js, jo = jax.jit(lambda s: jbackend.ba_step(jcfg, cam, s, jnp.int32(kf)))(state)
    cfg = port_cfg(jcfg)
    ts, to = tbackend.ba_step(cfg, Camera.from_config(cfg), tms.state_from_numpy(leaves_of(state)), kf)
    return leaves_of(js), jo, tms.state_to_numpy(ts), to


@pytest.mark.parametrize("case", ["perturbed", "corrupted", "pipeline"])
def test_ba_step_matches_in_float32(scenes, case):
    want, jo, got, to = _both_ba(scenes[case], ba_bf16=False)
    assert (int(to.num_pruned), int(to.num_points), int(to.num_poses)) == (
        int(jo.num_pruned), int(jo.num_points), int(jo.num_poses))
    np.testing.assert_allclose(got["kf_pose"], want["kf_pose"], atol=2e-5, rtol=0)
    alive = ~want["mp_outlier"]
    np.testing.assert_allclose(got["mp_pos"][:, alive], want["mp_pos"][:, alive], atol=1e-4, rtol=0)
    for name in _WRITE_BACK:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    if case == "corrupted":
        assert int(to.num_pruned) >= 5


@pytest.mark.parametrize("case", ["perturbed", "corrupted", "pipeline"])
def test_ba_step_matches_in_bf16(scenes, case):
    want, jo, got, to = _both_ba(scenes[case], ba_bf16=True)
    assert int(to.num_pruned) == int(jo.num_pruned)
    np.testing.assert_allclose(got["kf_pose"], want["kf_pose"], atol=1e-3, rtol=0)
    alive = ~want["mp_outlier"]
    np.testing.assert_allclose(got["mp_pos"][:, alive], want["mp_pos"][:, alive], atol=5e-3, rtol=0)


def _port_scene(cfg_kw=None, with_depth=True, rng_seed=None, edit=None):
    """A ``tests/test_backend.py`` scene in the port: ``(cfg, camera, state,
    true poses [K, 7] numpy, true points [n, 3] numpy)``."""
    jcfg = small_cfg(**(cfg_kw or {}))
    _, state, poses_true, pts_true = build_scene_state(jcfg, with_depth=with_depth)
    if rng_seed is not None:
        state = perturb_state(state, np.random.default_rng(rng_seed))
    leaves = leaves_of(state)
    if edit:
        edit(leaves)
    cfg = port_cfg(jcfg)
    return cfg, Camera.from_config(cfg), tms.state_from_numpy(leaves), np.array(poses_true), np.array(pts_true)


def _pose_err(state, poses_true):
    from rgbd_visualodometry_tpu_torch.ops import se3

    n = poses_true.shape[0]
    d = se3.log(se3.compose(state.kf_pose[:n], se3.inverse(torch.from_numpy(poses_true).float())))
    return torch.linalg.norm(d, dim=1).numpy()


def _pt_err(state, pts_true):
    return np.linalg.norm(state.mp_pos[: pts_true.shape[0]].numpy() - pts_true, axis=1)


def _bad_obs(leaves):
    # all observations of point 0 beyond repair, one of point 1
    bad = np.array([[80.0, -60.0], [-75.0, 90.0], [65.0, 70.0], [-80.0, -85.0]], np.float32)
    leaves["obs_uv"] = leaves["obs_uv"].copy()
    leaves["obs_uv"][:, :4, 0] += bad.T
    leaves["obs_uv"][1, 2, 1] += 60.0


def _bad_depth(leaves):
    leaves["obs_depth"] = leaves["obs_depth"].copy()
    leaves["obs_depth"][1, [2, 5, 11, 17, 23, 31]] *= 3.0


@pytest.mark.parametrize("behaviour", ["converges", "prunes", "no_depth_prior", "empty_window", "outlier_depth"])
def test_ba_behaviour(behaviour):
    """The behavioural contract of ``tests/test_backend.py:124-227``, on the port."""
    if behaviour == "empty_window":
        cfg = port_cfg(small_cfg())
        state = tms.init_state(cfg)
        state2, out = tbackend.ba_step(cfg, Camera.from_config(cfg), state, 0)
        assert int(out.num_poses) == 0 and int(out.num_points) == 0
        assert torch.isfinite(state2.mp_pos).all() and torch.isfinite(state2.kf_pose).all()
        return
    if behaviour == "converges":
        cfg, cam, state, poses_true, pts_true = _port_scene(rng_seed=1)
        assert _pose_err(state, poses_true)[1:].max() > 5e-3
        state2, out = tbackend.ba_step(cfg, cam, state, 3)
        assert int(out.num_poses) == 4 and int(out.num_points) == 120 and int(out.num_pruned) == 0
        assert _pose_err(state2, poses_true)[1:].max() < 1e-3
        assert np.median(_pt_err(state2, pts_true)) < 5e-3
        np.testing.assert_allclose(state2.kf_pose[0].numpy(), poses_true[0], atol=1e-7)
        assert bool(state2.mp_optimized[:120].all())
    elif behaviour == "prunes":
        cfg, cam, state, poses_true, _ = _port_scene(edit=_bad_obs)
        state2, out = tbackend.ba_step(cfg, cam, state, 3)
        assert int(out.num_pruned) >= 5
        assert bool(state2.mp_outlier[0]) and not bool(state2.mp_outlier[1])
        assert int(state2.obs_valid[1].sum()) == 3
        assert _pose_err(state2, poses_true)[1:].max() < 1e-3
        np.testing.assert_array_equal(tms.incidence_from_obs(state2).numpy(), state2.A_inc.numpy())
    elif behaviour == "no_depth_prior":
        cfg, cam, state, poses_true, pts_true = _port_scene(dict(ba_use_depth_prior=False), with_depth=False, rng_seed=1)
        before = _pose_err(state, poses_true)
        state2, _ = tbackend.ba_step(cfg, cam, state, 3)
        assert _pose_err(state2, poses_true)[1:].max() < before[1:].max()
        assert np.median(_pt_err(state2, pts_true)) < 0.05
    elif behaviour == "outlier_depth":
        cfg, cam, state, poses_true, pts_true = _port_scene(rng_seed=7, edit=_bad_depth)
        state2, _ = tbackend.ba_step(cfg, cam, state, 3)
        assert _pose_err(state2, poses_true)[1:].max() < 2e-3
        err = _pt_err(state2, pts_true)
        assert np.median(err) < 5e-3 and err[[2, 5, 11, 17, 23, 31]].max() < 0.05


def test_failed_cholesky_rejects_the_step(monkeypatch):
    """Where ``cholesky_ex`` reports ``info > 0`` its partial factor can give
    a finite step; the port rejects it as the reference's NaN factor does,
    so every LM step is rejected and the state comes back unchanged."""
    cfg, cam, state, _, _ = _port_scene(rng_seed=1)
    calls = []
    real = torch.linalg.cholesky_ex

    def failing(A, **kw):
        L, info = real(A, **kw)
        calls.append(1)
        return L, torch.ones_like(info)

    monkeypatch.setattr(torch.linalg, "cholesky_ex", failing)
    state2, _ = tbackend.ba_step(cfg, cam, state, 3)
    assert len(calls) == 2 * cfg.ba_iterations
    np.testing.assert_array_equal(state2.kf_pose.numpy(), state.kf_pose.numpy())
    sel = state.mp_valid.numpy()
    np.testing.assert_array_equal(state2.mp_pos.numpy()[sel], state.mp_pos.numpy()[sel])
    # with the real factor the same problem moves
    monkeypatch.setattr(torch.linalg, "cholesky_ex", real)
    state3, _ = tbackend.ba_step(cfg, cam, state, 3)
    assert not torch.equal(state3.kf_pose, state.kf_pose)
