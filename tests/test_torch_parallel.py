"""The port's ``MultiStreamVO`` (S streams in one vmapped step on one
device) against the JAX package's ``MultiStreamVO`` on a one-device mesh,
against S independent runs of the port's own single-stream step, and the
pieces it stands on: the stacked state, ``fold_in``, the ``[S, 32]`` record
accessors and the K1/K2 custom ops under ``torch.func.vmap``.

Tiny configuration (``tests/test_parallel.py::tiny_cfg``: 128x96, 64
features, 2 levels), 2 streams with their own scenes (``seed=s``), 10
frames.  Tolerances:
- the records' integer and boolean fields (slots 14-28): equal;
- poses: within 1 mm and 0.05 degrees, as ``test_torch_system.py`` (float32
  sums in another order in torch and XLA, and in a batched and an unbatched
  torch op);
- one masked BA dispatch on a JAX state carried across: keyframe poses
  within 2e-5, live points within 1e-4, the written-back flags equal, as
  ``test_torch_backend.py`` in float32.
BA parity runs with ``ba_bf16=False``: bf16 rounds at other points in torch
and XLA, and between a batched and an unbatched torch op (one count off by 2
at frame 6 of a 10-frame run).  The JAX side runs in its float32 production
mode (``x64_off``) on the reference's pyramid levels
(``reference_pyramid_vmappable``): the port's resize is ~1e-4 gray levels
off, which moves a few keypoints.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import quat_angle_deg, reference_pyramid_vmappable, x64_off  # noqa: F401
from rgbd_visualodometry_tpu.config import VOConfig as JaxVOConfig
from rgbd_visualodometry_tpu.parallel import MultiStreamVO as JaxMultiStreamVO
from rgbd_visualodometry_tpu.parallel import make_mesh
from rgbd_visualodometry_tpu_torch import VOConfig, kernels, mapstate
from rgbd_visualodometry_tpu_torch import random as vo_random
from rgbd_visualodometry_tpu_torch.camera import Camera
from rgbd_visualodometry_tpu_torch.io import synthetic
from rgbd_visualodometry_tpu_torch.ops import fast, matching
from rgbd_visualodometry_tpu_torch.parallel import MultiStreamVO
from rgbd_visualodometry_tpu_torch.pipeline import backend, frontend

pytestmark = pytest.mark.usefixtures("x64_off")

TINY = dict(
    image_width=128, image_height=96,
    camera_fx=100.0, camera_fy=100.0, camera_cx=64.0, camera_cy=48.0,
    number_of_features=64, level_pyramid=2, edge_threshold=16,
    max_keyframes=8, max_mappoints=512, max_obs_per_mappoint=4,
    pnp_max_points=128, triangulation_batch=64, ransac_hypotheses=16,
    tracking_map_min_points=10, packed_matching=True,
    ba_max_poses=4, ba_max_points=256, ba_min_frame_gap=0, ba_bf16=False,
)
S, T = 2, 10
FLAGS = slice(14, 29)  # StepOutput._FIELDS: every integer and boolean field
kernels_fold = kernels.fold_streams  # the rules' helper, before the tests wrap it


def cfgs(**kw):
    params = dict(TINY, **kw)
    return VOConfig(**params), JaxVOConfig(**params)


@pytest.fixture(scope="module")
def batches():
    """``T`` batches ``(rgb [S, H, W, 3], depth [S, H, W], ts [S])``."""
    seqs = [
        synthetic.generate_sequence(
            T, scene=synthetic.SyntheticScene(width=128, height=96, fx=100.0, fy=100.0, cx=64.0, cy=48.0,
                                              cell_size=0.12, seed=s),
            step_t=(0.03, 0.004, 0.0), step_r=(0.0, 0.0, 0.006),
        )
        for s in range(S)
    ]
    return [(np.stack([q[i].rgb for q in seqs]), np.stack([q[i].depth for q in seqs]),
             np.asarray([q[i].timestamp for q in seqs]) + 100.0 * np.arange(S)) for i in range(T)]


@pytest.fixture
def reference_levels(monkeypatch):
    from rgbd_visualodometry_tpu_torch.ops import image as tim

    monkeypatch.setattr(tim, "build_pyramid", reference_pyramid_vmappable)


def _run_port(cfg, batches, staged=False):
    vo = MultiStreamVO(cfg, S, device="cpu")
    outs = []
    for b in batches:
        outs.append(vo.step(vo.put_batch(*b)) if staged else vo.step(*b))
    vo.finish()
    return vo, np.stack([o.packed.numpy() for o in outs])


def _run_jax(jcfg, batches, snapshot_after=None):
    """The JAX ``MultiStreamVO`` on one CPU device: ``(records [T, S, 32],
    BA dispatches, the state as numpy leaves after step ``snapshot_after``
    with that step's record)``."""
    vo = JaxMultiStreamVO(jcfg, n_streams=S, mesh=make_mesh(1, devices=jax.devices()[:1]))
    outs, snap = [], None
    for i, b in enumerate(batches):
        outs.append(np.asarray(vo.step(*b).packed))
        if i == snapshot_after:
            snap = {k: np.asarray(v) for k, v in jax.device_get(vo.states)._asdict().items()}
    vo.finish()
    return np.stack(outs), vo.ba_dispatches, snap, vo


def _assert_records_close(got, want):
    """Flags and counts equal, ``T_w_c`` within 1 mm and 0.05 degrees."""
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[..., FLAGS], want[..., FLAGS])
    assert np.abs(got[..., 11:14] - want[..., 11:14]).max() < 1e-3
    for a, b in zip(got.reshape(-1, 32), want.reshape(-1, 32)):
        assert quat_angle_deg(a[7:11], b[7:11]) < 0.05


@pytest.fixture(scope="module")
def jax_full(x64_off, batches):
    _, jcfg = cfgs(enable_local_optimization=True)
    return _run_jax(jcfg, batches, snapshot_after=5)


def test_tracking_matches_jax_multistream(reference_levels, batches):
    cfg, jcfg = cfgs(enable_local_optimization=False)
    want, _, _, _ = _run_jax(jcfg, batches)
    _, got = _run_port(cfg, batches)
    assert (got[..., 14] > 0.5).all()  # every stream tracks every frame
    _assert_records_close(got, want)


def test_full_vo_matches_jax_multistream(reference_levels, batches, jax_full):
    want, jax_dispatches, _, _ = jax_full
    cfg, _ = cfgs(enable_local_optimization=True)
    vo, got = _run_port(cfg, batches)
    assert (got[..., 14] > 0.5).all()
    _assert_records_close(got, want)
    assert vo.ba_dispatches == jax_dispatches >= 2


def test_masked_ba_on_a_carried_jax_state(reference_levels, jax_full):
    """A batched JAX state after step 5, its newest keyframes moved by
    2 cm, carried across with ``state_from_numpy``, then one masked BA
    dispatch (BA on stream 0 at that keyframe, stream 1 held) in both
    packages."""
    _, _, snap, jvo = jax_full
    kf = np.maximum(snap["num_kf"] - 1, 0).astype(np.int32)
    snap = dict(snap, kf_pose=snap["kf_pose"].copy())
    snap["kf_pose"][np.arange(S), kf, 4] += 0.02
    pred = np.array([True, False])
    jstates = jax.tree_util.tree_map(jnp.asarray, jvo.states._replace(**snap))
    want = {k: np.asarray(v) for k, v in jax.device_get(jvo._ba(jstates, jnp.asarray(kf), jnp.asarray(pred)))._asdict().items()}
    cfg, _ = cfgs(enable_local_optimization=True)
    vo = MultiStreamVO(cfg, S, device="cpu")
    state = mapstate.state_from_numpy(snap, device="cpu")
    assert tuple(state.mp_pos.shape) == (S, cfg.max_mappoints, 3)
    got = mapstate.state_to_numpy(vo._ba(state, torch.from_numpy(kf).long(), torch.from_numpy(pred)))
    assert not np.array_equal(want["kf_pose"][0], snap["kf_pose"][0])  # BA moved stream 0
    np.testing.assert_array_equal(got["kf_pose"][1], snap["kf_pose"][1])  # and left stream 1 alone
    np.testing.assert_allclose(got["kf_pose"], want["kf_pose"], atol=2e-5, rtol=0)
    alive = ~want["mp_outlier"]
    np.testing.assert_allclose(np.moveaxis(got["mp_pos"], 1, 2)[alive], np.moveaxis(want["mp_pos"], 1, 2)[alive],
                               atol=1e-4, rtol=0)
    for name in ("obs_valid", "mp_outlier", "mp_optimized", "A_inc", "num_kf", "rng"):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_batched_step_equals_per_stream_runs(batches):
    """The vmapped step and the masked BA against each stream's own
    ``track_step`` / ``ba_step``, BA dispatched by the same rule."""
    cfg, _ = cfgs(enable_local_optimization=True)
    vo, got = _run_port(cfg, batches)
    camera = Camera.from_config(cfg)
    key = vo_random.PRNGKey(0)
    states = [mapstate.init_state(cfg, 0, "cpu").replace(rng=vo_random.fold_in(key, s)) for s in range(S)]
    f = frontend.StepOutput._FIELDS
    records, pending, since, dispatches = [], [], 1 << 30, 0
    t0 = batches[0][2]
    for step in range(T + 1):  # the last pass drains what is left (finish)
        if step < T:
            rgb, depth, ts = batches[step]
            outs = []
            for s in range(S):
                frame = frontend.frame_input(rgb[s], depth[s], ts[s] - t0[s], "cpu")
                states[s], out = frontend.track_step(cfg, camera, states[s], frame)
                outs.append(out.packed.numpy())
            records.append(np.stack(outs))
            pending.append(records[-1])
        while len(pending) > (3 if step < T else 0):
            o = pending.pop(0)
            since += 1
            if (o[:, f["needs_ba"]] > 0.5).any() and since > cfg.ba_min_frame_gap:
                for s in np.flatnonzero(o[:, f["needs_ba"]] > 0.5):
                    states[s], _ = backend.ba_step(cfg, camera, states[s], int(o[s, f["kf_slot"]]))
                since, dispatches = 0, dispatches + 1
    _assert_records_close(got, np.stack(records))
    assert vo.ba_dispatches == dispatches >= 2
    for s in range(S):
        one = mapstate.unstack_state(vo.states, s)
        for name in ("num_kf", "mp_valid", "mp_outlier", "obs_valid", "A_inc", "fsm", "rng"):
            assert torch.equal(getattr(one, name), getattr(states[s], name)), (s, name)
        assert (one.kf_pose - states[s].kf_pose).abs().max() < 1e-3


def test_initial_states_match_jax():
    cfg, jcfg = cfgs()
    jvo = JaxMultiStreamVO(jcfg, n_streams=3, mesh=make_mesh(1, devices=jax.devices()[:1]), seed=7)
    want = {k: np.asarray(v) for k, v in jax.device_get(jvo.states)._asdict().items()}
    got = mapstate.state_to_numpy(MultiStreamVO(cfg, 3, device="cpu", seed=7).states)
    assert set(got) == set(want)
    for name in want:
        if name != "mp_bip":  # the port keeps no bipolar pool
            np.testing.assert_array_equal(got[name], want[name], err_msg=name)


@pytest.mark.parametrize("data", [0, 1, 5, 71, 2**31 + 3])
def test_fold_in_matches_jax(data):
    key = jax.random.PRNGKey(42)
    want = np.asarray(jax.random.fold_in(key, np.uint32(data)))
    got = vo_random.fold_in(vo_random.PRNGKey(42), data).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


def test_stacked_state_round_trips():
    cfg, _ = cfgs()
    states = [mapstate.init_state(cfg, s, "cpu") for s in range(3)]
    states[1] = states[1].replace(mp_pos=torch.randn(cfg.max_mappoints, 3), num_kf=torch.tensor(4, dtype=torch.int32))
    stacked = mapstate.stack_states(states)
    assert tuple(stacked.obs_uv.shape) == (3, cfg.max_mappoints, cfg.max_obs_per_mappoint, 2)
    leaves = mapstate.state_to_numpy(stacked)
    assert leaves["mp_pos"].shape == (3, 3, cfg.max_mappoints)  # the JAX package's C-minor layout
    assert leaves["obs_uv"].shape == (3, 2, cfg.max_obs_per_mappoint, cfg.max_mappoints)
    back = mapstate.state_from_numpy(leaves, device="cpu")
    for s in range(3):
        one = mapstate.unstack_state(back, s)
        unbatched = mapstate.state_to_numpy(states[s])
        for f in dataclasses.fields(mapstate.VOState):
            assert torch.equal(getattr(one, f.name), getattr(states[s], f.name)), f.name
            np.testing.assert_array_equal(unbatched[f.name], leaves[f.name][s], err_msg=f.name)


def test_incidence_from_obs_under_vmap():
    cfg, _ = cfgs()
    rng = np.random.default_rng(0)
    states = []
    for s in range(2):
        st = mapstate.init_state(cfg, s, "cpu")
        C, M = st.obs_kf.shape
        states.append(st.replace(obs_kf=torch.from_numpy(rng.integers(0, cfg.max_keyframes, (C, M)).astype(np.int32)),
                                 obs_valid=torch.from_numpy(rng.random((C, M)) < 0.3)))
    got = torch.func.vmap(mapstate.incidence_from_obs)(mapstate.stack_states(states))
    for s in range(2):
        assert torch.equal(got[s], mapstate.incidence_from_obs(states[s]))
        assert int(got[s].sum()) > 100


def test_step_output_accessors():
    rng = np.random.default_rng(1)
    packed = torch.from_numpy(rng.normal(size=(3, 32)).astype(np.float32))
    f = frontend.StepOutput._FIELDS
    packed[:, f["tracked"]] = torch.tensor([1.0, 0.0, 1.0])
    packed[:, f["kf_slot"]] = torch.tensor([3.0, 0.0, 7.0])
    packed[:, f["num_inliers"]] = torch.tensor([120.0, 4.0, 0.0])
    out = frontend.StepOutput(packed=packed)
    assert out.tracked.tolist() == [True, False, True]
    assert out.kf_slot.dtype == torch.int32 and out.kf_slot.tolist() == [3, 0, 7]
    assert out.num_inliers.tolist() == [120, 4, 0]
    assert torch.equal(out.pose_c_w, packed[:, :7]) and torch.equal(out.pose_w_c, packed[:, 7:14])
    one = frontend.StepOutput(packed=packed[2])
    assert bool(one.tracked) and int(one.kf_slot) == 7 and one.pose_w_c.shape == (7,)


def test_staged_batches_match_numpy_path(batches):
    cfg, _ = cfgs()
    _, a = _run_port(cfg, batches[:4])
    _, b = _run_port(cfg, batches[:4], staged=True)
    np.testing.assert_array_equal(a, b)


def test_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    cfg, _ = cfgs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MultiStreamVO(cfg, 2)


def _pyramids(rng, n):
    return [[torch.from_numpy(rng.uniform(0, 255, hw).astype(np.float32)) for hw in ((40, 52), (33, 43), (5, 7))]
            for _ in range(n)]


@pytest.mark.parametrize("in_dim", [0, 1, None])
def test_fast_nms_op_under_vmap(monkeypatch, in_dim):
    """K1's wrapper under vmap with the level batched at axis 0 or 1, or
    not at all (the rule expands it): equal to the plain version per stream
    and level, through one call of the op."""
    rng = np.random.default_rng(2)
    pyrs = _pyramids(rng, 3)
    folds = []
    monkeypatch.setattr(kernels, "fold_streams", lambda *a: folds.append(1) or kernels_fold(*a))
    if in_dim is None:  # level 0 unbatched, the others batched at 0
        args = [pyrs[0][0]] + [torch.stack([p[i] for p in pyrs]) for i in (1, 2)]
        dims = [None, 0, 0]
    else:
        args = [torch.stack([p[i] for p in pyrs], dim=in_dim) for i in range(3)]
        dims = [in_dim] * 3
    got = torch.func.vmap(fast.fast_nms_pyramid, in_dims=(dims,))(args)
    assert len(folds) == 3  # one rule call: each input folded once
    for s in range(3):
        for i in range(3):
            level = pyrs[0][0] if dims[i] is None else pyrs[s][i]
            assert torch.equal(got[i][s], fast.fast_nms_reference(level)), (s, i)


@pytest.mark.parametrize("in_dims", [(0, 0, 0), (1, 0, None), (None, 1, 0)])
def test_hamming_nn_op_under_vmap(monkeypatch, in_dims):
    rng = np.random.default_rng(3)
    B, C, N = 3, 300, 37
    words = lambda *s: torch.from_numpy(rng.integers(0, 2**32, s + (8,), dtype=np.uint64).astype(np.uint32).view(np.int32))  # noqa: E731
    cand, kp, mask = words(B, C), words(B, N), torch.from_numpy(rng.random((B, N)) > 0.2)
    mask[1] = False  # a stream with every keypoint masked
    args = []
    for x, d in zip((cand, kp, mask), in_dims):
        args.append(x[0] if d is None else x.movedim(0, d).contiguous())
    folds = []
    monkeypatch.setattr(kernels, "fold_streams", lambda *a: folds.append(1) or kernels_fold(*a))
    got = torch.func.vmap(matching.nearest_keypoints_packed, in_dims=in_dims)(*args)
    assert len(folds) == 3
    for s in range(B):
        c, k, m = (p[0] if d is None else p[s] for p, d in zip((cand, kp, mask), in_dims))
        want = matching.hamming_nn_reference(c, k, m)
        assert torch.equal(got.kp_index[s], want.kp_index) and torch.equal(got.distance[s], want.distance), s
