"""The port's map state (row-major leaves) against the JAX package's
C-minor ``VOState``, carried across with ``state_from_numpy`` /
``state_to_numpy``.

Tolerances: integer and boolean leaves (slots, flags, observation table,
incidence, FSM, counters, the threefry key) exactly equal; float leaves
within 1e-6 (positions, normals, pixels are copied or normalised float32;
XLA's fused norm may round one ulp apart from torch's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import small_cfgs, small_scene, t, x64_off  # noqa: F401
from rgbd_visualodometry_tpu import mapstate as jms
from rgbd_visualodometry_tpu.pipeline.system import VisualOdometry as JaxVO
from rgbd_visualodometry_tpu_torch.io import synthetic
from rgbd_visualodometry_tpu_torch import mapstate as tms

pytestmark = pytest.mark.usefixtures("x64_off")


def assert_state_equal(port_state, jax_leaves, atol=1e-6):
    got = tms.state_to_numpy(port_state)
    for name, want in jax_leaves.items():
        if name == "mp_bip":
            continue
        g, w = got[name], np.asarray(want)
        assert g.shape == w.shape, name
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, atol=atol, rtol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


def jax_state(leaves):
    return jms.VOState(**{k: jnp.asarray(v) for k, v in leaves.items()})


@pytest.fixture(scope="module")
def leaves5(x64_off):
    """The JAX package's state after 5 tracked frames (2 keyframes)."""
    _, jcfg = small_cfgs()
    vo = JaxVO(jcfg)
    seq = synthetic.generate_sequence(5, scene=small_scene())
    vo.run((f.rgb, f.depth, f.timestamp) for f in seq)
    leaves = {k: np.asarray(v) for k, v in jax.device_get(vo.state)._asdict().items()}
    assert leaves["num_kf"] >= 2 and leaves["mp_valid"].sum() > 300
    return leaves


def test_init_state_matches():
    cfg, jcfg = small_cfgs()
    for seed in (0, 5):
        want = {k: np.asarray(v) for k, v in jms.init_state(jcfg, seed)._asdict().items()}
        assert_state_equal(tms.init_state(cfg, seed, device="cpu"), want, atol=0)


def test_state_round_trip(leaves5):
    s = tms.state_from_numpy(leaves5, device="cpu")
    assert s.mp_pos.shape == (4096, 3) and s.obs_uv.shape == (4096, 8, 2)
    assert s.mp_desc.dtype == torch.int32 and s.rng.dtype == torch.int64
    assert_state_equal(s, leaves5, atol=0)
    back = tms.state_to_numpy(s)
    assert back["mp_desc"].dtype == np.uint32 and back["rng"].dtype == np.uint32
    assert back["mp_bip"].shape == (4096, 0)


def test_tracking_map_mask_matches(leaves5):
    cfg, jcfg = small_cfgs()
    for ref in range(int(leaves5["num_kf"])):
        lv = dict(leaves5, ref_kf=np.int32(ref))
        want = np.asarray(jms.tracking_map_mask(jax_state(lv), jcfg))
        got = tms.tracking_map_mask(tms.state_from_numpy(lv, device="cpu"), cfg).numpy()
        np.testing.assert_array_equal(got, want)
    # whole-map fallback below tracking_map_min_points
    cfg2, jcfg2 = small_cfgs(tracking_map_min_points=100000)
    want = np.asarray(jms.tracking_map_mask(jax_state(leaves5), jcfg2))
    np.testing.assert_array_equal(tms.tracking_map_mask(tms.state_from_numpy(leaves5, device="cpu"), cfg2).numpy(), want)
    assert want.sum() == (leaves5["mp_valid"] & ~leaves5["mp_outlier"]).sum()


@pytest.mark.parametrize("eviction,full,pred", [
    ("ring", False, True), ("ring", True, True), ("ring", True, False),
    ("refuse", False, True), ("refuse", True, True),
])
def test_insert_keyframe_matches(leaves5, eviction, full, pred):
    lv = dict(leaves5)
    K = lv["kf_valid"].shape[0]
    if full:
        lv.update(num_kf=np.int32(K + 3), kf_valid=np.ones(K, bool))
    pose = np.array([0.99, 0.1, 0.0, 0.05, 0.3, -0.2, 0.1], np.float32)
    pose[:4] /= np.linalg.norm(pose[:4])
    js, jslot, jins = jms.insert_keyframe(jax_state(lv), pose, jnp.float32(1.5), jnp.asarray(pred), eviction=eviction)
    ts, tslot, tins = tms.insert_keyframe(tms.state_from_numpy(lv, device="cpu"), t(pose), torch.tensor(1.5), torch.tensor(pred), eviction=eviction)
    assert int(tslot) == int(jslot) and bool(tins) == bool(jins)
    assert_state_equal(ts, {k: np.asarray(v) for k, v in js._asdict().items()})


def test_add_observations_matches(leaves5):
    rng = np.random.default_rng(1)
    C = leaves5["mp_valid"].shape[0]
    mask = leaves5["mp_valid"] & (rng.random(C) < 0.5)
    uv = rng.uniform(0, 320, (C, 2)).astype(np.float32)
    depth = rng.uniform(0.5, 4, C).astype(np.float32)
    center = np.array([0.1, -0.05, 0.02], np.float32)
    for pred in (True, False):
        js = jms.add_observations(jax_state(leaves5), jnp.int32(2), mask, uv.T, center, jnp.asarray(pred), depth=depth)
        ts = tms.add_observations(tms.state_from_numpy(leaves5, device="cpu"), torch.tensor(2, dtype=torch.int32), t(mask), t(uv), t(center), torch.tensor(pred), t(depth))
        assert_state_equal(ts, {k: np.asarray(v) for k, v in js._asdict().items()})


@pytest.mark.parametrize("n_outliers", [0, 50, 4000])
def test_create_mappoints_matches(leaves5, n_outliers):
    rng = np.random.default_rng(n_outliers)
    lv = dict(leaves5)
    out = lv["mp_outlier"].copy()
    out[np.flatnonzero(lv["mp_valid"])[:n_outliers]] = True  # recycled slots
    lv["mp_outlier"] = out
    N = 300
    pos = rng.normal(0, 2, (N, 3)).astype(np.float32)
    desc = rng.integers(0, 2**32, (N, 8), dtype=np.uint64).astype(np.uint32)
    uv = rng.uniform(0, 320, (N, 2)).astype(np.float32)
    create = rng.random(N) < 0.7
    depth = rng.uniform(0.5, 4, N).astype(np.float32)
    center = np.array([0.0, 0.1, -0.1], np.float32)
    bip = np.zeros((N, 0), np.int8)
    js, jn = jms.create_mappoints(jax_state(lv), jnp.int32(1), pos, desc, bip, uv, create, center, jnp.asarray(True), depth=depth)
    ts, tn = tms.create_mappoints(tms.state_from_numpy(lv, device="cpu"), torch.tensor(1, dtype=torch.int32), t(pos), t(desc.view(np.int32)),
                                  t(uv), t(create), t(center), torch.tensor(True), t(depth))
    assert int(tn) == int(jn)
    assert_state_equal(ts, {k: np.asarray(v) for k, v in js._asdict().items()})


def test_incidence_from_obs_matches(leaves5):
    want = np.asarray(jms.incidence_from_obs(jax_state(leaves5)))
    s = tms.state_from_numpy(leaves5, device="cpu")
    np.testing.assert_array_equal(tms.incidence_from_obs(s).numpy(), want)
    # the incremental cache agrees with the rebuild, as in tests/test_mapstate.py
    np.testing.assert_array_equal(tms.incidence(s).numpy(), want)
    assert want.sum() == leaves5["obs_valid"].sum()


@pytest.mark.parametrize("n_rows,p_prune", [(64, 0.3), (256, 1.0), (8, 0.0)])
def test_remove_observations_rows_matches(leaves5, n_rows, p_prune):
    """BA's compact write-back: random rows of valid mappoints (some rows
    invalid), random slots pruned; p_prune = 1 empties whole points, which
    become outliers."""
    rng = np.random.default_rng(n_rows)
    M = leaves5["obs_kf"].shape[0]
    pidx = rng.choice(np.flatnonzero(leaves5["mp_valid"]), n_rows, replace=False).astype(np.int32)
    pval = rng.random(n_rows) < 0.8
    pidx[~pval] = 0  # invalid rows hold slot 0, as compact_indices leaves them
    prune = rng.random((n_rows, M)) < p_prune
    js = jms.remove_observations_rows(jax_state(leaves5), jnp.asarray(pidx), jnp.asarray(pval), jnp.asarray(prune))
    ts = tms.remove_observations_rows(tms.state_from_numpy(leaves5, device="cpu"), t(pidx).long(), t(pval), t(prune))
    assert_state_equal(ts, {k: np.asarray(v) for k, v in js._asdict().items()}, atol=0)
    np.testing.assert_array_equal(tms.incidence_from_obs(ts).numpy(), ts.A_inc.numpy())
    if p_prune == 1.0:
        assert ts.mp_outlier[t(pidx).long()[t(pval)]].all()


@pytest.mark.parametrize("p_remove", [0.3, 1.0, 0.0])
def test_remove_observations_matches(leaves5, p_remove):
    """The full-pool form on the same state: random observation slots of the
    whole pool removed (invalid slots among them, which change nothing);
    p_remove = 1 empties every point, which all become outliers."""
    rng = np.random.default_rng(int(p_remove * 10))
    M, C = leaves5["obs_kf"].shape
    rm = rng.random((M, C)) < p_remove  # the JAX package's [M, C] layout
    js = jms.remove_observations(jax_state(leaves5), jnp.asarray(rm))
    ts = tms.remove_observations(tms.state_from_numpy(leaves5, device="cpu"), t(rm.T.copy()))
    assert_state_equal(ts, {k: np.asarray(v) for k, v in js._asdict().items()}, atol=0)
    np.testing.assert_array_equal(tms.incidence_from_obs(ts).numpy(), ts.A_inc.numpy())
    if p_remove == 1.0:
        assert not ts.obs_valid.any() and bool((ts.mp_outlier | ~ts.mp_valid).all())
