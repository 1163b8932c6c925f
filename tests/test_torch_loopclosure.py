"""The port's loop-closure graphs (``ops/loopclosure.py``) and global
relaxation (``pipeline/globalopt.py``) against the JAX package's.

States are built as ``tests/test_loopclosure.py`` builds them (observation
tables that are exact projections of seeded points into circle poses, and
the duplicated-landmark revisit) and carried into the port with
``mapstate.state_from_numpy``; both sides run float32 on the CPU.

Tolerances:
- integers exactly equal: co-observation counts ``cnt``, edge lists, edge
  weights, appearance inlier counts, feature-table descriptors and masks,
  report counts;
- moments ``sa``/``sb``/``mba`` within 1e-5 relative (float32 sums in
  another order);
- Kabsch and appearance measurements: rotations within 0.01 degrees
  (``quat_angle_deg``, sign-insensitive) and translations within 1e-4 m;
- relaxed keyframe poses, deformed map points and corrected trajectories
  within 1e-4 (a 12-step Gauss-Newton solve on each side).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import asnp, quat_angle_deg, state_to_port, t, x64_off  # noqa: F401
from rgbd_visualodometry_tpu import camera as jcam_mod, mapstate as jms
from rgbd_visualodometry_tpu.camera import Camera as JCamera
from rgbd_visualodometry_tpu.config import VOConfig as JaxVOConfig
from rgbd_visualodometry_tpu.ops import loopclosure as jlc, se3 as jse3
from rgbd_visualodometry_tpu.pipeline import globalopt as jgo
from rgbd_visualodometry_tpu_torch import config as tconfig, mapstate
from rgbd_visualodometry_tpu_torch.camera import Camera
from rgbd_visualodometry_tpu_torch.ops import loopclosure as tlc
from rgbd_visualodometry_tpu_torch.pipeline import globalopt as tgo

pytestmark = pytest.mark.usefixtures("x64_off")

CFG = dict(max_keyframes=16, max_mappoints=256, max_obs_per_mappoint=6)


def _cfgs():
    return tconfig.VOConfig(**CFG), JaxVOConfig(**CFG)


def _cams():
    tc, jc = _cfgs()
    return Camera.from_config(tc), JCamera.from_config(jc)


def _gt_circle_poses(nk=12, radius=3.0):
    """T_w_c poses on a circle, every camera looking at the origin."""
    ang = 2 * np.pi * np.arange(nk) / nk
    pos = np.stack([radius * np.cos(ang), radius * np.sin(ang), 0.3 * np.sin(2 * ang)], axis=-1)
    fwd = -pos / np.linalg.norm(pos, axis=-1, keepdims=True)
    up = np.broadcast_to(np.array([0.0, 0.0, 1.0]), fwd.shape)
    x = np.cross(up, fwd)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    y = np.cross(fwd, x)
    q = jse3.matrix_to_quat(jnp.asarray(np.stack([x, y, fwd], axis=-1), jnp.float32))
    return jse3.make(q, jnp.asarray(pos, jnp.float32))


def _points(n=256, seed=1):
    return jnp.asarray(np.random.default_rng(seed).uniform(-0.8, 0.8, (n, 3)), jnp.float32)


def _build_state(T_w_k, points_w, kf_dt=0.5, seed=0):
    """``tests/test_loopclosure.py::_build_state``: a JAX ``VOState`` whose
    observation table is the exact projection of ``points_w`` into M of
    the keyframes per point."""
    _, cfg = _cfgs()
    K, C, M = cfg.max_keyframes, cfg.max_mappoints, cfg.max_obs_per_mappoint
    nk, npnt = T_w_k.shape[0], points_w.shape[0]
    cam = JCamera.from_config(cfg)
    T_c_w = jse3.inverse(T_w_k)
    p_cam = jnp.stack([jse3.apply(T_c_w[k], points_w) for k in range(nk)])
    uv_all = np.asarray(jcam_mod.camera2pixel(cam, p_cam))
    p_cam = np.asarray(p_cam)
    rng = np.random.default_rng(seed)
    obs_kf = np.full((C, M), -1, np.int32)
    obs_uv = np.zeros((C, M, 2), np.float32)
    obs_depth = np.zeros((C, M), np.float32)
    obs_valid = np.zeros((C, M), bool)
    for c in range(npnt):
        for m, k in enumerate(np.sort(rng.permutation(nk)[:M])):
            obs_kf[c, m], obs_uv[c, m], obs_depth[c, m], obs_valid[c, m] = k, uv_all[k, c], p_cam[k, c, 2], True
    state = jms.init_state(cfg)
    kf_pose = np.asarray(state.kf_pose).copy()
    kf_pose[:nk] = np.asarray(T_c_w)
    kf_valid = np.arange(K) < nk
    mp_pos = np.asarray(state.mp_pos).T.copy()
    mp_pos[:npnt] = np.asarray(points_w)
    return state._replace(
        kf_pose=jnp.asarray(kf_pose, jnp.float32),
        kf_valid=jnp.asarray(kf_valid),
        kf_timestamp=jnp.asarray(np.arange(K) * kf_dt, jnp.float32),
        num_kf=jnp.int32(nk),
        mp_pos=jnp.asarray(mp_pos.T, jnp.float32),
        mp_valid=jnp.asarray(np.arange(C) < npnt),
        obs_kf=jnp.asarray(obs_kf.T),
        obs_uv=jnp.asarray(obs_uv.transpose(2, 1, 0)),
        obs_depth=jnp.asarray(obs_depth.T),
        obs_valid=jnp.asarray(obs_valid.T),
        ref_kf=jnp.int32(nk - 1),
        prev_pose=jnp.asarray(kf_pose[nk - 1], jnp.float32),
        fsm=jnp.int32(jms.TRACKING),
    )


def _drifted_state():
    """``test_relax_map_removes_drift_and_deforms_map``'s state: exact
    observations, drifted keyframe poses and a map built from them."""
    gt_w, pts = _gt_circle_poses(), _points()
    state = _build_state(gt_w, pts)
    nk, K = gt_w.shape[0], CFG["max_keyframes"]
    rng = np.random.default_rng(3)
    step = rng.normal(0, 0.06, (nk, 6)).astype(np.float32)
    step[0] = 0
    xi = np.cumsum(step, axis=0)
    xi[:, :3] *= 0.3
    drift_w = jse3.compose(jse3.exp(jnp.asarray(xi)), gt_w)
    kf_pose = np.asarray(state.kf_pose).copy()
    kf_pose[:nk] = np.asarray(jse3.inverse(drift_w))
    anchor = np.asarray(state.obs_kf[0, :])
    delta_est = jse3.compose(drift_w, jse3.inverse(gt_w))
    mp_pos = np.asarray(state.mp_pos).T.copy()
    mp_pos[: pts.shape[0]] = np.asarray(jse3.apply(delta_est[np.clip(anchor[: pts.shape[0]], 0, K - 1)], pts))
    return state._replace(kf_pose=jnp.asarray(kf_pose), mp_pos=jnp.asarray(mp_pos.T))


def _duplicated_revisit(drift_xi=(0.02, -0.03, 0.04, 0.35, -0.25, 0.3)):
    """``tests/test_loopclosure.py::_build_duplicated_revisit``: keyframes
    0-2 and 9-11 observe the same points through different mappoint rows
    (shared descriptors, many words with the top bit set); the second
    cluster's pose estimates drift rigidly."""
    _, cfg = _cfgs()
    K, C, M = cfg.max_keyframes, cfg.max_mappoints, cfg.max_obs_per_mappoint
    gt_w = _gt_circle_poses()
    n = 100
    pts = np.asarray(_points(n=n, seed=2))
    cam = JCamera.from_config(cfg)
    T_c_w = np.asarray(jse3.inverse(gt_w))
    desc = np.random.default_rng(5).integers(0, 2**32, size=(n, 8), dtype=np.uint32)
    obs_kf = np.full((C, M), -1, np.int32)
    obs_uv = np.zeros((C, M, 2), np.float32)
    obs_depth = np.zeros((C, M), np.float32)
    obs_valid = np.zeros((C, M), bool)
    mp_desc = np.zeros((C, 8), np.uint32)
    mp_pos = np.zeros((C, 3), np.float32)
    for row0, kfs in ((0, [0, 1, 2]), (n, [9, 10, 11])):
        rows = row0 + np.arange(n)
        mp_desc[rows], mp_pos[rows] = desc, pts
        for m, k in enumerate(kfs):
            p_cam = np.asarray(jse3.apply(jnp.asarray(T_c_w[k]), jnp.asarray(pts)))
            obs_kf[rows, m] = k
            obs_uv[rows, m] = np.asarray(jcam_mod.camera2pixel(cam, jnp.asarray(p_cam)))
            obs_depth[rows, m] = p_cam[:, 2]
            obs_valid[rows, m] = True
    D = jse3.exp(jnp.asarray(drift_xi, jnp.float32))
    est_w = np.asarray(gt_w).copy()
    est_w[9:12] = np.asarray(jse3.compose(D, gt_w[9:12]))
    state = jms.init_state(cfg)
    kf_pose = np.asarray(state.kf_pose).copy()
    kf_pose[:12] = np.asarray(jse3.inverse(jnp.asarray(est_w)))
    return state._replace(
        kf_pose=jnp.asarray(kf_pose, jnp.float32),
        kf_valid=jnp.asarray(np.isin(np.arange(K), [0, 1, 2, 9, 10, 11])),
        kf_timestamp=jnp.asarray(np.arange(K, dtype=np.float32)),
        num_kf=jnp.int32(12),
        mp_pos=jnp.asarray(mp_pos.T),
        mp_desc=jnp.asarray(mp_desc.T),
        mp_valid=jnp.asarray(np.arange(C) < 2 * n),
        obs_kf=jnp.asarray(obs_kf.T),
        obs_uv=jnp.asarray(obs_uv.transpose(2, 1, 0)),
        obs_depth=jnp.asarray(obs_depth.T),
        obs_valid=jnp.asarray(obs_valid.T),
        fsm=jnp.int32(jms.TRACKING),
    )


STATES = {
    "circle": lambda: _build_state(_gt_circle_poses(), _points()),
    "sparse": lambda: _build_state(_gt_circle_poses(), _points(n=16)),
    "drifted": _drifted_state,
    "revisit": _duplicated_revisit,
}


def _assert_poses_close(got, want, rot_deg=0.01, trans_m=1e-4):
    got, want = asnp(got), np.asarray(want)
    assert got.shape == want.shape
    for g, w in zip(got.reshape(-1, 7), want.reshape(-1, 7)):
        assert quat_angle_deg(g[:4], w[:4]) < rot_deg, (g, w)
    np.testing.assert_allclose(got[..., 4:7], want[..., 4:7], atol=trans_m)


def _assert_graphs_match(tg, jg):
    """Edge lists and weights exactly equal; measurements close on the
    edges of at least 3 correspondences (with 1 or 2 the Horn rotation is
    not determined: its 4x4 eigenproblem has a repeated top eigenvalue)."""
    np.testing.assert_array_equal(asnp(tg.edge_i), np.asarray(jg.edge_i))
    np.testing.assert_array_equal(asnp(tg.edge_j), np.asarray(jg.edge_j))
    np.testing.assert_array_equal(asnp(tg.edge_weight), np.asarray(jg.edge_weight))
    np.testing.assert_array_equal(asnp(tg.edge_valid), np.asarray(jg.edge_valid))
    assert tg.edge_i.dtype == torch.int32 and tg.edge_meas.dtype == torch.float32
    determined = np.asarray(jg.edge_weight) >= 3
    _assert_poses_close(asnp(tg.edge_meas)[determined], np.asarray(jg.edge_meas)[determined])


@pytest.mark.parametrize("case", sorted(STATES))
def test_coobservation_moments_match(case):
    js = STATES[case]()
    tcam, jcam = _cams()
    got = tlc.coobservation_moments(state_to_port(js), tcam)
    want = jlc.coobservation_moments(js, jcam)
    np.testing.assert_array_equal(asnp(got[0]), np.asarray(want[0]))  # cnt: exact
    for g, w in zip(got[1:], want[1:]):
        w = np.asarray(w)
        np.testing.assert_allclose(asnp(g), w, rtol=1e-5, atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("case", sorted(STATES))
def test_coobservation_graph_matches(case):
    js = STATES[case]()
    tcam, jcam = _cams()
    for min_shared in (1, 8):
        tg = tlc.build_coobservation_graph(state_to_port(js), tcam, min_shared=min_shared)
        jg = jlc.build_coobservation_graph(js, jcam, min_shared=min_shared)
        _assert_graphs_match(tg, jg)


def test_kabsch_from_moments_matches():
    js = STATES["circle"]()
    tcam, jcam = _cams()
    moments = jlc.coobservation_moments(js, jcam)
    ii, jj = np.nonzero(np.asarray(moments[0]) >= 8)
    sel = [np.asarray(m)[ii, jj] for m in moments]
    _assert_poses_close(tlc.kabsch_from_moments(*(t(m) for m in sel)), jlc.kabsch_from_moments(*map(jnp.asarray, sel)))


@pytest.mark.parametrize("case", ["revisit", "circle"])
def test_keyframe_feature_table_matches(case):
    js = STATES[case]()
    tcam, jcam = _cams()
    got = tlc.keyframe_feature_table(state_to_port(js), tcam, max_features=64)
    want = jlc.keyframe_feature_table(js, jcam, max_features=64)
    np.testing.assert_array_equal(got[0], want[0])  # desc (uint32)
    np.testing.assert_array_equal(got[2], want[2])  # valid
    np.testing.assert_allclose(got[1], want[1], atol=1e-6)
    assert got[0].dtype == np.uint32 and (case == "circle" or (got[0] >= 2**31).any())
    np.testing.assert_array_equal(tlc._bit_histogram(got[0], got[2]), jlc._bit_histogram(want[0], want[2]))


def test_popcount32_counts_words_with_the_top_bit_set():
    rng = np.random.default_rng(0)
    words = np.concatenate([rng.integers(0, 2**32, 1000, dtype=np.uint64).astype(np.uint32),
                            np.array([0, 1, 2**31, 2**32 - 1, 0x80000001, 0x7FFFFFFF], np.uint32)])
    want = np.array([bin(int(w)).count("1") for w in words])
    np.testing.assert_array_equal(asnp(tlc.popcount32(t(words.view(np.int32)))), want)


def test_register_pairs_matches():
    """Matching and trimmed Horn on random descriptors with ties (a
    duplicated feature), masked features and a pair with no valid feature:
    inlier counts exact, poses within tolerance."""
    rng = np.random.default_rng(7)
    P, F = 4, 48
    di = rng.integers(0, 2**32, (P, F, 8), dtype=np.uint64).astype(np.uint32)
    pi = rng.uniform(-1, 1, (P, F, 3)).astype(np.float32) + np.float32([0, 0, 3])
    Tr = jse3.exp(jnp.asarray(rng.normal(0, 0.1, (P, 6)), jnp.float32))
    perm = rng.permutation(F)  # keyframe j sees keyframe i's features in another order
    dj = di[:, perm].copy()
    dj[rng.random((P, F, 8)) < 0.02] ^= np.uint32(0x80000001)  # a few words differ per match
    dj[:, 5] = dj[:, 4]  # a tie
    pj_perm = np.asarray(jse3.apply(jse3.inverse(Tr)[:, None], jnp.asarray(pi)))[:, perm]
    vi = rng.random((P, F)) > 0.1
    vj = rng.random((P, F)) > 0.1
    vi[3] = False
    args = (di, pi, vi, dj, pj_perm, vj)
    want = jlc._register_pairs(*map(jnp.asarray, args), 2.0, 30.0, 0.10)
    got = tlc._register_pairs(
        t(di.view(np.int32)), t(pi), t(vi), t(dj.view(np.int32)), t(pj_perm), t(vj), 2.0, 30.0, 0.10
    )
    np.testing.assert_array_equal(asnp(got[1]), np.asarray(want[1]))
    assert asnp(got[1])[:3].min() >= 12 and asnp(got[1])[3] == 0
    _assert_poses_close(got[0][:3], np.asarray(want[0])[:3])
    np.testing.assert_allclose(asnp(got[2]), np.asarray(want[2]), atol=1e-5)


@pytest.mark.parametrize("case", ["revisit", "circle"])
def test_appearance_graph_matches(case):
    js = STATES[case]()
    tcam, jcam = _cams()
    tg = tlc.build_appearance_graph(state_to_port(js), tcam, loop_gap_s=5.0 if case == "revisit" else 1.0)
    jg = jlc.build_appearance_graph(js, jcam, loop_gap_s=5.0 if case == "revisit" else 1.0)
    _assert_graphs_match(tg, jg)
    if case == "revisit":
        assert tg.edge_i.numel() == 9  # every cross-cluster pair, with its inlier count as weight


def _leaves(state):
    return mapstate.state_to_numpy(state)


@pytest.mark.parametrize("case,kw", [
    ("drifted", dict(min_shared=8)),
    ("revisit", dict(appearance=True)),
    ("revisit", dict(appearance=False)),
    ("circle", dict(require_loop=True, loop_gap_s=1.0)),
    ("circle", dict(require_loop=True)),
])
def test_relax_map_matches(case, kw):
    js = STATES[case]()
    tc, jc = _cfgs()
    tn, trep = tgo.relax_map(state_to_port(js), tc, **kw)
    jn, jrep = jgo.relax_map(js, jc, **kw)
    for f in ("num_edges", "num_loop_edges", "num_chain_edges", "num_appearance_edges"):
        assert getattr(trep, f) == getattr(jrep, f), f
    np.testing.assert_array_equal(trep.kf_ts, jrep.kf_ts)
    np.testing.assert_allclose(trep.old_T_w_k, jrep.old_T_w_k, atol=1e-6)
    np.testing.assert_allclose(trep.new_T_w_k, jrep.new_T_w_k, atol=1e-4)
    np.testing.assert_allclose(trep.loop_pairs_w, jrep.loop_pairs_w, atol=1e-4)
    assert abs(trep.max_correction_m - jrep.max_correction_m) < 1e-4
    got, want = _leaves(tn), jax.device_get(jn)._asdict()
    for name in ("kf_pose", "mp_pos", "prev_pose"):
        np.testing.assert_allclose(got[name], np.asarray(want[name]), atol=1e-4, err_msg=name)


def test_relax_map_noop_without_keyframes():
    tc, _ = _cfgs()
    state = mapstate.init_state(tc, device="cpu")
    new, rep = tgo.relax_map(state, tc)
    assert rep.num_edges == 0 and rep.kf_ts.size == 0
    assert torch.equal(new.kf_pose, state.kf_pose)


def test_apply_relaxation_to_a_newer_state():
    """A relaxation computed on a snapshot, applied after the live state
    gained a keyframe (slot 12) and recycled slot 11 (new timestamp), with
    mappoints anchored to both: those move with the snapshot's newest
    keyframe, as in the reference."""
    js = STATES["drifted"]()
    tc, jc = _cfgs()
    jrlx = jgo.compute_relaxation(js, jc)
    trlx = tgo.compute_relaxation(state_to_port(js), tc)
    newer = jax.device_get(js)._asdict()
    newer = {k: np.array(v) for k, v in newer.items()}
    newer["kf_valid"][12] = True
    newer["kf_pose"][12] = newer["kf_pose"][11]
    newer["kf_timestamp"][12] = 6.0
    newer["kf_timestamp"][11] = 7.0
    newer["obs_kf"][0, :5] = 12  # obs_kf is C-minor [M, C]: first observation of rows 0-4
    newer["obs_kf"][0, 5:10] = 11
    newer["ref_kf"] = np.int32(12)
    jnewer = jms.VOState(**{k: jnp.asarray(v) for k, v in newer.items()})
    want = jax.device_get(jgo.apply_relaxation(jnewer, jrlx))._asdict()
    got = _leaves(tgo.apply_relaxation(mapstate.state_from_numpy(newer, device="cpu"), trlx))
    for name in ("kf_pose", "mp_pos", "prev_pose"):
        np.testing.assert_allclose(got[name], np.asarray(want[name]), atol=1e-4, err_msg=name)
    ref = np.asarray(trlx.ref_delta_w)
    moved = np.asarray(jse3.compose(jnp.asarray(ref), jse3.inverse(jnp.asarray(newer["kf_pose"][12]))))
    np.testing.assert_allclose(np.asarray(jse3.inverse(jnp.asarray(got["kf_pose"][12]))), moved, atol=1e-5)


def test_correct_trajectory_matches():
    rng = np.random.default_rng(7)
    js = STATES["drifted"]()
    tc, jc = _cfgs()
    trep = tgo.relax_map(state_to_port(js), tc)[1]
    jrep = jgo.relax_map(js, jc)[1]
    frames_w = np.asarray(jse3.exp(jnp.asarray(rng.normal(0, 0.3, (20, 6)), jnp.float32)))
    frame_ts = np.concatenate([[-0.3], rng.uniform(0, 6, 18), [5.5]])
    got = tgo.correct_trajectory(trep, frame_ts, frames_w)
    want = np.asarray(jgo.correct_trajectory(jrep, frame_ts, frames_w))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4)
    empty = tgo.relax_map(mapstate.init_state(tc, device="cpu"), tc)[1]
    np.testing.assert_array_equal(tgo.correct_trajectory(empty, frame_ts, frames_w), frames_w)
