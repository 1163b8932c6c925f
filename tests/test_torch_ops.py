"""Parity of the port's ops (rgbd_visualodometry_tpu_torch/ops, camera.py)
with the JAX package, on seeded numpy inputs.

Tolerances: integer and boolean outputs exactly equal.  Image operations
feeding FAST/Harris/BRIEF decisions are bit-identical (the port evaluates
the same float32 expressions with XLA's fused multiply-adds).  Geometry
(SE(3), Jacobi, RANSAC, LM, DLT) agrees to float32 rounding: XLA reorders
and fuses those float32 expressions differently from torch, so 1e-5..1e-4
absolute is stated per test.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import asnp, inject_reference_pyramid, small_cfgs, small_scene, t, x64_off  # noqa: F401
from rgbd_visualodometry_tpu import camera as jcam
from rgbd_visualodometry_tpu.ops import depth as jdepth
from rgbd_visualodometry_tpu.ops import fast as jfast
from rgbd_visualodometry_tpu.ops import image as jim
from rgbd_visualodometry_tpu.ops import lm as jlm
from rgbd_visualodometry_tpu.ops import matching as jmatch
from rgbd_visualodometry_tpu.ops import orb as jorb
from rgbd_visualodometry_tpu.ops import packing as jpack
from rgbd_visualodometry_tpu.ops import pnp as jpnp
from rgbd_visualodometry_tpu.ops import se3 as jse3
from rgbd_visualodometry_tpu.ops import smalleig as jeig
from rgbd_visualodometry_tpu.ops import triangulate as jtri
from rgbd_visualodometry_tpu_torch import camera as tcam
from rgbd_visualodometry_tpu_torch import random as vo_random
from rgbd_visualodometry_tpu_torch.ops import depth as tdepth
from rgbd_visualodometry_tpu_torch.ops import fast as tfast
from rgbd_visualodometry_tpu_torch.ops import image as tim
from rgbd_visualodometry_tpu_torch.ops import lm as tlm
from rgbd_visualodometry_tpu_torch.ops import matching as tmatch
from rgbd_visualodometry_tpu_torch.ops import orb as torb
from rgbd_visualodometry_tpu_torch.ops import packing as tpack
from rgbd_visualodometry_tpu_torch.ops import pnp as tpnp
from rgbd_visualodometry_tpu_torch.ops import se3 as tse3
from rgbd_visualodometry_tpu_torch.ops import smalleig as teig
from rgbd_visualodometry_tpu_torch.ops import triangulate as ttri

pytestmark = pytest.mark.usefixtures("x64_off")


def _poses(rng, n, rot=0.5, trans=1.0):
    rv = rng.normal(0, rot, (n, 3))
    th = np.linalg.norm(rv, axis=1, keepdims=True)
    q = np.concatenate([np.cos(th / 2), np.sin(th / 2) * rv / th], axis=1)
    return np.concatenate([q, rng.normal(0, trans, (n, 3))], axis=1).astype(np.float32)


def _frame_gray():
    cfg, _ = small_cfgs()
    f = small_scene().render(np.array([1.0, 0, 0, 0, 0.03, 0.01, 0.0]), 0.1)
    return np.asarray(jax.jit(jim.rgb_to_gray)(jnp.asarray(f.rgb))), f


# ---------------------------------------------------------------- geometry


def test_se3_matches():
    rng = np.random.default_rng(0)
    a, b = _poses(rng, 64), _poses(rng, 64)
    xi = rng.normal(0, 0.3, (64, 6)).astype(np.float32)
    xi[:8, 3:] *= 1e-6  # small-angle Taylor branches
    p = rng.normal(0, 2, (64, 3)).astype(np.float32)
    pairs = [
        (jse3.exp(xi), tse3.exp(t(xi))),
        (jse3.log(a), tse3.log(t(a))),
        (jse3.compose(a, b), tse3.compose(t(a), t(b))),
        (jse3.inverse(a), tse3.inverse(t(a))),
        (jse3.relative(a, b), tse3.relative(t(a), t(b))),
        (jse3.apply(a, p), tse3.apply(t(a), t(p))),
        (jse3.to_matrix34(a), tse3.to_matrix34(t(a))),
        (jse3.normalize(a * 1.3), tse3.normalize(t(a * 1.3))),
    ]
    for want, got in pairs:
        np.testing.assert_allclose(asnp(got), np.asarray(want), atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("branch", ["trace", "x", "y", "z"])
def test_se3_matrix_forms_match(branch):
    """``matrix_to_quat``, ``to_matrix``, ``from_matrix``: rotations whose
    trace is positive, and rotations near pi about x, y or z (each of
    ``matrix_to_quat``'s diagonal candidates)."""
    rng = np.random.default_rng(11)
    a = _poses(rng, 64, rot=0.3)
    if branch != "trace":
        axis = np.eye(3)["xyz".index(branch)]
        rv = np.pi * 0.97 * axis + rng.normal(0, 0.05, (64, 3))
        th = np.linalg.norm(rv, axis=1, keepdims=True)
        a[:, :4] = np.concatenate([np.cos(th / 2), np.sin(th / 2) * rv / th], axis=1)
    M = np.asarray(jse3.to_matrix(a))
    np.testing.assert_allclose(asnp(tse3.to_matrix(t(a))), M, atol=2e-6)
    want_q = np.asarray(jse3.matrix_to_quat(M[:, :3, :3]))
    np.testing.assert_allclose(asnp(tse3.matrix_to_quat(t(M[:, :3, :3]))), want_q, atol=2e-6)
    for m in (M, M[:, :3]):
        np.testing.assert_allclose(asnp(tse3.from_matrix(t(m))), np.asarray(jse3.from_matrix(m)), atol=2e-6)
    # the round trip recovers the pose up to the quaternion's sign
    back = asnp(tse3.from_matrix(tse3.to_matrix(t(a))))
    sign = np.sign(np.sum(back[:, :4] * a[:, :4], axis=1, keepdims=True))
    np.testing.assert_allclose(back[:, :4] * sign, a[:, :4], atol=1e-5)


def test_camera_matrix_matches():
    from rgbd_visualodometry_tpu.config import VOConfig as JaxVOConfig
    from rgbd_visualodometry_tpu_torch.config import VOConfig

    for tcfg, jcfg in (small_cfgs(), (VOConfig(), JaxVOConfig())):
        got = tcam.Camera.from_config(tcfg).matrix
        assert got.dtype == torch.float32 and got.shape == (3, 3)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jcam.Camera.from_config(jcfg).matrix))


def test_camera_matches():
    jc_cfg = small_cfgs()[1]
    jc, tc = jcam.Camera.from_config(jc_cfg), tcam.Camera.from_config(small_cfgs()[0])
    rng = np.random.default_rng(1)
    pose = _poses(rng, 1, rot=0.1, trans=0.2)[0]
    pw = np.concatenate([rng.uniform(-3, 3, (500, 2)), rng.uniform(-1, 5, (500, 1))], 1).astype(np.float32)
    center = np.asarray(jcam.camera_center(pose))
    norm = (pw - center + rng.normal(0, 0.8, (500, 3))).astype(np.float32)
    norm /= np.linalg.norm(norm, axis=1, keepdims=True)
    uv = rng.uniform(0, 320, (500, 2)).astype(np.float32)
    d = rng.uniform(0.5, 4, 500).astype(np.float32)
    np.testing.assert_allclose(asnp(tcam.world2pixel(tc, t(pw), t(pose))), np.asarray(jcam.world2pixel(jc, pw, pose)), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(asnp(tcam.pixel2world(tc, t(uv), t(pose), t(d))), np.asarray(jcam.pixel2world(jc, uv, pose, d)), atol=2e-5)
    np.testing.assert_allclose(asnp(tcam.pixel2camera(tc, t(uv), 1.0)), np.asarray(jcam.pixel2camera(jc, uv, 1.0)), atol=1e-6)
    np.testing.assert_allclose(asnp(tcam.camera_center(t(pose))), np.asarray(jcam.camera_center(pose)), atol=1e-6)
    got = asnp(tcam.in_frustum(tc, t(pw), t(pose), t(norm), jc_cfg.max_observe_angle))
    want = np.asarray(jcam.in_frustum(jc, pw, pose, norm, jc_cfg.max_observe_angle))
    np.testing.assert_array_equal(got, want)
    assert 50 < want.sum() < 450


def test_smalleig_matches():
    rng = np.random.default_rng(2)
    X = rng.normal(0, 1, (32, 4, 4)).astype(np.float32)
    S = X @ np.swapaxes(X, -1, -2) + 0.1 * np.eye(4, dtype=np.float32)
    w_j, V_j = jeig.jacobi_eigh_sym(jnp.asarray(S))
    w_t, V_t = teig.jacobi_eigh_sym(t(S))
    np.testing.assert_allclose(asnp(w_t), np.asarray(w_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(asnp(V_t), np.asarray(V_j), atol=1e-4)
    A3 = (rng.normal(0, 1, (32, 3, 3)) + 3 * np.eye(3)).astype(np.float32)
    np.testing.assert_allclose(asnp(teig.inv3x3(t(A3))), np.asarray(jeig.inv3x3(A3)), rtol=1e-4, atol=1e-5)
    b = rng.normal(0, 1, (32, 4)).astype(np.float32)
    np.testing.assert_allclose(asnp(teig.cholesky_solve(t(S), t(b))), np.asarray(jeig.cholesky_solve(S, b)), rtol=1e-3, atol=1e-4)
    world = rng.normal(0, 1, (32, 3, 3)).astype(np.float32)
    cam = np.asarray(jse3.apply(_poses(rng, 32)[:, None, :], world))
    np.testing.assert_allclose(asnp(teig.kabsch_quat(t(world), t(cam))), np.asarray(jeig.kabsch_quat(world, cam)), atol=1e-4)


def test_triangulate_matches():
    rng = np.random.default_rng(3)
    B, K = 64, 8
    poses = np.repeat(_poses(rng, 1, rot=0.05, trans=0.1), B * K, 0).reshape(B, K, 7)
    poses[..., 4:] += rng.normal(0, 0.3, (B, K, 3)).astype(np.float32)
    pw = np.concatenate([rng.uniform(-1, 1, (B, 2)), rng.uniform(2, 4, (B, 1))], 1).astype(np.float32)
    pc = np.asarray(jse3.apply(poses, pw[:, None, :]))
    norm_xy = (pc[..., :2] / pc[..., 2:3] + rng.normal(0, 1e-3, (B, K, 2))).astype(np.float32)
    mask = rng.random((B, K)) < 0.6
    want = jtri.triangulate(poses, norm_xy, mask, 1e-2, 2, min_baseline=0.4)
    got = ttri.triangulate(t(poses), t(norm_xy), t(mask), 1e-2, 2, min_baseline=0.4)
    np.testing.assert_array_equal(asnp(got.ok), np.asarray(want.ok))
    ok = np.asarray(want.ok)
    assert ok.sum() > 10
    np.testing.assert_allclose(asnp(got.points)[ok], np.asarray(want.points)[ok], rtol=1e-3, atol=1e-3)


def _pnp_problem(seed, m=256):
    rng = np.random.default_rng(seed)
    jcfg = small_cfgs()[1]
    jc = jcam.Camera.from_config(jcfg)
    pose = _poses(rng, 1, rot=0.05, trans=0.1)[0]
    pw = np.concatenate([rng.uniform(-1.5, 1.5, (m, 2)), rng.uniform(2, 3, (m, 1))], 1).astype(np.float32)
    uv = np.asarray(jcam.world2pixel(jc, pw, pose)) + rng.normal(0, 0.5, (m, 2))
    uv[: m // 5] += rng.uniform(-40, 40, (m // 5, 2))  # outliers
    pc = np.asarray(jse3.apply(pose, pw)) + rng.normal(0, 0.005, (m, 3))
    match_valid = rng.random(m) < 0.9
    depth_ok = rng.random(m) < 0.8
    seed_pose = np.array([1, 0, 0, 0, 0, 0, 0], np.float32)
    return jc, uv.astype(np.float32), pw, pc.astype(np.float32), depth_ok, match_valid, seed_pose


def test_ransac_pnp_same_samples_same_pose():
    jc, uv, pw, pc, d_ok, mv, seed_pose = _pnp_problem(4)
    tc = tcam.Camera.from_config(small_cfgs()[0])
    key = jax.random.PRNGKey(11)
    want = jpnp.ransac_pnp(key, pw, uv, pc, d_ok, mv, seed_pose, jc, 64, 4.0)
    got = tpnp.ransac_pnp(vo_random.PRNGKey(11), t(pw), t(uv), t(pc), t(d_ok), t(mv), t(seed_pose), tc, 64, 4.0)
    np.testing.assert_array_equal(asnp(got.inliers), np.asarray(want.inliers))
    assert int(got.num_inliers) == int(want.num_inliers) > 100
    np.testing.assert_allclose(asnp(got.pose), np.asarray(want.pose), atol=1e-4)


def test_refine_pose_matches():
    jc, uv, pw, pc, d_ok, mv, _ = _pnp_problem(5)
    tc = tcam.Camera.from_config(small_cfgs()[0])
    pose0 = np.asarray(jeig.kabsch_quat(pw[None, :8], pc[None, :8]))[0]
    inl = mv.copy()
    want = jlm.refine_pose(pose0, pw, uv, inl, jc, 10)
    got = tlm.refine_pose(t(pose0), t(pw), t(uv), t(inl), tc, 10)
    np.testing.assert_allclose(asnp(got.pose), np.asarray(want.pose), atol=1e-5)
    np.testing.assert_array_equal(asnp(got.inliers), np.asarray(want.inliers))


# ------------------------------------------------------------------ images


def test_image_ops_bit_identical():
    gray, f = _frame_gray()
    rng = np.random.default_rng(6)
    noisy = np.clip(gray + rng.normal(0, 3, gray.shape), 0, 255).astype(np.float32)
    rgb = rng.integers(0, 256, (60, 80, 3)).astype(np.uint8)
    np.testing.assert_array_equal(asnp(tim.rgb_to_gray(t(f.rgb))), gray)
    np.testing.assert_array_equal(asnp(tim.rgb_to_gray(t(rgb))), np.asarray(jax.jit(jim.rgb_to_gray)(rgb)))
    for img in (gray, noisy):
        g = t(img)
        np.testing.assert_array_equal(asnp(tim.gaussian_blur(g, 7, 2.0)), np.asarray(jim.gaussian_blur(img, 7, 2.0)))
        np.testing.assert_array_equal(asnp(tfast.harris_response(g)), np.asarray(jax.jit(jfast.harris_response)(img)))
        np.testing.assert_array_equal(asnp(tfast.fast_score(g)), np.asarray(jax.jit(jfast.fast_score)(img)))
        np.testing.assert_array_equal(asnp(tim.maxpool3x3(g)), np.asarray(jax.jit(jim.maxpool3x3)(img)))
        jix, jiy = jax.jit(jim.sobel_gradients)(img)
        tix, tiy = tim.sobel_gradients(g)
        np.testing.assert_array_equal(asnp(tix), np.asarray(jix))
        np.testing.assert_array_equal(asnp(tiy), np.asarray(jiy))


def test_pyramid_resize_close():
    """Same antialiased triangle weights; 1e-3 gray levels (the values are
    0..255 floats) because XLA's CPU division and dot accumulation order are
    not reproduced bit for bit."""
    gray, _ = _frame_gray()
    want = jax.jit(lambda g: jim.build_pyramid(g, 4, 1.2))(gray)
    got = tim.build_pyramid(t(gray), 4, 1.2)
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(asnp(g), np.asarray(w), atol=1e-3, rtol=0)
    assert tim.pyramid_shapes(480, 640, 8, 1.2) == jim.pyramid_shapes(480, 640, 8, 1.2)
    for n, lv in ((500, 8), (300, 4), (37, 5)):
        assert tim.features_per_level(n, lv, 1.2) == jim.features_per_level(n, lv, 1.2)


@pytest.mark.parametrize("threshold,border,k", [(20.0, 17, 97), (5.0, 31, 200), (60.0, 20, 50)])
def test_detect_level_matches(threshold, border, k):
    gray, _ = _frame_gray()
    # jitted, as inside the reference's orb.extract: XLA's fusion decides
    # where products contract into fused multiply-adds
    xy_j, r_j, v_j = jax.jit(jfast.detect_level, static_argnums=(1, 2, 3))(jnp.asarray(gray), threshold, border, k)
    xy_t, r_t, v_t = tfast.detect_level(t(gray), threshold, border, k)
    np.testing.assert_array_equal(asnp(v_t), np.asarray(v_j))
    np.testing.assert_array_equal(asnp(xy_t), np.asarray(xy_j))
    np.testing.assert_array_equal(asnp(r_t), np.asarray(r_j))


# --------------------------------------------------------------------- ORB


def test_brief_pattern_and_offsets_match():
    np.testing.assert_array_equal(torb.BRIEF_PATTERN, jorb.BRIEF_PATTERN)
    Q = 120
    table = jorb._brief_diff_table(Q)  # [PATCH^2, Q*256]: +1 at p1, -1 at p0
    off = torb.brief_offsets(Q)  # [Q, 256, 2, 2]
    lin = (off[..., 1] + torb.PATCH_R) * torb.PATCH + (off[..., 0] + torb.PATCH_R)
    cols = np.arange(Q * 256).reshape(Q, 256)
    same = lin[..., 0] == lin[..., 1]
    np.testing.assert_array_equal(table[lin[..., 1], cols][~same], 1)
    np.testing.assert_array_equal(table[lin[..., 0], cols][~same], -1)
    np.testing.assert_array_equal(np.abs(table).sum(0).reshape(Q, 256), np.where(same, 0, 2))


def _jax_extract(gray, cfg):
    fn = jax.jit(functools.partial(
        jorb.extract, nfeatures=cfg.number_of_features, nlevels=cfg.level_pyramid,
        scale=cfg.scale_factor, threshold=float(cfg.fast_threshold), border=cfg.edge_threshold,
        angle_bins=cfg.orb_angle_bins,
    ))
    return fn(jnp.asarray(gray))


def _port_extract(gray, cfg):
    return torb.extract(
        t(gray), nfeatures=cfg.number_of_features, nlevels=cfg.level_pyramid,
        scale=cfg.scale_factor, threshold=float(cfg.fast_threshold), border=cfg.edge_threshold,
        angle_bins=cfg.orb_angle_bins,
    )


@pytest.mark.usefixtures("inject_reference_pyramid")
def test_orb_extract_bit_identical_on_the_same_pyramid():
    """Given the reference's pyramid levels, every keypoint slot, Harris
    response and descriptor bit is identical; angles agree to float32
    rounding (the reference sums the centroid moments in float32)."""
    gray, _ = _frame_gray()
    cfg = small_cfgs()[1]
    want = _jax_extract(gray, cfg)
    got = _port_extract(gray, cfg)
    v = np.asarray(want.valid)
    assert v.sum() > 250
    np.testing.assert_array_equal(asnp(got.valid), v)
    np.testing.assert_array_equal(asnp(got.xy), np.asarray(want.xy))
    np.testing.assert_array_equal(asnp(got.octave), np.asarray(want.octave))
    np.testing.assert_array_equal(asnp(got.response), np.asarray(want.response))
    np.testing.assert_array_equal(asnp(got.size), np.asarray(want.size))
    np.testing.assert_array_equal(asnp(got.desc).view(np.uint32)[v], np.asarray(want.desc)[v])
    np.testing.assert_allclose(asnp(got.angle), np.asarray(want.angle), atol=1e-4)


@pytest.mark.usefixtures("inject_reference_pyramid")
def test_orb_extract_takes_all_levels_nms_in_one_call(monkeypatch):
    """``orb.extract`` computes every used level's NMS map with one
    ``fast_nms_pyramid`` call (one kernel launch on a card) and no
    per-level ``fast_nms``, and still equals the JAX package slot for slot
    on the reference's pyramid."""
    calls = []
    pyramid = tfast.fast_nms_pyramid

    def spy(levels):
        calls.append([tuple(g.shape) for g in levels])
        return pyramid(levels)

    def per_level(gray):
        raise AssertionError("orb.extract called the one-level fast_nms")

    monkeypatch.setattr(tfast, "fast_nms_pyramid", spy)
    monkeypatch.setattr(tfast, "fast_nms", per_level)
    gray, _ = _frame_gray()
    cfg = small_cfgs()[1]
    got = _port_extract(gray, cfg)
    quotas = jim.features_per_level(cfg.number_of_features, cfg.level_pyramid, cfg.scale_factor)
    assert len(calls) == 1 and len(calls[0]) == sum(q > 0 for q in quotas) == cfg.level_pyramid
    assert calls[0][0] == gray.shape
    want = _jax_extract(gray, cfg)
    v = np.asarray(want.valid)
    np.testing.assert_array_equal(asnp(got.valid), v)
    np.testing.assert_array_equal(asnp(got.xy), np.asarray(want.xy))
    np.testing.assert_array_equal(asnp(got.response), np.asarray(want.response))
    np.testing.assert_array_equal(asnp(got.desc).view(np.uint32)[v], np.asarray(want.desc)[v])


def test_orb_extract_own_pyramid_level0_identical():
    """With the port's own resize, level 0 (no resize) is still identical
    slot for slot; the resized levels keep most keypoints."""
    gray, _ = _frame_gray()
    cfg = small_cfgs()[1]
    want = _jax_extract(gray, cfg)
    got = _port_extract(gray, cfg)
    q0 = jim.features_per_level(cfg.number_of_features, cfg.level_pyramid, cfg.scale_factor)[0]
    np.testing.assert_array_equal(asnp(got.xy)[:q0], np.asarray(want.xy)[:q0])
    np.testing.assert_array_equal(asnp(got.desc).view(np.uint32)[:q0], np.asarray(want.desc)[:q0])
    kp = lambda f: {(float(x), float(y)) for (x, y), ok in zip(asnp(f.xy), asnp(f.valid)) if ok}  # noqa: E731
    a, b = kp(want), kp(got)
    assert len(a & b) >= 0.9 * len(a)


# ------------------------------------------------------- depth and packing


def test_lookup_depth_matches():
    rng = np.random.default_rng(7)
    depth = rng.integers(0, 20000, (60, 80)).astype(np.uint16)
    depth[rng.random(depth.shape) < 0.4] = 0  # holes exercise the probe order
    xy = np.concatenate([rng.uniform(-2, 82, (400, 1)), rng.uniform(-2, 62, (400, 1))], 1).astype(np.float32)
    xy[:50] = np.round(xy[:50]) + 0.5  # round-half-to-even cases
    want = jdepth.lookup_depth(jnp.asarray(depth), xy, jnp.float32(5000.0))
    got = tdepth.lookup_depth(t(depth.astype(np.int32)), t(xy), 5000.0)
    np.testing.assert_array_equal(asnp(got.valid), np.asarray(want.valid))
    np.testing.assert_array_equal(asnp(got.depth), np.asarray(want.depth))


@pytest.mark.parametrize("density,k", [(0.05, 64), (0.5, 64), (0.0, 16), (1.0, 300)])
def test_compaction_matches(density, k):
    rng = np.random.default_rng(int(density * 100) + k)
    mask = rng.random(1000) < density
    score = rng.integers(0, 40, 1000)  # many ties inside the threshold bin
    for want, got in (
        (jpack.compact_indices(jnp.asarray(mask), k), tpack.compact_indices(t(mask), k)),
        (jpack.compact_best_indices(jnp.asarray(mask), jnp.asarray(score, jnp.int32), k),
         tpack.compact_best_indices(t(mask), t(score), k)),
    ):
        np.testing.assert_array_equal(asnp(got[0]), np.asarray(want[0]))
        np.testing.assert_array_equal(asnp(got[1]), np.asarray(want[1]))
    idx, val = jpack.compact_indices(jnp.asarray(mask), k)
    np.testing.assert_array_equal(
        asnp(tpack.scatter_back(1000, t(np.asarray(idx)).long(), t(np.asarray(val)))),
        np.asarray(jpack.scatter_back(1000, idx, val)),
    )
    hit_j, inv_j = jpack.inverse_lookup(1000, idx, val)
    hit_t, inv_t = tpack.inverse_lookup(1000, t(np.asarray(idx)).long(), t(np.asarray(val)))
    np.testing.assert_array_equal(asnp(hit_t), np.asarray(hit_j))
    np.testing.assert_array_equal(asnp(inv_t)[np.asarray(hit_j)], np.asarray(inv_j)[np.asarray(hit_j)])


def test_gate_matches_matches():
    rng = np.random.default_rng(8)
    dist = rng.integers(0, 120, 2000).astype(np.int32)
    dist[rng.random(2000) < 0.1] = 1 << 20
    kpi = rng.integers(0, 300, 2000).astype(np.int32)
    cand = rng.random(2000) < 0.7
    want = jmatch.gate_matches(jmatch.NearestKeypoints(kpi, dist), cand, 2.0, 30.0)
    got = tmatch.gate_matches(tmatch.NearestKeypoints(t(kpi), t(dist)), t(cand), 2.0, 30.0)
    np.testing.assert_array_equal(asnp(got.matched), np.asarray(want.matched))
    assert int(got.min_distance) == int(want.min_distance)


@pytest.mark.parametrize("n_cand,n_kp,p_dup", [(2000, 300, 0.3), (512, 37, 0.0), (100, 500, 1.0)])
def test_match_descriptors_matches(n_cand, n_kp, p_dup):
    """The port's ``match_descriptors`` on packed words equals the JAX
    function on the same descriptors as bipolar rows."""
    from rgbd_visualodometry_tpu.ops.pallas_match import unpack_bipolar

    rng = np.random.default_rng(n_cand)
    kp = rng.integers(0, 2**32, (n_kp, 8), dtype=np.uint64).astype(np.uint32)
    cand = rng.integers(0, 2**32, (n_cand, 8), dtype=np.uint64).astype(np.uint32)
    dup = rng.random(n_cand) < p_dup  # near copies of keypoints: a few flipped bits
    src = kp[rng.integers(0, n_kp, n_cand)]
    flips = np.uint32(1) << rng.integers(0, 32, (n_cand, 8)).astype(np.uint32)
    cand[dup] = (src ^ (flips * (rng.random((n_cand, 8)) < 0.3)))[dup]
    cand_mask, kp_mask = rng.random(n_cand) < 0.8, rng.random(n_kp) < 0.9
    want = jmatch.match_descriptors(unpack_bipolar(jnp.asarray(cand)), cand_mask, unpack_bipolar(jnp.asarray(kp)), kp_mask)
    got = tmatch.match_descriptors(t(cand.view(np.int32)), t(cand_mask), t(kp.view(np.int32)), t(kp_mask))
    for field in ("matched", "kp_index", "distance"):
        np.testing.assert_array_equal(asnp(getattr(got, field)), np.asarray(getattr(want, field)), err_msg=field)
    assert int(got.min_distance) == int(want.min_distance)
    assert 0 < asnp(got.matched).sum() or p_dup == 0.0
