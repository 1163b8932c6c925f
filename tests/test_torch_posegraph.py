"""The port's pose-graph solver (``ops/posegraph.py``) against the JAX
package's, on ``tests/test_posegraph.py``'s problems (a drifted 40-pose
circle with noisy odometry and a clean loop edge) made with numpy from a
seed, float32 on both sides.

Tolerances:
- edge indices, validity, ``edge_bucket`` and padding: exactly equal;
  measurements of ``odometry_edges`` / ``relative_measurement`` within 1e-6
  (the same float32 compose in another op order);
- ``residuals`` within 1e-5 and the edge Jacobians ``J_i``, ``J_j`` within
  1e-5, on random edges and on an exact identity edge, where both packages
  differentiate through ``sqrt(0)`` in forward mode;
- ``optimize_pose_graph``: poses within 1e-4 (10-12 Gauss-Newton steps, the
  ``[6K, 6K]`` Cholesky solved by LAPACK in torch and by XLA in JAX).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import asnp, graph_to_jax, graph_to_port, t, x64_off  # noqa: F401
from rgbd_visualodometry_tpu.ops import posegraph as jpg
from rgbd_visualodometry_tpu.ops import se3 as jse3
from rgbd_visualodometry_tpu_torch.ops import posegraph as tpg

pytestmark = pytest.mark.usefixtures("x64_off")


def _circle(k=40, radius=1.0, step=0.15):
    ang = step * np.arange(k)
    q = np.stack([np.cos(ang / 2), np.zeros(k), np.zeros(k), np.sin(ang / 2)], axis=-1)
    tr = np.stack([radius * np.cos(ang), radius * np.sin(ang), np.zeros(k)], axis=-1)
    return np.concatenate([q, tr], axis=-1).astype(np.float32)


def _drifted_problem(seed=0, k=40, noise=0.01):
    """``tests/test_posegraph.py::_drifted_problem``: (gt, init, JAX graph)."""
    gt = jnp.asarray(_circle(k))
    rng = np.random.default_rng(seed)
    meas = jpg.relative_measurement(gt[:-1], gt[1:])
    xi = jnp.asarray(rng.normal(0, noise, (k - 1, 6)), jnp.float32)
    meas_noisy = jse3.compose(jse3.exp(xi), meas)
    poses = [gt[0]]
    for m in meas_noisy:
        poses.append(jse3.compose(poses[-1], m))
    odom = jpg.PoseGraph(
        edge_i=jnp.arange(k - 1, dtype=jnp.int32),
        edge_j=jnp.arange(1, k, dtype=jnp.int32),
        edge_meas=meas_noisy,
        edge_weight=jnp.ones(k - 1, jnp.float32),
        edge_valid=jnp.ones(k - 1, bool),
    )
    loop = jpg.PoseGraph(
        edge_i=jnp.asarray([0], jnp.int32),
        edge_j=jnp.asarray([k - 1], jnp.int32),
        edge_meas=jpg.relative_measurement(gt[0], gt[k - 1])[None],
        edge_weight=jnp.asarray([10.0], jnp.float32),
        edge_valid=jnp.asarray([True]),
    )
    return np.asarray(gt), np.asarray(jnp.stack(poses)), jpg.concat_graphs(odom, loop)


def _assert_graphs_equal(g_port, g_jax, meas_atol=1e-6):
    for name in ("edge_i", "edge_j", "edge_valid"):
        np.testing.assert_array_equal(asnp(getattr(g_port, name)), np.asarray(getattr(g_jax, name)), err_msg=name)
    np.testing.assert_array_equal(asnp(g_port.edge_weight), np.asarray(g_jax.edge_weight))
    np.testing.assert_allclose(asnp(g_port.edge_meas), np.asarray(g_jax.edge_meas), atol=meas_atol)


def test_odometry_edges_and_concat_match():
    _, init, _ = _drifted_problem()
    tg = tpg.odometry_edges(t(init), weight=2.5)
    jg = jpg.odometry_edges(jnp.asarray(init), weight=2.5)
    _assert_graphs_equal(tg, jg)
    assert tg.edge_i.dtype == torch.int32 and tg.edge_weight.dtype == torch.float32
    _assert_graphs_equal(tpg.concat_graphs(tg, graph_to_port(jg)), jpg.concat_graphs(jg, jg))


@pytest.mark.parametrize("capacity", [39, 64, 100])
def test_pad_graph_and_edge_bucket_match(capacity):
    _, init, jg = _drifted_problem()  # 40 edges
    jg = jg._replace(edge_i=jg.edge_i[:39], edge_j=jg.edge_j[:39], edge_meas=jg.edge_meas[:39],
                     edge_weight=jg.edge_weight[:39], edge_valid=jg.edge_valid[:39])
    _assert_graphs_equal(tpg.pad_graph(graph_to_port(jg), capacity), jpg.pad_graph(jg, capacity), meas_atol=0)
    with pytest.raises(ValueError):
        tpg.pad_graph(graph_to_port(jg), 38)
    for n in (0, 1, 63, 64, 65, 1000):
        assert tpg.edge_bucket(n) == jpg.edge_bucket(n)
        assert tpg.edge_bucket(n, minimum=8) == jpg.edge_bucket(n, minimum=8)


def test_graph_helpers_round_trip():
    _, _, jg = _drifted_problem()
    back = graph_to_jax(graph_to_port(jg))
    for a, b in zip(back, jg):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_residuals_match():
    _, init, jg = _drifted_problem(seed=4)
    jg = jg._replace(edge_valid=jg.edge_valid.at[3].set(False))
    got = tpg.residuals(t(init), graph_to_port(jg))
    want = jpg.residuals(jnp.asarray(init), jg)
    np.testing.assert_allclose(asnp(got), np.asarray(want), atol=1e-5)
    assert float(got[3].abs().max()) == 0.0


def test_edge_jacobians_match_jacfwd():
    """J_i, J_j against ``jax.jacfwd`` on random edges and an exact identity
    edge (xi = 0 and a zero residual: every small-angle branch)."""
    rng = np.random.default_rng(1)
    T = np.asarray(jse3.exp(jnp.asarray(rng.normal(0, 0.5, (6, 6)), jnp.float32)))
    M = np.array(jse3.exp(jnp.asarray(rng.normal(0, 0.5, (6, 6)), jnp.float32)))
    Ti, Tj = T, np.roll(T, 1, axis=0).copy()
    Tj[0] = Ti[0]
    M[0] = [1, 0, 0, 0, 0, 0, 0]
    M[1] = np.asarray(jpg.relative_measurement(jnp.asarray(Ti[1]), jnp.asarray(Tj[1])))  # r = 0 up to rounding
    want = jax.vmap(jpg._edge_terms)(jnp.asarray(Ti), jnp.asarray(Tj), jnp.asarray(M))
    got = tpg._edge_terms(t(Ti), t(Tj), t(M))
    for name, g, w in zip(("r", "J_i", "J_j"), got, want):
        assert np.isfinite(asnp(g)).all(), name
        np.testing.assert_allclose(asnp(g), np.asarray(w), atol=1e-5, err_msg=name)
    empty = tpg._edge_terms(t(Ti[:0]), t(Tj[:0]), t(M[:0]))
    assert [tuple(x.shape) for x in empty] == [(0, 6), (0, 6, 6), (0, 6, 6)]


def _bogus_loop():
    return jpg.PoseGraph(
        edge_i=jnp.asarray([5], jnp.int32),
        edge_j=jnp.asarray([30], jnp.int32),
        edge_meas=jse3.exp(jnp.asarray([1.0, -1, 0.5, 0.3, -0.2, 0.4], jnp.float32))[None],
        edge_weight=jnp.asarray([10.0], jnp.float32),
        edge_valid=jnp.asarray([True]),
    )


@pytest.mark.parametrize("case", ["plain", "robust_wrong_loop", "masked", "custom_fixed"])
def test_optimize_pose_graph_matches(case):
    gt, init, jg = _drifted_problem(seed=2)
    kw = dict(num_iterations=10)
    fixed = None
    if case == "robust_wrong_loop":
        jg = jpg.concat_graphs(jg, _bogus_loop())
        kw["robust_delta"] = 0.05
    elif case == "masked":
        jg = jg._replace(
            edge_meas=jg.edge_meas.at[3].set(jse3.exp(jnp.ones(6, jnp.float32))),
            edge_valid=jg.edge_valid.at[3].set(False),
        )
    elif case == "custom_fixed":
        fixed = np.zeros(40, bool)
        fixed[[0, 17, 39]] = True
        kw["num_iterations"] = 12
    want = np.asarray(jpg.optimize_pose_graph(
        jnp.asarray(init), jg, fixed=None if fixed is None else jnp.asarray(fixed), **kw))
    got = asnp(tpg.optimize_pose_graph(
        t(init), graph_to_port(jg), fixed=None if fixed is None else t(fixed), **kw))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4)
    held = [0] if fixed is None else [0, 17, 39]
    # the gauge does not move (the step renormalizes every quaternion)
    np.testing.assert_allclose(got[held], init[held], atol=1e-6)
    if case in ("plain", "robust_wrong_loop"):  # the loop pulls the drift out (tests/test_posegraph.py)
        rmse = np.sqrt(np.mean(np.sum((got[:, 4:7] - gt[:, 4:7]) ** 2, -1)))
        drift0 = np.sqrt(np.mean(np.sum((init[:, 4:7] - gt[:, 4:7]) ** 2, -1)))
        assert rmse < drift0 / 2.5, (rmse, drift0)
    if case == "masked":  # a masked edge's measurement changes nothing
        clean = graph_to_port(jg)._replace(edge_meas=t(np.asarray(_drifted_problem(seed=2)[2].edge_meas)))
        np.testing.assert_allclose(asnp(tpg.optimize_pose_graph(t(init), clean, **kw)), got, atol=1e-6)


def test_optimize_pose_graph_follows_pose_dtype():
    """float64 poses solve in float64, as the reference's ``poses.dtype``."""
    _, init, jg = _drifted_problem(seed=3)
    got = tpg.optimize_pose_graph(t(init).double(), graph_to_port(jg), num_iterations=3)
    assert got.dtype == torch.float64
    want = tpg.optimize_pose_graph(t(init), graph_to_port(jg), num_iterations=3)
    np.testing.assert_allclose(asnp(got), asnp(want), atol=1e-4)
