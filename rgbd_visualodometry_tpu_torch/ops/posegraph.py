"""Batched SE(3) pose-graph optimization (global relaxation).

Counterpart of ``rgbd_visualodometry_tpu/ops/posegraph.py``: keyframe poses
and relative-pose edges (sequential odometry plus loop closures) relaxed by
damped Gauss-Newton on the SE(3) manifold.  Poses are ``T_w_c`` rows
``[K, 7]`` in ``(qw qx qy qz tx ty tz)`` order; the measurement of edge
``(i, j)`` is ``T_i^-1 * T_j``; updates are left-multiplicative,
``T <- exp(xi) * T``.

- Every edge's residual and its two ``[6, 6]`` Jacobians come from one
  forward-mode ``torch.func.jvp`` through the same ``exp``/``log`` chain
  as the reference, vmapped over the tangent directions
  (:func:`_edge_terms`).  Forward mode, as ``jax.jacfwd``:
  at ``xi = 0`` the small-angle branches take ``sqrt(0)``, whose infinite
  derivative the ``torch.where`` drops in forward mode and reverse mode
  would leak as NaN.
- The normal equations assemble into dense ``[K, K, 6, 6]`` blocks with
  four accumulating ``index_put_`` (atomic on CUDA, so float sums vary in
  the last bits) and solve as one dense ``[6K, 6K]`` Cholesky, reading the
  lower triangle as ``jax.scipy.linalg.cho_factor`` does (no
  symmetrisation).
- The iteration count is fixed; ``lax.fori_loop`` becomes a Python loop.

Known limitation (``tests/test_posegraph.py``): edge weights must stay
bounded relative to the odometry chain; a wrong edge whose weight dwarfs
everything else captures the IRLS iteration.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rgbd_visualodometry_tpu_torch.ops import se3


class PoseGraph(NamedTuple):
    """An edge list for one pose graph."""

    edge_i: torch.Tensor  # [E] int32
    edge_j: torch.Tensor  # [E] int32
    edge_meas: torch.Tensor  # [E, 7] measured T_i^-1 * T_j
    edge_weight: torch.Tensor  # [E] float32 (information scale)
    edge_valid: torch.Tensor  # [E] bool


def odometry_edges(poses: torch.Tensor, weight: float = 1.0) -> PoseGraph:
    """Sequential edges (k, k+1) measuring the trajectory's own motion."""
    k = poses.shape[0]
    i = torch.arange(k - 1, dtype=torch.int32, device=poses.device)
    return PoseGraph(
        edge_i=i,
        edge_j=i + 1,
        edge_meas=relative_measurement(poses[:-1], poses[1:]),
        edge_weight=torch.full((k - 1,), weight, dtype=torch.float32, device=poses.device),
        edge_valid=torch.ones((k - 1,), dtype=torch.bool, device=poses.device),
    )


def relative_measurement(pose_i: torch.Tensor, pose_j: torch.Tensor) -> torch.Tensor:
    """``T_i^{-1} * T_j`` - the measurement an edge (i, j) stores."""
    return se3.compose(se3.inverse(pose_i), pose_j)


def concat_graphs(a: PoseGraph, b: PoseGraph) -> PoseGraph:
    return PoseGraph(*(torch.cat([x, y]) for x, y in zip(a, b)))


def pad_graph(graph: PoseGraph, capacity: int) -> PoseGraph:
    """The edge list padded to exactly ``capacity`` rows with zero-weight,
    invalid identity edges, which change no sum.  The JAX package pads so
    that XLA reuses one compiled solver; the port's solver needs no padding
    and does not call this."""
    e = int(graph.edge_i.shape[0])
    if e > capacity:
        raise ValueError(f"graph has {e} edges > capacity {capacity}")
    pad = capacity - e
    if pad == 0:
        return graph
    dev = graph.edge_meas.device
    ident = se3.identity(graph.edge_meas.dtype, dev).repeat(pad, 1)
    zeros_i = torch.zeros((pad,), dtype=torch.int32, device=dev)
    return PoseGraph(
        edge_i=torch.cat([graph.edge_i, zeros_i]),
        edge_j=torch.cat([graph.edge_j, zeros_i]),
        edge_meas=torch.cat([graph.edge_meas, ident]),
        edge_weight=torch.cat([graph.edge_weight, graph.edge_weight.new_zeros(pad)]),
        edge_valid=torch.cat([graph.edge_valid, torch.zeros((pad,), dtype=torch.bool, device=dev)]),
    )


def edge_bucket(n: int, minimum: int = 64) -> int:
    """Smallest power of two >= n (and >= ``minimum``): the JAX package's
    padding bucket."""
    cap = int(minimum)
    while cap < n:
        cap *= 2
    return cap


def _edge_residual(xi_i, xi_j, T_i, T_j, meas):
    """r = log(meas^{-1} * (exp(xi_i) T_i)^{-1} * (exp(xi_j) T_j)) in R^6."""
    Ti = se3.compose(se3.exp(xi_i), T_i)
    Tj = se3.compose(se3.exp(xi_j), T_j)
    return se3.log(se3.compose(se3.inverse(meas), se3.compose(se3.inverse(Ti), Tj)))


def _edge_terms(T_i, T_j, meas):
    """Residuals ``r [E, 6]`` and Jacobians ``J_i``, ``J_j [E, 6, 6]`` of
    edges ``[E, 7]`` at xi = 0: one forward-mode ``jvp`` of the batched
    residual, vmapped over the 12 tangent basis directions of ``(xi_i,
    xi_j)``.  (A ``jacfwd`` vmapped over edges would work per edge on 0-dim
    angles, whose forward-mode ops with a Python scalar promote the tangent
    to float64 in torch.)"""
    E = T_i.shape[0]
    zero = T_i.new_zeros((E, 6))
    if E == 0:
        return zero, T_i.new_zeros((0, 6, 6)), T_i.new_zeros((0, 6, 6))
    basis = torch.eye(12, dtype=T_i.dtype, device=T_i.device)[:, None, :].expand(12, E, 12)

    def column(v):
        return torch.func.jvp(
            lambda a, b: _edge_residual(a, b, T_i, T_j, meas), (zero, zero), (v[..., :6], v[..., 6:])
        )

    r, J = torch.func.vmap(column, out_dims=(None, 0))(basis)
    J = J.permute(1, 2, 0)  # [E, 6 residual, 12 tangent]
    return r, J[..., :6], J[..., 6:]


def residuals(poses: torch.Tensor, graph: PoseGraph) -> torch.Tensor:
    """[E, 6] edge residuals at the current poses (masked edges -> 0)."""
    zero = poses.new_zeros(6)
    ei, ej = graph.edge_i.long(), graph.edge_j.long()
    r = _edge_residual(zero, zero, poses[ei], poses[ej], graph.edge_meas)
    return torch.where(graph.edge_valid[:, None], r, torch.zeros_like(r))


def optimize_pose_graph(
    poses: torch.Tensor,  # [K, 7]
    graph: PoseGraph,
    num_iterations: int = 10,
    damping: float = 1e-6,
    robust_delta: float = 0.0,  # 0 = plain quadratic loss
    fixed: torch.Tensor | None = None,  # [K] bool; default: pose 0 (gauge)
) -> torch.Tensor:
    """Damped Gauss-Newton relaxation; returns refined ``[K, 7]`` poses.

    ``robust_delta > 0`` turns on the reference's two outlier mechanisms:
    the redescending IRLS weight ``min(1, 2d^2/(d^2 + ||r||^2))`` per edge,
    and after ``num_iterations // 2`` iterations the prune of every edge
    whose residual norm still exceeds ``3 * robust_delta``
    (``src/backend.cpp:139-172``); the rest of the iterations run without
    them."""
    k = poses.shape[0]
    dev, dt = poses.device, poses.dtype
    if fixed is None:
        fixed = torch.arange(k, device=dev) == 0
    fixed = fixed.to(device=dev, dtype=torch.bool)
    free = (~fixed).to(dt)
    graph = graph._replace(
        edge_meas=graph.edge_meas.to(dt), edge_weight=graph.edge_weight.to(dt), edge_valid=graph.edge_valid.to(torch.bool)
    )
    ei, ej = graph.edge_i.long(), graph.edge_j.long()
    eye = torch.eye(6 * k, dtype=dt, device=dev)
    fixed_diag = torch.diag(fixed.to(dt).repeat_interleave(6))

    def step(cur, valid):
        r, J_i, J_j = _edge_terms(cur[ei], cur[ej], graph.edge_meas)
        w = graph.edge_weight * valid.to(dt)
        if robust_delta > 0.0:
            chi2 = torch.sum(r * r, dim=-1)
            d2 = robust_delta * robust_delta
            w = w * torch.clamp_max(2.0 * d2 / (d2 + chi2), 1.0)
        JiT, JjT = J_i.mT, J_j.mT
        w_ = w[:, None, None]
        H_ii = w_ * (JiT @ J_i)
        H_ij = w_ * (JiT @ J_j)
        H_jj = w_ * (JjT @ J_j)
        b_i = w[:, None] * torch.einsum("eba,eb->ea", J_i, r)
        b_j = w[:, None] * torch.einsum("eba,eb->ea", J_j, r)

        Hb = torch.zeros((k, k, 6, 6), dtype=dt, device=dev)
        Hb.index_put_((ei, ei), H_ii, accumulate=True)
        Hb.index_put_((ei, ej), H_ij, accumulate=True)
        Hb.index_put_((ej, ei), H_ij.mT, accumulate=True)
        Hb.index_put_((ej, ej), H_jj, accumulate=True)
        bb = torch.zeros((k, 6), dtype=dt, device=dev)
        bb.index_put_((ei,), b_i, accumulate=True)
        bb.index_put_((ej,), b_j, accumulate=True)

        # gauge: zero fixed rows/cols, unit diagonal keeps H SPD
        fm = free[:, None] * free[None, :]
        Hb = Hb * fm[:, :, None, None]
        bb = bb * free[:, None]
        H = Hb.permute(0, 2, 1, 3).reshape(6 * k, 6 * k)
        H = H + (damping + 1e-9) * eye + fixed_diag
        L, _ = torch.linalg.cholesky_ex(H)
        delta = -torch.cholesky_solve(bb.reshape(-1, 1), L).reshape(k, 6)
        delta = delta * free[:, None]
        return se3.normalize(se3.compose(se3.exp(delta), cur))

    if robust_delta <= 0.0:
        cur = poses
        for _ in range(num_iterations):
            cur = step(cur, graph.edge_valid)
        return cur

    half = max(1, num_iterations // 2)
    mid = poses
    for _ in range(half):  # round 1: soft redescending weights
        mid = step(mid, graph.edge_valid)
    # prune the edges still inconsistent after relaxation (two-round
    # scheme of src/backend.cpp:139-172), then re-optimize without them
    r_mid = residuals(mid, graph)
    keep = graph.edge_valid & (torch.linalg.vector_norm(r_mid, dim=-1) <= 3.0 * robust_delta)
    cur = mid
    for _ in range(num_iterations - half):
        cur = step(cur, keep)
    return cur
