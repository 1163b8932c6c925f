"""Global map refinement: loop-closure graph + SE(3) relaxation.

Counterpart of ``rgbd_visualodometry_tpu/pipeline/globalopt.py``: on a
``VOState`` it joins the co-observation edges, the appearance edges and an
odometry chain for keyframes otherwise unconnected, relaxes the whole
keyframe graph (``ops/posegraph.optimize_pose_graph``, eager and
unpadded), and deforms the map rigidly with its anchors: every mappoint
with the keyframe of its first observation, the tracking reference
(``prev_pose``) with the reference keyframe.  :func:`correct_trajectory`
moves per-frame poses with their reference keyframes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from vobench.reference.camera import Camera
from vobench.reference.ops import loopclosure, posegraph, se3


@dataclass
class RelaxReport:
    num_edges: int  # co-observation edges in the graph
    num_loop_edges: int  # of those, spanning > loop_gap_s
    num_chain_edges: int  # odometry edges added
    mean_correction_m: float  # camera-center shift over valid keyframes
    max_correction_m: float
    kf_ts: np.ndarray  # [V] valid keyframes' timestamps, sorted
    old_T_w_k: np.ndarray  # [V, 7]
    new_T_w_k: np.ndarray  # [V, 7]
    num_appearance_edges: int = 0


@dataclass
class Relaxation:
    """A computed relaxation: the per-keyframe-slot world correction table
    and the report."""

    report: RelaxReport
    delta_w: torch.Tensor  # [K, 7] per-slot world delta (identity if invalid)
    snap_valid: torch.Tensor  # [K] bool keyframe validity at snapshot time
    snap_ts: torch.Tensor  # [K] f32 keyframe timestamps at snapshot time
    ref_delta_w: torch.Tensor  # [7] delta of the newest snapshot keyframe


def _noop_relaxation(K: int, device=None, num_edges: int = 0) -> Relaxation:
    ident = se3.identity(torch.float32, device)
    report = RelaxReport(num_edges, 0, 0, 0.0, 0.0, np.zeros((0,), np.float64), np.zeros((0, 7), np.float32),
                         np.zeros((0, 7), np.float32))
    return Relaxation(
        report=report,
        delta_w=ident.repeat(K, 1),
        snap_valid=torch.zeros((K,), dtype=torch.bool, device=device),
        snap_ts=torch.zeros((K,), dtype=torch.float32, device=device),
        ref_delta_w=ident,
    )


def compute_relaxation(
    state,
    cfg,
    *,
    min_shared: int = 8,
    max_pair_weight: float = 30.0,
    odometry_weight: float = 30.0,
    num_iterations: int = 12,
    robust_delta: float = 0.05,
    loop_gap_s: float = 5.0,
    appearance: bool = True,
    appearance_min_inliers: int = 12,
    require_loop: bool = False,
) -> Relaxation:
    """Build the loop-closure graph and solve the relaxation without
    touching the state (a no-op :class:`Relaxation`, with an empty
    ``report.kf_ts``, when there is nothing to do).  The temporally first
    valid keyframe is the gauge; consecutive-in-time keyframe pairs without
    an edge get an odometry edge holding the current relative estimate;
    ``require_loop`` makes it a no-op unless a loop edge (co-observation
    spanning > ``loop_gap_s``, or appearance) exists."""
    dev = state.kf_pose.device
    kf_valid = state.kf_valid.cpu().numpy()
    K = kf_valid.shape[0]
    slots = np.nonzero(kf_valid)[0]
    if slots.size < 2:
        return _noop_relaxation(K, dev)

    cam = Camera.from_config(cfg)
    graph = loopclosure.build_coobservation_graph(state, cam, min_shared=min_shared, max_pair_weight=max_pair_weight)
    poses_w = se3.inverse(state.kf_pose)  # [K, 7] T_w_c

    ts = state.kf_timestamp.cpu().numpy().astype(np.float64)
    order = slots[np.argsort(ts[slots], kind="stable")]

    num_coobs = int(graph.edge_i.shape[0])
    if num_coobs:
        gi, gj = graph.edge_i.cpu().numpy(), graph.edge_j.cpu().numpy()
        num_loop = int(np.sum(np.abs(ts[gi] - ts[gj]) > loop_gap_s))
        have = set(zip(gi.tolist(), gj.tolist()))
    else:
        num_loop = 0
        have = set()

    num_app = 0
    if appearance:
        app = loopclosure.build_appearance_graph(state, cam, loop_gap_s=loop_gap_s, min_inliers=appearance_min_inliers,
                                                 max_pair_weight=max_pair_weight, exclude=have)
        num_app = int(app.edge_i.shape[0])
        if num_app:
            ai, aj = app.edge_i.cpu().numpy(), app.edge_j.cpu().numpy()
            have |= set(zip(ai.tolist(), aj.tolist()))
            graph = posegraph.concat_graphs(graph, app)

    if require_loop and num_loop + num_app == 0:
        return _noop_relaxation(K, dev, num_edges=num_coobs)

    chain = []
    for a, b in zip(order[:-1], order[1:]):
        i, j = (int(a), int(b)) if a < b else (int(b), int(a))
        if (i, j) not in have:
            chain.append((i, j))
    if chain:
        ci = torch.tensor([c[0] for c in chain], dtype=torch.int32, device=dev)
        cj = torch.tensor([c[1] for c in chain], dtype=torch.int32, device=dev)
        graph = posegraph.concat_graphs(graph, posegraph.PoseGraph(
            edge_i=ci,
            edge_j=cj,
            edge_meas=posegraph.relative_measurement(poses_w[ci.long()], poses_w[cj.long()]),
            edge_weight=torch.full((len(chain),), odometry_weight, dtype=torch.float32, device=dev),
            edge_valid=torch.ones((len(chain),), dtype=torch.bool, device=dev),
        ))
    if int(graph.edge_i.shape[0]) == 0:
        return _noop_relaxation(K, dev)

    fixed = ~kf_valid
    fixed[order[0]] = True  # earliest keyframe anchors the world (gauge)
    relaxed_w = posegraph.optimize_pose_graph(poses_w, graph, num_iterations=num_iterations, robust_delta=robust_delta,
                                              fixed=torch.from_numpy(fixed).to(dev))
    valid_dev = state.kf_valid
    relaxed_w = torch.where(valid_dev[:, None], relaxed_w, poses_w)

    delta_w = se3.compose(relaxed_w, se3.inverse(poses_w))  # [K, 7]
    delta_w = torch.where(valid_dev[:, None], delta_w, se3.identity(torch.float32, dev)[None, :])
    ref_delta_w = delta_w[int(order[-1])]

    old_w = poses_w.cpu().numpy()
    new_w = relaxed_w.cpu().numpy()
    shift = np.linalg.norm(new_w[slots, 4:7] - old_w[slots, 4:7], axis=1)
    report = RelaxReport(
        num_edges=num_coobs,
        num_loop_edges=num_loop,
        num_chain_edges=len(chain),
        mean_correction_m=float(shift.mean()),
        max_correction_m=float(shift.max()),
        kf_ts=ts[order],
        old_T_w_k=old_w[order],
        new_T_w_k=new_w[order],
        num_appearance_edges=num_app,
    )
    return Relaxation(report=report, delta_w=delta_w, snap_valid=valid_dev.clone(),
                      snap_ts=state.kf_timestamp.clone(), ref_delta_w=ref_delta_w)


def apply_relaxation(state, rlx: Relaxation):
    """Deform a (possibly newer) state by a computed relaxation.

    Keyframe slots still holding the keyframe they held at snapshot time
    (valid then and now, the same timestamp) get their own delta; slots
    filled after the snapshot move with the snapshot's newest keyframe.
    Mappoints move with their first-observation keyframe, the tracking
    prior with the reference keyframe."""
    if rlx.report.kf_ts.size == 0:
        return state
    kf_pose, kf_valid = state.kf_pose, state.kf_valid
    K = kf_pose.shape[0]
    same = kf_valid & rlx.snap_valid & (state.kf_timestamp == rlx.snap_ts)
    slot_delta = torch.where(same[:, None], rlx.delta_w, rlx.ref_delta_w[None, :])  # [K, 7]

    new_w = se3.compose(slot_delta, se3.inverse(kf_pose))
    kf_pose2 = torch.where(kf_valid[:, None], se3.inverse(new_w), kf_pose)

    # the anchor: the first valid observation slot of each mappoint row
    anchor_m = torch.argmax(state.obs_valid.to(torch.uint8), dim=1)
    has_obs = torch.any(state.obs_valid, dim=1)
    anchor_kf = torch.gather(state.obs_kf, 1, anchor_m[:, None])[:, 0].clamp(0, K - 1).long()
    mp_pos2 = torch.where((has_obs & state.mp_valid)[:, None], se3.apply(slot_delta[anchor_kf], state.mp_pos),
                          state.mp_pos)
    ref_delta = slot_delta[state.ref_kf.clamp(0, K - 1).long()]
    prev_pose2 = se3.inverse(se3.compose(ref_delta, se3.inverse(state.prev_pose)))
    return state.replace(kf_pose=kf_pose2, mp_pos=mp_pos2, prev_pose=prev_pose2)


def correct_trajectory(report: RelaxReport, frame_ts: np.ndarray, poses_w_c: np.ndarray) -> np.ndarray:
    """Move each per-frame ``T_w_c`` row rigidly with its reference keyframe
    (the most recent keyframe at or before it; frames before the first
    keyframe use the first): float32 arithmetic on the CPU."""
    if report.kf_ts.size == 0:
        return np.asarray(poses_w_c)
    idx = np.searchsorted(report.kf_ts, np.asarray(frame_ts) + 1e-6) - 1
    idx = np.clip(idx, 0, report.kf_ts.size - 1)
    old_w = torch.from_numpy(np.asarray(report.old_T_w_k[idx], np.float32))
    new_w = torch.from_numpy(np.asarray(report.new_T_w_k[idx], np.float32))
    delta = se3.compose(new_w, se3.inverse(old_w))
    return se3.compose(delta, torch.from_numpy(np.asarray(poses_w_c, np.float32))).numpy()
