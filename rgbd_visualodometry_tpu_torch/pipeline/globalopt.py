"""Global map refinement: loop-closure graph + SE(3) relaxation.

Counterpart of ``rgbd_visualodometry_tpu/pipeline/globalopt.py``.  On a
live ``VOState`` it joins:

1. ``ops/loopclosure.build_coobservation_graph`` - relative-pose edges from
   every keyframe pair sharing depth-valid observations (revisits
   included);
2. ``ops/loopclosure.build_appearance_graph`` (``appearance=True``) -
   place-recognition edges for revisits that duplicated landmarks;
3. ``ops/posegraph.optimize_pose_graph`` - robust damped Gauss-Newton on
   the whole keyframe graph.

After relaxation the map deforms rigidly with its anchors: every mappoint
moves with the keyframe of its first observation, and the tracking
reference (``prev_pose``) with the reference keyframe, so a mid-run
relaxation hands tracking a coherent world.  Everything runs on the
device of the state it is given.

Typical use::

    vo.run(frames, trajectory_path="traj.txt")
    report = vo.global_relax()
    # report.kf_ts / old_T_w_k / new_T_w_k feed correct_trajectory()
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from rgbd_visualodometry_tpu_torch.camera import Camera
from rgbd_visualodometry_tpu_torch.ops import loopclosure, posegraph, se3


@dataclass
class RelaxReport:
    """What the relaxation did, plus the keyframe delta table needed to
    correct an already-written per-frame trajectory."""

    num_edges: int  # co-observation edges in the graph
    num_loop_edges: int  # of those, spanning > loop_gap_s (true closures)
    num_chain_edges: int  # odometry insurance edges added
    mean_correction_m: float  # camera-center shift over valid keyframes
    max_correction_m: float
    # valid keyframes sorted by timestamp (offsets from the first staged
    # frame, see VisualOdometry.time_base):
    kf_ts: np.ndarray  # [V]
    old_T_w_k: np.ndarray  # [V, 7]
    new_T_w_k: np.ndarray  # [V, 7]
    # appearance loop edges for keyframe pairs without co-observations
    num_appearance_edges: int = 0
    # [E, 2, 3] post-relax world camera centers of the loop constraints
    # (co-obs pairs spanning > loop_gap_s + appearance pairs)
    loop_pairs_w: np.ndarray = None


def _noop_report() -> RelaxReport:
    return RelaxReport(
        0, 0, 0, 0.0, 0.0,
        np.zeros((0,), np.float64),
        np.zeros((0, 7), np.float32),
        np.zeros((0, 7), np.float32),
        loop_pairs_w=np.zeros((0, 2, 3), np.float32),
    )


@dataclass
class Relaxation:
    """A computed, not yet applied relaxation: the per-keyframe-slot world
    correction table plus the report.  ``compute_relaxation`` runs on a
    snapshot of the state (on a worker thread when the relax is
    asynchronous) and ``apply_relaxation`` later deforms whatever the live
    state has become - the reference backend's "latest wins" contract
    (``include/myslam/backend.h:33-37``) applied to loop closure."""

    report: RelaxReport
    delta_w: torch.Tensor  # [K, 7] per-slot world delta (identity if invalid)
    snap_valid: torch.Tensor  # [K] bool keyframe validity at snapshot time
    snap_ts: torch.Tensor  # [K] f32 keyframe timestamps at snapshot time
    ref_delta_w: torch.Tensor  # [7] delta of the newest snapshot keyframe


def _noop_relaxation(K: int, device=None) -> Relaxation:
    ident = se3.identity(torch.float32, device)
    return Relaxation(
        report=_noop_report(),
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
    touching the state.  Returns a :class:`Relaxation` (a no-op one, with
    an empty ``report.kf_ts``, when there is nothing to do).

    - The temporally first valid keyframe is the gauge (fixed), as the
      backend fixes the first frame of its window (``src/backend.cpp:60-63``).
    - Consecutive-in-time keyframe pairs without a co-observation edge get
      an odometry edge holding the current relative estimate, so the graph
      stays connected.
    - ``robust_delta`` drives the solver's redescending kernel and chi2
      prune.
    - ``require_loop=True`` makes the relaxation a no-op unless at least one
      loop edge (co-observation spanning > ``loop_gap_s``, or appearance)
      exists: without one the graph holds only short-gap edges, whose
      Kabsch measurements are noisier than the BA-refined poses.  The
      online (mid-run) path always sets it.
    """
    dev = state.kf_pose.device
    kf_valid = state.kf_valid.cpu().numpy()
    K = kf_valid.shape[0]
    slots = np.nonzero(kf_valid)[0]
    if slots.size < 2:
        return _noop_relaxation(K, dev)

    cam = Camera.from_config(cfg)
    graph = loopclosure.build_coobservation_graph(
        state, cam, min_shared=min_shared, max_pair_weight=max_pair_weight
    )
    poses_w = se3.inverse(state.kf_pose)  # [K, 7] T_w_c

    ts = state.kf_timestamp.cpu().numpy().astype(np.float64)
    order = slots[np.argsort(ts[slots], kind="stable")]

    num_coobs = int(graph.edge_i.shape[0])
    loop_ij: list = []
    if num_coobs:
        gi, gj = graph.edge_i.cpu().numpy(), graph.edge_j.cpu().numpy()
        is_loop = np.abs(ts[gi] - ts[gj]) > loop_gap_s
        num_loop = int(np.sum(is_loop))
        loop_ij += list(zip(gi[is_loop].tolist(), gj[is_loop].tolist()))
        have = set(zip(gi.tolist(), gj.tolist()))
    else:
        num_loop = 0
        have = set()

    num_app = 0
    if appearance:
        app = loopclosure.build_appearance_graph(
            state, cam,
            loop_gap_s=loop_gap_s,
            min_inliers=appearance_min_inliers,
            max_pair_weight=max_pair_weight,
            exclude=have,
        )
        num_app = int(app.edge_i.shape[0])
        if num_app:
            ai, aj = app.edge_i.cpu().numpy(), app.edge_j.cpu().numpy()
            loop_ij += list(zip(ai.tolist(), aj.tolist()))
            have |= set(zip(ai.tolist(), aj.tolist()))
            graph = posegraph.concat_graphs(graph, app)

    if require_loop and num_loop + num_app == 0:
        # nothing to close: leave the BA-refined poses untouched but still
        # report what was detected
        rlx = _noop_relaxation(K, dev)
        rlx.report.num_edges = num_coobs
        return rlx

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
    relaxed_w = posegraph.optimize_pose_graph(
        poses_w,
        graph,
        num_iterations=num_iterations,
        robust_delta=robust_delta,
        fixed=torch.from_numpy(fixed).to(dev),
    )
    valid_dev = state.kf_valid
    relaxed_w = torch.where(valid_dev[:, None], relaxed_w, poses_w)

    # the per-slot correction table (identity on invalid slots); the newest
    # snapshot keyframe's delta anchors everything created after the
    # snapshot when the relaxation is applied asynchronously
    delta_w = se3.compose(relaxed_w, se3.inverse(poses_w))  # [K, 7]
    delta_w = torch.where(valid_dev[:, None], delta_w, se3.identity(torch.float32, dev)[None, :])
    ref_delta_w = delta_w[int(order[-1])]

    old_w = poses_w.cpu().numpy()
    new_w = relaxed_w.cpu().numpy()
    shift = np.linalg.norm(new_w[slots, 4:7] - old_w[slots, 4:7], axis=1)
    if loop_ij:
        li = np.asarray([p[0] for p in loop_ij])
        lj = np.asarray([p[1] for p in loop_ij])
        loop_pairs = np.stack([new_w[li, 4:7], new_w[lj, 4:7]], axis=1)
    else:
        loop_pairs = np.zeros((0, 2, 3), np.float32)
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
        loop_pairs_w=loop_pairs,
    )
    return Relaxation(
        report=report,
        delta_w=delta_w,
        snap_valid=valid_dev.clone(),
        snap_ts=state.kf_timestamp.clone(),
        ref_delta_w=ref_delta_w,
    )


def _apply_relaxation_arrays(
    kf_pose, kf_valid, kf_timestamp, obs_kf, obs_valid, mp_pos, mp_valid,
    ref_kf, prev_pose, delta_w, snap_valid, snap_ts, ref_delta_w,
):
    """Deform the live pools by the per-slot deltas; returns ``(kf_pose,
    mp_pos, prev_pose)``.

    Keyframe slots still holding the same keyframe as at snapshot time
    (valid then and now, identical timestamp: slots are written once per
    keyframe, so the timestamp identifies the occupant) get their own
    delta; slots created or recycled after the snapshot move rigidly with
    the snapshot's newest keyframe.  Mappoints move with their
    first-observation keyframe, the tracking prior with the reference
    keyframe.
    """
    K = kf_pose.shape[0]
    same = kf_valid & snap_valid & (kf_timestamp == snap_ts)
    slot_delta = torch.where(same[:, None], delta_w, ref_delta_w[None, :])  # [K, 7]

    new_w = se3.compose(slot_delta, se3.inverse(kf_pose))
    kf_pose2 = torch.where(kf_valid[:, None], se3.inverse(new_w), kf_pose)

    # mappoints follow their anchor keyframe ([C, M] rows): the first valid
    # observation slot, the first index on ties as jnp.argmax takes it
    anchor_m = torch.argmax(obs_valid.to(torch.uint8), dim=1)
    has_obs = torch.any(obs_valid, dim=1)
    anchor_kf = torch.gather(obs_kf, 1, anchor_m[:, None])[:, 0].clamp(0, K - 1).long()
    mp_pos2 = torch.where(
        (has_obs & mp_valid)[:, None], se3.apply(slot_delta[anchor_kf], mp_pos), mp_pos
    )
    ref_delta = slot_delta[ref_kf.clamp(0, K - 1).long()]
    prev_pose2 = se3.inverse(se3.compose(ref_delta, se3.inverse(prev_pose)))
    return kf_pose2, mp_pos2, prev_pose2


def apply_relaxation(state, rlx: Relaxation):
    """Deform a (possibly newer) live state by a computed relaxation."""
    if rlx.report.kf_ts.size == 0:
        return state
    kf_pose, mp_pos, prev_pose = _apply_relaxation_arrays(
        state.kf_pose, state.kf_valid, state.kf_timestamp,
        state.obs_kf, state.obs_valid, state.mp_pos, state.mp_valid,
        state.ref_kf, state.prev_pose,
        rlx.delta_w, rlx.snap_valid, rlx.snap_ts, rlx.ref_delta_w,
    )
    return state.replace(kf_pose=kf_pose, mp_pos=mp_pos, prev_pose=prev_pose)


def relax_map(state, cfg, **kwargs):
    """Synchronous relax-and-apply (the offline API): compute the
    relaxation from ``state`` and deform the same state.  Returns
    ``(new_state, RelaxReport)``."""
    rlx = compute_relaxation(state, cfg, **kwargs)
    return apply_relaxation(state, rlx), rlx.report


def correct_trajectory(report: RelaxReport, frame_ts: np.ndarray, poses_w_c: np.ndarray) -> np.ndarray:
    """Apply a relaxation to a per-frame trajectory: each frame moves
    rigidly with its reference keyframe (the most recent keyframe at or
    before it; frames before the first keyframe use the first).

    ``frame_ts`` are offsets from the first staged frame (the clock of
    ``RelaxReport.kf_ts``); ``poses_w_c`` are ``[N, 7]`` T_w_c rows.
    Host numpy in and out, float32 arithmetic on the CPU.
    """
    if report.kf_ts.size == 0:
        return np.asarray(poses_w_c)
    idx = np.searchsorted(report.kf_ts, np.asarray(frame_ts) + 1e-6) - 1
    idx = np.clip(idx, 0, report.kf_ts.size - 1)
    old_w = torch.from_numpy(np.asarray(report.old_T_w_k[idx], np.float32))
    new_w = torch.from_numpy(np.asarray(report.new_T_w_k[idx], np.float32))
    delta = se3.compose(new_w, se3.inverse(old_w))
    return se3.compose(delta, torch.from_numpy(np.asarray(poses_w_c, np.float32))).numpy()
