"""The per-frame tracking step: one RGB-D frame in, one pose out.

Counterpart of ``rgbd_visualodometry_tpu/pipeline/frontend.py``
(``FrontEnd::AddFrame`` and its handlers, ``src/frontend.cpp:45-144``):
ORB -> depth lookup -> nearest keypoints (kernel K2) -> coarse and fine
rounds of gate -> compaction -> RANSAC -> two-round LM -> quality gate and
FSM -> keyframe policy -> keyframe insert, observations, new mappoints and
triangulation.  The branchy decisions stay predicate-masked tensors, so a
step issues its work without waiting on the device; relocalization and
localization-only mode live inside :func:`track_compute` as in the
reference.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from rgbd_visualodometry_tpu_torch import camera as cam_mod
from rgbd_visualodometry_tpu_torch import mapstate
from rgbd_visualodometry_tpu_torch import random as vo_random
from rgbd_visualodometry_tpu_torch.mapstate import INITIALIZING, LOST, TRACKING, VOState
from rgbd_visualodometry_tpu_torch.ops import depth as depth_mod
from rgbd_visualodometry_tpu_torch.ops import image as im
from rgbd_visualodometry_tpu_torch.ops import lm, matching, orb, packing, pnp, se3, triangulate


class FrameInput(NamedTuple):
    rgb: torch.Tensor  # [H, W, 3] uint8
    depth: torch.Tensor  # [H, W] int32 raw depth (the uint16 sensor values)
    timestamp: torch.Tensor  # float32 scalar, seconds since the first frame


class StepOutput(NamedTuple):
    """Per-frame result as ONE packed float32 ``[32]`` record in the
    reference's layout (``frontend.py:66-76``): ``T_c_w`` at 0-6, ``T_w_c``
    at 7-13, then ``_FIELDS``; a frame costs one copy to the host.
    ``viewer`` is the live viewer's payload, set by :func:`track_step`
    under ``cfg.enable_viewer`` (:func:`viewer_payload`), else None."""

    packed: torch.Tensor
    viewer: Optional[torch.Tensor] = None

    _FIELDS = {
        "tracked": 14, "fsm": 15, "is_keyframe": 16, "needs_ba": 17,
        "kf_slot": 18, "num_candidates": 19, "num_matches": 20,
        "num_inliers": 21, "num_final_inliers": 22, "num_new_mappoints": 23,
        "num_triangulated": 24, "num_keyframes": 25, "num_mappoints": 26,
        "kf_overflow": 27, "num_dropped_mappoints": 28,
    }
    SIZE = 32

    @classmethod
    def pack(cls, pose_c_w, pose_w_c, **fields) -> "StepOutput":
        vals = torch.stack([torch.as_tensor(fields[k]).to(torch.float32) for k in cls._FIELDS])
        pad = torch.zeros(cls.SIZE - 14 - len(cls._FIELDS), dtype=torch.float32, device=vals.device)
        return cls(packed=torch.cat([pose_c_w.float(), pose_w_c.float(), vals, pad]))

    # accessors: ``packed[..., i]``, so a batched ``[S, 32]`` record works too
    @property
    def pose_c_w(self) -> torch.Tensor:
        return self.packed[..., 0:7]

    @property
    def pose_w_c(self) -> torch.Tensor:
        return self.packed[..., 7:14]

    def field(self, name: str) -> torch.Tensor:
        """The float32 value of field ``name``."""
        return self.packed[..., self._FIELDS[name]]

    def _flag(self, name):
        return self.field(name) > 0.5

    def _count(self, name):
        return self.field(name).to(torch.int32)

    tracked = property(lambda self: self._flag("tracked"))
    is_keyframe = property(lambda self: self._flag("is_keyframe"))
    needs_ba = property(lambda self: self._flag("needs_ba"))
    kf_overflow = property(lambda self: self._flag("kf_overflow"))
    fsm = property(lambda self: self._count("fsm"))
    kf_slot = property(lambda self: self._count("kf_slot"))
    num_candidates = property(lambda self: self._count("num_candidates"))
    num_matches = property(lambda self: self._count("num_matches"))
    num_inliers = property(lambda self: self._count("num_inliers"))
    num_final_inliers = property(lambda self: self._count("num_final_inliers"))
    num_new_mappoints = property(lambda self: self._count("num_new_mappoints"))
    num_triangulated = property(lambda self: self._count("num_triangulated"))
    num_keyframes = property(lambda self: self._count("num_keyframes"))
    num_mappoints = property(lambda self: self._count("num_mappoints"))
    num_dropped_mappoints = property(lambda self: self._count("num_dropped_mappoints"))


class TrackInter(NamedTuple):
    """What :func:`apply_updates` needs from :func:`track_compute`."""

    xy: torch.Tensor  # [N, 2]
    desc: torch.Tensor  # [N, 8] int32
    kp_valid: torch.Tensor  # [N]
    depth: torch.Tensor  # [N]
    depth_valid: torch.Tensor  # [N]
    midx: torch.Tensor  # [P] matched mappoint slots
    mval: torch.Tensor  # [P]
    kpi: torch.Tensor  # [P] matched keypoint index
    uv: torch.Tensor  # [P, 2]
    ref_inliers: torch.Tensor  # [P] post-LM chi2 inliers
    tmap: torch.Tensor  # [C]
    pose_used: torch.Tensor  # [7]
    is_init: torch.Tensor
    is_kf: torch.Tensor
    do_insert: torch.Tensor
    good: torch.Tensor
    fsm: torch.Tensor
    lost_count: torch.Tensor
    rng: torch.Tensor
    timestamp: torch.Tensor
    num_inliers: torch.Tensor
    num_final_inliers: torch.Tensor
    n_cand: torch.Tensor
    n_match: torch.Tensor


def _match_and_estimate(cfg, camera, state: VOState, nn, feats, kp_cam, dep, tmap, pose, key, is_lost, coarse=False):
    """One round: candidates -> gate -> best-P compaction -> RANSAC -> LM."""
    observable = cam_mod.in_frustum(camera, state.mp_pos, pose, state.mp_norm, cfg.max_observe_angle)
    cand = tmap & observable
    if cfg.enable_relocalization:
        cand = torch.where(is_lost, state.mp_alive, cand)
    mres = matching.gate_matches(nn, cand, cfg.match_ratio, cfg.min_match_distance)
    midx, mval = packing.compact_best_indices(mres.matched, mres.distance, cfg.pnp_max_points)
    p_w = state.mp_pos[midx]
    kpi = mres.kp_index[midx].long()
    uv = feats.xy[kpi]
    p_cam = kp_cam[kpi]
    d_ok = dep.valid[kpi] & mval
    n_hyp = (cfg.coarse_ransac_hypotheses or cfg.ransac_hypotheses) if coarse else cfg.ransac_hypotheses
    lm_iters = (cfg.coarse_pose_ba_iterations or cfg.pose_ba_iterations) if coarse else cfg.pose_ba_iterations
    rr = pnp.ransac_pnp(
        key, p_w, uv, p_cam, d_ok, mval, pose, camera, n_hyp, cfg.ransac_reproj_threshold,
        depth_free_fraction=cfg.ransac_depth_free_fraction,
    )
    ref = lm.refine_pose(rr.pose, p_w, uv, rr.inliers & mval, camera, lm_iters, cfg.huber_delta, cfg.pose_chi2_outlier)
    info = dict(midx=midx, mval=mval, kpi=kpi, uv=uv, rr=rr, ref=ref,
                n_cand=torch.sum(cand), n_match=torch.sum(mres.matched))
    return ref.pose, info


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x))


def track_compute(cfg, camera, state: VOState, frame: FrameInput) -> TrackInter:
    """Read-only half: ORB -> match -> RANSAC/LM -> gates -> FSM."""
    gray = im.rgb_to_gray(frame.rgb)
    feats = orb.extract(
        gray, nfeatures=cfg.number_of_features, nlevels=cfg.level_pyramid,
        scale=cfg.scale_factor, threshold=float(cfg.fast_threshold),
        border=cfg.edge_threshold, angle_bins=cfg.orb_angle_bins,
    )
    dep = depth_mod.lookup_depth(frame.depth, feats.xy, camera.depth_scale)
    kp_cam = cam_mod.pixel2camera(camera, feats.xy, dep.depth)

    is_init = state.fsm == INITIALIZING
    is_tracking = state.fsm == TRACKING
    is_lost = state.fsm == LOST
    keys = vo_random.split(state.rng, 3)
    rng, k1, k2 = keys[0], keys[1], keys[2]

    tmap = state.mp_alive if cfg.localization_only else mapstate.tracking_map_mask(state, cfg)
    # one nearest-keypoint table per frame, shared by both rounds (kernel K2)
    nn = matching.nearest_keypoints_packed(state.mp_desc, feats.desc, feats.valid)
    pose_c, _ = _match_and_estimate(cfg, camera, state, nn, feats, kp_cam, dep, tmap, state.prev_pose, k1, is_lost, coarse=True)
    pose_f, info = _match_and_estimate(cfg, camera, state, nn, feats, kp_cam, dep, tmap, pose_c, k2, is_lost)

    # quality gate (IsGoodEstimation, frontend.cpp:334-351)
    rel = se3.log(se3.relative(state.prev_pose, pose_f))
    motion_ok = _norm(rel) <= cfg.max_motion_norm
    good_track = is_tracking & (info["rr"].num_inliers >= cfg.min_inliers) & motion_ok
    if cfg.enable_relocalization:
        reloc_good = is_lost & (info["ref"].num_final_inliers >= cfg.reloc_min_inliers)
    else:
        reloc_good = torch.zeros_like(is_lost)
    good = good_track | reloc_good

    lost_inc = 2 if cfg.compat_double_lost_increment else 1
    zero = torch.zeros_like(state.lost_count)
    lost_count = torch.where(
        good | is_init, zero,
        torch.where(is_tracking, state.lost_count + lost_inc, state.lost_count),
    )
    fsm = torch.where(
        is_init, torch.full_like(state.fsm, TRACKING),
        torch.where(is_tracking & ~good & (lost_count > cfg.max_num_lost), torch.full_like(state.fsm, LOST), state.fsm),
    )
    fsm = torch.where(reloc_good, torch.full_like(fsm, TRACKING), fsm)

    # keyframe policy (IsKeyframe, frontend.cpp:353-364)
    big_motion = (_norm(rel[3:]) > cfg.keyframe_rotation) | (_norm(rel[:3]) > cfg.keyframe_translation)
    is_kf = (good & big_motion) | reloc_good
    if cfg.localization_only:
        is_kf = torch.zeros_like(is_kf)
        do_insert = is_init
    else:
        do_insert = is_init | is_kf
    pose_used = torch.where(is_init, se3.identity(torch.float32, pose_f.device), pose_f)

    return TrackInter(
        xy=feats.xy, desc=feats.desc, kp_valid=feats.valid, depth=dep.depth, depth_valid=dep.valid,
        midx=info["midx"], mval=info["mval"], kpi=info["kpi"], uv=info["uv"],
        ref_inliers=info["ref"].inliers, tmap=tmap, pose_used=pose_used,
        is_init=is_init, is_kf=is_kf, do_insert=do_insert, good=good,
        fsm=fsm, lost_count=lost_count, rng=rng, timestamp=frame.timestamp,
        num_inliers=info["rr"].num_inliers, num_final_inliers=info["ref"].num_final_inliers,
        n_cand=info["n_cand"], n_match=info["n_match"],
    )


def apply_updates(cfg, camera, state: VOState, it: TrackInter):
    """State-update half: keyframe insert, observations, new mappoints,
    triangulation, bookkeeping.  Returns ``(state, StepOutput)``."""
    C = cfg.max_mappoints
    N = cfg.number_of_features
    pose_used = it.pose_used
    cam_center = cam_mod.camera_center(pose_used)

    state = state.replace(rng=it.rng)
    state, kf_slot, inserted = mapstate.insert_keyframe(
        state, pose_used, it.timestamp, it.do_insert, eviction=cfg.keyframe_eviction
    )
    # a refused insert gates every downstream keyframe update
    is_kf_eff = it.is_kf & inserted
    kf_overflow = it.do_insert & ~inserted

    # observations of the post-LM inliers (frontend.cpp:366-370)
    inlier_packed = it.ref_inliers & it.mval
    inlier_mp, minv = packing.inverse_lookup(C, it.midx, inlier_packed)
    uv_for_mp = it.uv[minv] * inlier_mp[:, None]
    kp_depth = it.depth[it.kpi] * it.depth_valid[it.kpi]
    depth_for_mp = kp_depth[minv] * inlier_mp
    state = mapstate.add_observations(state, kf_slot, inlier_mp, uv_for_mp, cam_center, is_kf_eff, depth_for_mp)

    # new mappoints from depth (frontend.cpp:372-406)
    matched_kp = packing.scatter_back(N, torch.where(inlier_packed, it.kpi, torch.full_like(it.kpi, N)), inlier_packed)
    create_mask = it.kp_valid & it.depth_valid & ~(matched_kp & ~it.is_init)
    p_world_new = cam_mod.pixel2world(camera, it.xy, pose_used, it.depth)
    n_create_req = torch.sum(create_mask & inserted)
    state, n_created = mapstate.create_mappoints(
        state, kf_slot, p_world_new, it.desc, it.xy, create_mask, cam_center, inserted, it.depth
    )

    # triangulation refinement (frontend.cpp:465-506)
    tri_cand = it.tmap & inlier_mp & ~state.mp_triangulated & ~state.mp_optimized & ~state.mp_outlier
    tidx, tval = packing.compact_indices(tri_cand, cfg.triangulation_batch)
    obs_kf = state.obs_kf[tidx]  # [B, M]
    obs_ok = state.obs_valid[tidx] & tval[:, None]
    poses_obs = state.kf_pose[obs_kf.clamp_min(0).long()]  # [B, M, 7]
    norm_xy = cam_mod.pixel2camera(camera, state.obs_uv[tidx], 1.0)[..., :2]
    tri = triangulate.triangulate(
        poses_obs, norm_xy, obs_ok, cfg.triangulation_sv_ratio, cfg.triangulation_min_obs,
        min_baseline=cfg.triangulation_min_baseline,
    )
    tri_ok = tval & tri.ok & (tri.points[:, 2] > 0) & is_kf_eff
    if cfg.compat_single_triangulation:
        tri_ok = tri_ok & (torch.cumsum(tri_ok.to(torch.int64), 0) == 1)
    thit, tinv = packing.inverse_lookup(C, tidx, tri_ok)
    state = state.replace(
        mp_pos=torch.where(thit[:, None], tri.points[tinv], state.mp_pos),
        mp_triangulated=state.mp_triangulated | thit,
    )

    # bookkeeping: the motion prior and reference keyframe advance on
    # keyframes (frontend.cpp:140-141), or on every good frame with a frozen map
    advance = (inserted | it.good) if cfg.localization_only else inserted
    state = state.replace(
        prev_pose=torch.where(advance, pose_used, state.prev_pose),
        ref_kf=torch.where(inserted, kf_slot, state.ref_kf),
        fsm=it.fsm,
        lost_count=it.lost_count,
        frame_index=state.frame_index + 1,
    )
    out = StepOutput.pack(
        pose_used, se3.inverse(pose_used),
        tracked=it.good | it.is_init,
        fsm=it.fsm,
        is_keyframe=is_kf_eff,
        needs_ba=is_kf_eff & bool(cfg.enable_local_optimization),
        kf_slot=kf_slot,
        num_candidates=it.n_cand,
        num_matches=it.n_match,
        num_inliers=it.num_inliers,
        num_final_inliers=it.num_final_inliers,
        num_new_mappoints=n_created,
        num_triangulated=torch.sum(tri_ok),
        num_keyframes=state.num_kf,
        num_mappoints=torch.sum(state.mp_alive),
        kf_overflow=kf_overflow,
        num_dropped_mappoints=n_create_req - n_created,
    )
    return state, out


def viewer_payload(it: TrackInter) -> torch.Tensor:
    """The live viewer's ``[N, 3]`` float32 per keypoint: x, y and 1 where
    the fine round matched it to a mappoint (``frontend.py:348-359``), the
    per-frame overlay of ``viewer.cpp:144-150``."""
    N = it.xy.shape[0]
    matched = packing.scatter_back(N, torch.where(it.mval, it.kpi, torch.full_like(it.kpi, N)), it.mval)
    return torch.cat([it.xy.float(), (matched & it.kp_valid).float()[:, None]], dim=-1)


def track_step(cfg, camera, state: VOState, frame: FrameInput):
    """``(state, frame) -> (state, StepOutput)``.  The viewer payload is
    made here, on the single-stream path only: ``MultiStreamVO`` vmaps
    :func:`track_compute` and :func:`apply_updates`, whose outputs hold no
    optional field."""
    it = track_compute(cfg, camera, state, frame)
    state, out = apply_updates(cfg, camera, state, it)
    if cfg.enable_viewer:
        out = out._replace(viewer=viewer_payload(it))
    return state, out


def frame_input(rgb: np.ndarray, depth: np.ndarray, timestamp, device) -> FrameInput:
    """Host arrays -> a :class:`FrameInput` on ``device``: one frame
    (``[H, W, 3]``, ``[H, W]``, a float) or a batch of S
    (``[S, H, W, 3]``, ``[S, H, W]``, ``[S]``)."""
    return FrameInput(
        rgb=torch.from_numpy(np.ascontiguousarray(rgb, dtype=np.uint8)).to(device),
        depth=torch.from_numpy(np.asarray(depth).astype(np.int32)).to(device),
        timestamp=torch.from_numpy(np.array(timestamp, dtype=np.float64).astype(np.float32)).to(device),
    )
