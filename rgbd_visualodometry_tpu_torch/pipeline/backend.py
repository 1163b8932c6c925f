"""Local bundle adjustment over the covisible window.

Counterpart of ``rgbd_visualodometry_tpu/pipeline/backend.py``
(``Backend::Optimize``, ``src/backend.cpp:19-195``): the current keyframe
and up to ``ba_max_poses - 1`` covisible keyframes by weight (slot 0 held
fixed), the best-constrained ``ba_max_points`` mappoints they observe, two
LM rounds of ``ba_iterations`` (Huber, then plain with chi2 > chi2_th edges
out) on the explicit Schur complement, the always-Huber depth prior, and
the write-back that removes pruned observations from the map.

Where the JAX package works around the TPU, the port computes the same
result directly:

- the observer-pose gather is ``poses_w[o_wpos]`` and the reductions into
  pose space (``U``, ``gp``, ``Wt``) are ``index_add_``/``scatter_add_``
  over the window position, where the reference multiplies by one-hot
  matrices.  On CUDA these sums use atomics, so float results vary in the
  last bits from run to run;
- ``jax.lax.while_loop``'s early exit becomes ``ba_iterations`` steps whose
  ``done`` flag freezes the whole iterate (poses, points, lambda, cost), as
  in ``ops/lm.py``: the same result, with no host read per iteration;
- the writes into fresh tensors (window positions, pose sums, the Schur
  block diagonal) are out of place, so the step runs under
  ``torch.func.vmap`` over a stack of states (``parallel/mesh.py``);
- ``torch.linalg.cholesky_ex`` does not synchronise, and where it reports a
  matrix that is not positive definite (``info > 0``) the step is rejected,
  as the NaN factor of ``jnp.linalg.cholesky`` rejects it in the reference.

``ba_bf16`` casts the per-edge Jacobians and weights to bfloat16 at the
reference's points (``backend.py:271-275``) and sums the outer products in
float32.  bf16 rounds at other places in torch than in XLA, so the two agree
tightly only with ``ba_bf16=False``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rgbd_visualodometry_tpu_torch import camera as cam_mod
from rgbd_visualodometry_tpu_torch import mapstate
from rgbd_visualodometry_tpu_torch.mapstate import VOState
from rgbd_visualodometry_tpu_torch.ops import lm as lm_ops
from rgbd_visualodometry_tpu_torch.ops import packing, se3
from rgbd_visualodometry_tpu_torch.ops.smalleig import inv3x3

_INT32_MAX = 2**31 - 1


class BAProblem(NamedTuple):
    # window poses
    widx: torch.Tensor  # [P] keyframe slots in the window
    wval: torch.Tensor  # [P] bool
    wfixed: torch.Tensor  # [P] bool, held constant (slot 0)
    # points
    pidx: torch.Tensor  # [MB] mappoint slots
    pval: torch.Tensor  # [MB] bool
    # observations, per point [MB, M]
    o_uv: torch.Tensor  # [MB, M, 2] measured pixel
    o_depth: torch.Tensor  # [MB, M] measured depth, 0 = none
    o_valid: torch.Tensor  # [MB, M] bool
    o_pose_free: torch.Tensor  # [MB, M] bool: pose Jacobian active
    o_wpos: torch.Tensor  # [MB, M] int64 window position of a free edge, P otherwise
    fixed_poses: torch.Tensor  # [MB, M, 7] observer poses from the map


def build_problem(cfg, state: VOState, kf) -> BAProblem:
    """The window, the points and their observations for keyframe ``kf``
    (an int or a 0-d integer tensor)."""
    K = state.kf_pose.shape[0]
    M = state.obs_kf.shape[1]
    P, MB = min(cfg.ba_max_poses, K), cfg.ba_max_points
    dev = state.kf_pose.device
    kf = torch.as_tensor(kf, device=dev).long()
    is_kf = torch.arange(K, device=dev) == kf

    A = mapstate.incidence(state).float()  # counts stay exact in float32
    A_kf = A.index_select(0, kf.reshape(1))[0]
    row = A @ A_kf  # [K] shared observations with kf
    in_window = ((row >= cfg.covisibility_weight_threshold) | is_kf) & state.kf_valid
    weight = torch.where(in_window, row.long() + 1, -1)
    weight = torch.where(is_kf, torch.where(state.kf_valid, _INT32_MAX, -1), weight)
    wweight, widx = packing.top_k(weight, P)  # ties to the lower slot, as lax.top_k
    wval = wweight > 0
    wfixed = (widx == 0) & wval  # KF id 0 fixed (backend.cpp:55)
    wtgt = torch.where(wval, widx, K)
    wpos = torch.full((K + 1,), -1, dtype=torch.int64, device=dev).scatter(0, wtgt, torch.arange(P, device=dev))
    win_kf = torch.zeros(K + 1, dtype=torch.bool, device=dev).scatter(0, wtgt, torch.ones_like(wval))

    # points observed by the window; over capacity, the ones the current
    # keyframe observes first, then by observation count
    pmask = ((win_kf[:K].float() @ A) > 0) & state.mp_alive
    n_obs = torch.sum(state.obs_valid, dim=1).clamp_max(M)
    score = (1 - A_kf.long()) * (M + 1) + (M - n_obs)
    pidx, pval = packing.compact_best_indices(pmask, score, MB)

    o_kf = state.obs_kf[pidx].clamp(0, K - 1).long()  # [MB, M]
    o_valid = state.obs_valid[pidx] & pval[:, None]
    o_wpos = wpos[o_kf]
    o_in_window = (o_wpos >= 0) & o_valid
    o_pose_free = o_in_window & ~wfixed[o_wpos.clamp_min(0)]
    return BAProblem(
        widx=widx, wval=wval, wfixed=wfixed, pidx=pidx, pval=pval,
        o_uv=state.obs_uv[pidx], o_depth=state.obs_depth[pidx], o_valid=o_valid,
        o_pose_free=o_pose_free, o_wpos=torch.where(o_pose_free, o_wpos, P),
        fixed_poses=state.kf_pose[o_kf],
    )


def _residuals(prob: BAProblem, poses_w, pts, camera):
    """``(measured - projected [MB, M, 2], p_cam [MB, M, 3], observer poses)``:
    free edges read the window estimates, the others the map's poses."""
    via = poses_w[prob.o_wpos.clamp_max(poses_w.shape[0] - 1)]
    e_pose = torch.where(prob.o_pose_free[..., None], via, prob.fixed_poses)
    p_c = se3.apply(e_pose, pts[:, None, :])
    return prob.o_uv - cam_mod.camera2pixel(camera, p_c), p_c, e_pose


def _chi2(prob: BAProblem, poses_w, pts, camera):
    e, _, _ = _residuals(prob, poses_w, pts, camera)
    return torch.sum(e * e, dim=-1)  # [MB, M]


def _outer_k(a, b):
    """``sum_k a[..., k, :, None] * b[..., k, None, :]`` over the 2 rows."""
    return a[..., 0, :, None] * b[..., 0, None, :] + a[..., 1, :, None] * b[..., 1, None, :]


def _pose_sum(values, o_wpos, P):
    """``[P, ...]`` float32 sums of ``values [MB, M, ...]`` by window position
    (position ``P``, the fixed and invalid edges, is dropped)."""
    flat = values.reshape((-1,) + tuple(values.shape[2:])).float()
    out = torch.zeros((P + 1,) + tuple(flat.shape[1:]), dtype=flat.dtype, device=flat.device)
    return out.index_add(0, o_wpos.reshape(-1), flat)[:P]


def _lm_phase(cfg, camera, prob: BAProblem, poses0, pts0, obs_mask, iterations: int, huber_delta):
    """One LM round (``optimizer.optimize(10)``) with adaptive damping;
    returns ``(poses, points)``."""
    P = poses0.shape[0]
    MB, M = obs_mask.shape
    dev = poses0.device
    f32 = torch.float32
    maskf = obs_mask.to(f32)

    if cfg.ba_use_depth_prior:
        # information weight of the Kinect axial-noise model sigma = k z^2,
        # with the 0.25 m depth clamp and a sigma floor
        z = torch.clamp_min(prob.o_depth, 0.25)
        sigma = torch.clamp_min(cfg.ba_depth_sigma_scale * z * z, cfg.ba_depth_sigma_floor)
        w_depth_info = (prob.o_depth > 0).to(f32) * cfg.ba_depth_weight / (sigma * sigma)
    else:
        w_depth_info = torch.zeros_like(prob.o_depth)
    depth_delta = cfg.huber_delta  # the depth term is always Huber-robustified

    def total_cost(poses, pts):
        e, p_c, _ = _residuals(prob, poses, pts, camera)
        rd = prob.o_depth - p_c[..., 2]
        return torch.sum(maskf * (
            lm_ops._robust_cost(torch.sum(e * e, dim=-1), huber_delta)
            + lm_ops._robust_cost(w_depth_info * rd * rd, depth_delta)
        ))

    free_pose = ~prob.wfixed & prob.wval
    fm = free_pose.to(f32)
    diag = torch.eye(P, dtype=torch.bool, device=dev)[:, None, :, None]

    def block_diag(blocks):
        """``[P, 6, 6]`` blocks -> ``[P, 6, P, 6]`` with them on the diagonal
        and zeros elsewhere (a select, not a product: no 0 * inf)."""
        return torch.where(diag, blocks[:, :, None, :], 0.0)
    eye3 = torch.eye(3, dtype=f32, device=dev)
    eye6 = torch.eye(6, dtype=f32, device=dev)
    pose_free_f = prob.o_pose_free.to(f32)
    ct = torch.bfloat16 if cfg.ba_bf16 else f32
    rtol = 1e-6

    poses, pts = poses0, pts0
    lam = torch.tensor(1e-3, dtype=f32, device=dev)
    cost = total_cost(poses0, pts0)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    for _ in range(iterations):
        e, p_c, e_pose = _residuals(prob, poses, pts, camera)
        Jp = lm_ops.pose_jacobian(p_c, camera)  # [MB, M, 2, 6]
        R = se3.quat_to_matrix(se3.quat(e_pose))  # [MB, M, 3, 3]
        Jl = torch.sum(Jp[..., :3, None] * R[..., None, :, :], dim=-2)  # [MB, M, 2, 3]
        w = maskf * lm_ops._huber_weights(torch.sum(e * e, dim=-1), huber_delta)
        wp = w * pose_free_f

        # depth prior: r_d = d_meas - z_cam, dz/ddelta = [0,0,1, y,-x,0],
        # dz/dp_w = R.row(2)
        X, Y = p_c[..., 0], p_c[..., 1]
        zeros = torch.zeros_like(X)
        ones = torch.ones_like(X)
        Jd_pose = -torch.stack([zeros, zeros, ones, Y, -X, zeros], dim=-1)
        Jd_pt = -R[..., 2, :]
        r_d = prob.o_depth - p_c[..., 2]
        wd = maskf * w_depth_info * lm_ops._huber_weights(w_depth_info * r_d * r_d, depth_delta)
        wdp = wd * pose_free_f

        # per-edge blocks in the working type, summed in float32
        Jp_c, Jl_c, Jdpo_c, Jdpt_c = Jp.to(ct), Jl.to(ct), Jd_pose.to(ct), Jd_pt.to(ct)
        w_c, wd_c, wp_c, wdp_c = w.to(ct), wd.to(ct), wp.to(ct), wdp.to(ct)
        V = torch.sum(
            w_c[..., None, None] * _outer_k(Jl_c, Jl_c)
            + wd_c[..., None, None] * (Jdpt_c[..., :, None] * Jdpt_c[..., None, :]),
            dim=1, dtype=f32,
        )  # [MB, 3, 3]
        gl = torch.sum(
            w[..., None] * torch.sum(Jl * e[..., None], dim=-2) + wd[..., None] * Jd_pt * r_d[..., None],
            dim=1,
        )  # [MB, 3]
        UJp = wp_c[..., None, None] * _outer_k(Jp_c, Jp_c) + wdp_c[..., None, None] * (
            Jdpo_c[..., :, None] * Jdpo_c[..., None, :]
        )
        U = _pose_sum(UJp, prob.o_wpos, P)  # [P, 6, 6]
        gpe = wp[..., None] * torch.sum(Jp * e[..., None], dim=-2) + wdp[..., None] * Jd_pose * r_d[..., None]
        gp = _pose_sum(gpe, prob.o_wpos, P)  # [P, 6]
        WJ = wp_c[..., None, None] * _outer_k(Jp_c, Jl_c) + wdp_c[..., None, None] * (
            Jdpo_c[..., :, None] * Jdpt_c[..., None, :]
        )  # [MB, M, 6, 3]
        Wt = torch.zeros((MB, P + 1, 18), dtype=f32, device=dev)
        Wt = Wt.scatter_add(1, prob.o_wpos[..., None].expand(-1, -1, 18), WJ.reshape(MB, M, 18).float())
        Wt = Wt[:, :P].reshape(MB, P, 6, 3)

        Vinv = inv3x3(V + lam * eye3)
        Y_ = torch.einsum("pial,plk->piak", Wt, Vinv)  # [MB, P, 6, 3]
        S = -torch.einsum("piak,pjbk->iajb", Y_, Wt)  # [P, 6, P, 6]
        S = S + block_diag(U + lam * eye6)
        rhs = -(gp - torch.einsum("piak,pk->ia", Y_, gl))  # [P, 6]

        # freeze fixed and invalid poses: identity rows, zero rhs
        S = S * fm[:, None, None, None] * fm[None, None, :, None]
        S = S + block_diag(eye6 * (1.0 - fm)[:, None, None])
        rhs = rhs * fm[:, None]

        Sm = S.reshape(P * 6, P * 6)
        L, info = torch.linalg.cholesky_ex((Sm + Sm.mT) / 2)  # jnp.linalg.cholesky symmetrizes
        y = torch.linalg.solve_triangular(L, rhs.reshape(P * 6, 1), upper=False)
        dp = torch.linalg.solve_triangular(L.mT, y, upper=True).reshape(P, 6)
        dl = torch.einsum("pij,pj->pi", Vinv, -gl - torch.einsum("piak,ia->pk", Wt, dp))

        cand_poses = se3.normalize(se3.compose(se3.exp(dp), poses))
        cand_poses = torch.where(free_pose[:, None], cand_poses, poses)
        cand_pts = torch.where(prob.pval[:, None], pts + dl, pts)
        new_cost = total_cost(cand_poses, cand_pts)
        accept = (new_cost < cost) & (info == 0)
        converged = accept & (cost - new_cost <= rtol * (cost + 1e-20))
        take = accept & ~done
        poses = torch.where(take, cand_poses, poses)
        pts = torch.where(take, cand_pts, pts)
        cost = torch.where(take, new_cost, cost)
        lam_next = torch.where(accept, lam * 0.33, lam * 5.0)
        done_next = done | converged | (lam > 1e8)
        lam = torch.where(done, lam, lam_next)
        done = done_next
    return poses, pts


class BAOutput(NamedTuple):
    num_pruned: torch.Tensor  # outlier observations removed (both rounds)
    num_points: torch.Tensor
    num_poses: torch.Tensor


def ba_step(cfg, camera, state: VOState, kf):
    """Two-round local BA on keyframe ``kf`` (an int or a 0-d integer
    tensor); returns ``(state, BAOutput)``.  A masked no-op when the window
    or the point set is empty."""
    K = state.kf_pose.shape[0]
    C = state.obs_kf.shape[0]
    prob = build_problem(cfg, state, kf)
    poses0 = state.kf_pose[prob.widx]
    pts0 = state.mp_pos[prob.pidx]

    # round 1: robust kernel on all edges (backend.cpp:122-141)
    poses1, pts1 = _lm_phase(cfg, camera, prob, poses0, pts0, prob.o_valid, cfg.ba_iterations, cfg.huber_delta)
    prune1 = prob.o_valid & (_chi2(prob, poses1, pts1, camera) > cfg.chi2_th)
    # round 2: no robust kernel, pruned edges out (backend.cpp:143-159)
    mask2 = prob.o_valid & ~prune1
    poses2, pts2 = _lm_phase(cfg, camera, prob, poses1, pts1, mask2, cfg.ba_iterations, None)
    prune2 = mask2 & (_chi2(prob, poses2, pts2, camera) > cfg.chi2_th)
    pruned = prune1 | prune2

    # write back: non-fixed window poses; selected non-outlier points and
    # their optimized_ flag (backend.cpp:182-194)
    kf_pose = mapstate.with_spare(state.kf_pose)
    kf_pose[torch.where(prob.wval & ~prob.wfixed, prob.widx, K)] = poses2
    ptgt = torch.where(prob.pval & ~state.mp_outlier[prob.pidx], prob.pidx, C)
    mp_pos = mapstate.with_spare(state.mp_pos)
    mp_pos[ptgt] = pts2
    mp_opt = mapstate.with_spare(state.mp_optimized)
    mp_opt[ptgt] = True
    state = state.replace(kf_pose=kf_pose[:K], mp_pos=mp_pos[:C], mp_optimized=mp_opt[:C])
    # pruned observations leave the map (backend.cpp:148-153, 164-168)
    state = mapstate.remove_observations_rows(state, prob.pidx, prob.pval, pruned)
    out = BAOutput(num_pruned=torch.sum(pruned), num_points=torch.sum(prob.pval), num_poses=torch.sum(prob.wval))
    return state, out
