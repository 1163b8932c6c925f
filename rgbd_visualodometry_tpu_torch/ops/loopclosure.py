"""Loop-closure pose-graph construction from the map's observation table.

Counterpart of ``rgbd_visualodometry_tpu/ops/loopclosure.py``.  Two
detectors:

1. **Co-observation** (:func:`build_coobservation_graph`): tracking matches
   every frame against the persistent map, so a camera revisiting a mapped
   area re-associates the old mappoints and the observation table already
   links it to temporally distant keyframes.  Every keyframe pair sharing
   depth-valid observations yields weighted Kabsch moments of independent
   3D-3D correspondences (each keyframe's back-projected measurement) and a
   relative-pose edge ``T_i^{-1} T_j`` from Horn's closed form.
2. **Appearance** (:func:`build_appearance_graph`): when tracking duplicated
   the old landmarks instead, a bag-of-bits screen, exact mutual-NN Hamming
   matching and trimmed Horn registration recover the edge from the
   descriptors alone.

The moments and the pair registration run on the state's device; the pair
ranking, the bit histogram, the feature table and the edge compaction are
host numpy, copied from the reference.  Where the reference pads or chunks
for XLA (the C-minor transposes and ``lax.scan`` chunks of the moments, the
bucketed Kabsch batch, the padded pair chunks) the port pads only what a
captured CUDA graph needs: the moments are one accumulation over the
``[C, M, M]`` pair items that hold a correspondence (in item order, so a
snapshot relaxes to the same bits every time; the counts are integers
below 2**24 and exact), the Kabsch solve one batch over the compacted
edges, and the pairs register in chunks that bound their ``[P, F, F]``
distance transient; on CUDA every chunk is filled to ``chunk_pairs`` and
replayed from one captured graph (``ops.replay``).

Edge weights are the clamped co-observation counts: the pose-graph solver
needs weights bounded relative to the odometry chain
(``ops/posegraph.py``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from rgbd_visualodometry_tpu_torch import camera as camera_mod
from rgbd_visualodometry_tpu_torch.ops import replay, se3
from rgbd_visualodometry_tpu_torch.ops.posegraph import PoseGraph
from rgbd_visualodometry_tpu_torch.ops.smalleig import horn_quat_from_crosscov


def coobservation_moments(state, cam):
    """Weighted Kabsch moments for every ordered keyframe pair (i < j).

    For each mappoint row, every pair of depth-valid observations
    ``(m1, m2)`` with ``obs_kf[m1] < obs_kf[m2]`` contributes one 3D-3D
    correspondence ``a = backproject(obs m1)`` in keyframe i's camera
    frame, ``b = backproject(obs m2)`` in keyframe j's.

    Returns float32 ``(cnt[K, K], sa[K, K, 3], sb[K, K, 3], mba[K, K, 3, 3])``::

        cnt[i, j] = sum w        sa[i, j] = sum w * a
        sb[i, j]  = sum w * b    mba[i, j, α, β] = sum w * b_α * a_β

    with w = 1 per correspondence.
    """
    K = state.kf_pose.shape[0]
    kf = state.obs_kf.long()  # [C, M]
    ok = state.obs_valid & (state.obs_depth > 0.0) & (kf >= 0)
    p = camera_mod.pixel2camera(cam, state.obs_uv, state.obs_depth)  # [C, M, 3]
    # i < j canonicalizes each unordered pair once (one observation per
    # keyframe in a row)
    w = ok[:, :, None] & ok[:, None, :] & (kf[:, :, None] < kf[:, None, :])
    c, m1, m2 = w.nonzero(as_tuple=True)
    a, b = p[c, m1], p[c, m2]
    items = torch.cat(
        [torch.ones_like(a[:, :1]), a, b, (b[:, :, None] * a[:, None, :]).reshape(-1, 9)], dim=1
    )
    acc = torch.zeros((K * K, 16), dtype=torch.float32, device=p.device)
    pair = kf[c, m1] * K + kf[c, m2]
    if acc.is_cuda:
        # index_add_ adds atomically there, in a different order every run;
        # index_put_ sorts the items by pair (stably) and sums each run
        acc.index_put_((pair,), items, accumulate=True)
    else:
        acc.index_add_(0, pair, items)  # in item order; index_put_ splits over threads here
    acc = acc.reshape(K, K, 16)
    return acc[..., 0], acc[..., 1:4], acc[..., 4:7], acc[..., 7:].reshape(K, K, 3, 3)


def kabsch_from_moments(cnt, sa, sb, mba) -> torch.Tensor:
    """Weighted Horn alignment ``a ~= R b + t`` from accumulated moments
    (batched): keyframe-j camera coordinates into keyframe i's, which is
    the edge measurement ``T_i^{-1} T_j``."""
    w = torch.clamp_min(cnt, 1e-9)[..., None]
    abar = sa / w
    bbar = sb / w
    # centered cross-covariance with world = b, cam = a
    S = mba - cnt[..., None, None] * bbar[..., :, None] * abar[..., None, :]
    q = horn_quat_from_crosscov(S)
    t = abar - se3.quat_rotate(q, bbar)
    return se3.make(q, t)


def keyframe_feature_table(state, cam, max_features: int = 512):
    """Per-keyframe local feature sets from the observation table (host
    numpy).

    Returns ``(desc [K, F, 8] u32, pts [K, F, 3] f32, valid [K, F])``: each
    keyframe's depth-valid observations of alive mappoints, in row order,
    carrying the landmark's packed descriptor and the back-projected
    measured pixel and depth in that keyframe's camera frame.
    """
    obs_kf = state.obs_kf.cpu().numpy()  # [C, M]
    obs_valid = state.obs_valid.cpu().numpy()
    obs_depth = state.obs_depth.cpu().numpy()
    obs_uv = state.obs_uv.cpu().numpy()  # [C, M, 2]
    mp_desc = state.mp_desc.cpu().numpy().view(np.uint32)  # [C, 8]
    alive = (state.mp_valid & ~state.mp_outlier).cpu().numpy()
    K = state.kf_pose.shape[0]

    ok = obs_valid & (obs_depth > 0.0) & (obs_kf >= 0) & alive[:, None]
    c_idx, m_idx = np.nonzero(ok)
    k_idx = obs_kf[c_idx, m_idx]
    order = np.argsort(k_idx, kind="stable")
    c_idx, m_idx, k_idx = c_idx[order], m_idx[order], k_idx[order]
    starts = np.searchsorted(k_idx, np.arange(K + 1))

    F = int(max_features)
    desc = np.zeros((K, F, 8), np.uint32)
    pts = np.zeros((K, F, 3), np.float32)
    val = np.zeros((K, F), bool)
    if c_idx.size:
        p_cam = camera_mod.pixel2camera(
            cam, torch.from_numpy(obs_uv[c_idx, m_idx]), torch.from_numpy(obs_depth[c_idx, m_idx])
        ).numpy()
        for k in range(K):
            s, e = int(starts[k]), int(starts[k + 1])
            n = min(e - s, F)
            if n == 0:
                continue
            desc[k, :n] = mp_desc[c_idx[s : s + n]]
            pts[k, :n] = p_cam[s : s + n]
            val[k, :n] = True
    return desc, pts, val


def _bit_histogram(desc: np.ndarray, val: np.ndarray) -> np.ndarray:
    """[K, 256] mean-bit signature per keyframe (a tiny bag-of-bits global
    descriptor; enough to rank candidate pairs before exact matching).
    Word-at-a-time so the transient stays [K, F, 32], not [K, F, 256]
    float32 (~268 MB at K=F=512)."""
    K, F, W = desc.shape
    out = np.zeros((K, W * 32), np.float32)
    shifts = np.arange(32, dtype=np.uint32)
    vf = val.astype(np.float32)
    for w in range(W):
        bits = ((desc[:, :, w, None] >> shifts) & np.uint32(1)).astype(np.float32)
        out[:, w * 32 : (w + 1) * 32] = np.einsum("kf,kfb->kb", vf, bits)
    cnt = np.maximum(val.sum(axis=1, keepdims=True), 1).astype(np.float32)
    return out / cnt


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word of an int32 tensor (uint32 bit
    patterns, top bit included), as int64: a SWAR count on the word
    widened to int64, where no shift drags a sign bit in."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def _register_pairs(di, pi, vi, dj, pj, vj, match_ratio, min_match_distance, inlier_radius):
    """Mutual-NN Hamming matching + trimmed Horn registration of a batch of
    keyframe pairs' local features (``desc [P, F, 8]`` int32 bit patterns,
    ``pts [P, F, 3]``, ``valid [P, F]``).  Returns ``(T_i^-1 T_j [P, 7],
    inliers [P] int32, rms [P])``.

    Matching keeps the reference's adaptive gate ``max(min_dis * ratio,
    30)`` (``src/frontend.cpp:190-211``) plus a mutual-NN requirement.
    Ties take the first index, as ``jnp.argmin`` does.
    """
    F = di.shape[1]
    BIG = 1 << 14
    d = torch.zeros((di.shape[0], F, F), dtype=torch.int64, device=di.device)
    for w in range(8):  # word-at-a-time keeps the transient at [P, F, F]
        d += popcount32(di[:, :, None, w] ^ dj[:, None, :, w])
    d = torch.where(vi[:, :, None] & vj[:, None, :], d, BIG)
    dmin, nn_j = torch.min(d, dim=2)
    nn_i = torch.argmin(d, dim=1)
    mutual = torch.gather(nn_i, 1, nn_j) == torch.arange(F, device=d.device)
    row_ok = vi & (dmin < BIG)
    min_dis = torch.amin(torch.where(row_ok, dmin, BIG), dim=1).float()
    gate = dmin.float() <= torch.clamp_min(min_dis * match_ratio, min_match_distance)[:, None]
    m0 = (row_ok & mutual & gate).float()
    a = pi  # [P, F, 3] in keyframe i's camera frame
    b = torch.gather(pj, 1, nn_j[..., None].expand(-1, -1, 3))  # matched partner in keyframe j's frame

    def fit(w):
        cw = torch.clamp_min(torch.sum(w, dim=1), 1e-9)[:, None]
        abar = torch.sum(a * w[..., None], dim=1) / cw
        bbar = torch.sum(b * w[..., None], dim=1) / cw
        S = torch.einsum("pn,pna,pnb->pab", w, b - bbar[:, None], a - abar[:, None])
        q = horn_quat_from_crosscov(S)
        t = abar - se3.quat_rotate(q, bbar)
        return se3.make(q, t)

    # trimmed IRLS: refit on the survivors of a fixed inlier radius - the
    # descriptor-NN match set always carries aliased outliers
    w = m0
    pose = fit(w)
    for _ in range(4):
        r = torch.linalg.vector_norm(a - se3.apply(pose[:, None], b), dim=-1)
        w = m0 * (r < inlier_radius)
        pose = fit(w)
    r = torch.linalg.vector_norm(a - se3.apply(pose[:, None], b), dim=-1)
    w = m0 * (r < inlier_radius)
    inl = torch.sum(w, dim=1)
    rms = torch.sqrt(torch.sum(w * r * r, dim=1) / torch.clamp_min(inl, 1.0))
    return pose, inl.to(torch.int32), rms


def build_appearance_graph(
    state,
    cam,
    *,
    max_features: int = 512,
    top_per_kf: int = 3,
    loop_gap_s: float = 5.0,
    min_features: int = 30,
    min_inliers: int = 12,
    inlier_radius: float = 0.10,
    match_ratio: float = 2.0,
    min_match_distance: float = 30.0,
    max_pair_weight: float = 30.0,
    exclude=(),
    chunk_pairs: int = 16,
) -> PoseGraph:
    """Appearance-based loop-closure edges: descriptor place recognition
    with no reliance on shared mappoint rows.

    Keyframes are ranked by a bag-of-bits global descriptor, each usable
    keyframe's ``top_per_kf`` best candidates more than ``loop_gap_s``
    apart are matched exactly and registered by trimmed Horn, and pairs
    with at least ``min_inliers`` inliers become edges.  ``exclude`` takes
    ``(i, j)`` keyframe-slot pairs (i < j) that already have co-observation
    edges.  Pairs register ``chunk_pairs`` at a time, which bounds the
    ``[P, F, F]`` distance transient.
    """
    dev = state.kf_pose.device
    kf_valid = state.kf_valid.cpu().numpy()
    ts = state.kf_timestamp.cpu().numpy().astype(np.float64)
    desc, pts, val = keyframe_feature_table(state, cam, max_features)
    counts = val.sum(axis=1)
    usable = kf_valid & (counts >= int(min_features))
    if usable.sum() < 2:
        return empty_graph(dev)

    hist = _bit_histogram(desc, val)
    hn = hist / np.maximum(np.linalg.norm(hist, axis=1, keepdims=True), 1e-9)
    sim = hn @ hn.T
    eligible = (
        usable[:, None]
        & usable[None, :]
        & (np.abs(ts[:, None] - ts[None, :]) > float(loop_gap_s))
    )
    sim = np.where(eligible, sim, -np.inf)
    excl = set(exclude)
    pairs = set()
    for k in np.nonzero(usable)[0]:
        for j in np.argsort(-sim[k])[: int(top_per_kf)]:
            if not np.isfinite(sim[k, j]):
                break
            p = (int(min(k, j)), int(max(k, j)))
            if p not in excl:
                pairs.add(p)
    if not pairs:
        return empty_graph(dev)
    pairs = sorted(pairs)

    ii = np.asarray([p[0] for p in pairs])
    jj = np.asarray([p[1] for p in pairs])
    desc_d = torch.from_numpy(desc.view(np.int32)).to(dev)
    pts_d = torch.from_numpy(pts).to(dev)
    val_d = torch.from_numpy(val).to(dev)
    poses, inls = [], []
    for s in range(0, len(pairs), int(chunk_pairs)):
        ci, cj = ii[s : s + int(chunk_pairs)], jj[s : s + int(chunk_pairs)]
        n = ci.size
        register = _register_pairs
        if dev.type == "cuda":
            # every chunk at full size (the last one's pairs repeated), so
            # that one captured graph replays it (ops.replay)
            ci, cj = np.resize(ci, int(chunk_pairs)), np.resize(cj, int(chunk_pairs))
            register = functools.partial(replay.replayed, _register_pairs)
        ci, cj = torch.from_numpy(ci).to(dev), torch.from_numpy(cj).to(dev)
        pose, inl, _ = register(
            desc_d[ci], pts_d[ci], val_d[ci], desc_d[cj], pts_d[cj], val_d[cj],
            match_ratio=float(match_ratio), min_match_distance=float(min_match_distance),
            inlier_radius=float(inlier_radius),
        )
        poses.append(pose[:n])
        inls.append(inl[:n])
    poses = torch.cat(poses)
    inls = torch.cat(inls).cpu().numpy()
    keep = inls >= int(min_inliers)
    if not keep.any():
        return empty_graph(dev)
    return PoseGraph(
        edge_i=torch.from_numpy(ii[keep]).to(device=dev, dtype=torch.int32),
        edge_j=torch.from_numpy(jj[keep]).to(device=dev, dtype=torch.int32),
        edge_meas=poses[torch.from_numpy(keep).to(dev)],
        edge_weight=torch.from_numpy(np.minimum(inls[keep], float(max_pair_weight))).to(device=dev, dtype=torch.float32),
        edge_valid=torch.ones((int(keep.sum()),), dtype=torch.bool, device=dev),
    )


def empty_graph(device=None) -> PoseGraph:
    return PoseGraph(
        edge_i=torch.zeros((0,), dtype=torch.int32, device=device),
        edge_j=torch.zeros((0,), dtype=torch.int32, device=device),
        edge_meas=torch.zeros((0, 7), dtype=torch.float32, device=device),
        edge_weight=torch.zeros((0,), dtype=torch.float32, device=device),
        edge_valid=torch.zeros((0,), dtype=torch.bool, device=device),
    )


def build_coobservation_graph(state, cam, *, min_shared: int = 8, max_pair_weight: float = 30.0) -> PoseGraph:
    """Compact edge list over all keyframe pairs sharing >= ``min_shared``
    depth-valid observations, compacted on the host, so only surviving
    pairs pay the Kabsch solve and the downstream Jacobians.
    ``min_shared`` doubles as the geometric-degeneracy guard."""
    dev = state.kf_pose.device
    cnt, sa, sb, mba = coobservation_moments(state, cam)
    cnt_h = cnt.cpu().numpy()
    ii, jj = np.nonzero(cnt_h >= float(min_shared))
    if ii.size == 0:
        return empty_graph(dev)
    pi, pj = torch.from_numpy(ii).to(dev), torch.from_numpy(jj).to(dev)
    meas = kabsch_from_moments(cnt[pi, pj], sa[pi, pj], sb[pi, pj], mba[pi, pj])
    weight = np.minimum(cnt_h[ii, jj], float(max_pair_weight))
    return PoseGraph(
        edge_i=pi.to(torch.int32),
        edge_j=pj.to(torch.int32),
        edge_meas=meas,
        edge_weight=torch.from_numpy(weight).to(device=dev, dtype=torch.float32),
        edge_valid=torch.ones((ii.size,), dtype=torch.bool, device=dev),
    )
