"""The world state: keyframes, mappoints, observations, incidence.

Counterpart of ``rgbd_visualodometry_tpu/mapstate.py``: one fixed-capacity
set of tensors replaces the reference C++ object graph (``MapManager``,
``Frame``/``Mappoint`` bookkeeping).  The port keeps every leaf in the
natural row-major layout - capacity first, ``mp_pos [C, 3]``,
``obs_uv [C, M, 2]`` - where the JAX package stores its pools C-minor for
TPU tiling (``mapstate.py:29-50``), and it drops the ``[C, 256]`` bipolar
descriptor pool, since matching reads the packed ``mp_desc``.

:func:`state_from_numpy` and :func:`state_to_numpy` carry a JAX ``VOState``
(its leaves as numpy arrays, ``jax.device_get(state)._asdict()``) into this
layout and back, the threefry key words included.

Updates keep the reference's semantics: predicate-masked, so a step never
branches on device values on the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.utils import _pytree as pytree

from vobench.reference import random as vo_random
from vobench.reference.ops import packing, se3

# FSM codes (frontend.h:26-30)
INITIALIZING = 0
TRACKING = 1
LOST = 2


@dataclasses.dataclass
class VOState:
    # keyframes
    kf_pose: torch.Tensor  # [K, 7] T_c_w
    kf_valid: torch.Tensor  # [K] bool
    kf_timestamp: torch.Tensor  # [K] f32, seconds since the first staged frame
    num_kf: torch.Tensor  # int32 scalar: next keyframe slot (monotonic)
    # mappoints
    mp_pos: torch.Tensor  # [C, 3]
    mp_desc: torch.Tensor  # [C, 8] int32 (uint32 bit patterns)
    mp_norm: torch.Tensor  # [C, 3] mean viewing direction
    mp_valid: torch.Tensor  # [C] bool
    mp_outlier: torch.Tensor  # [C] bool
    mp_triangulated: torch.Tensor  # [C] bool
    mp_optimized: torch.Tensor  # [C] bool
    # observations, per mappoint slot
    obs_kf: torch.Tensor  # [C, M] int32 keyframe slot, -1 = empty
    obs_uv: torch.Tensor  # [C, M, 2] pixel
    obs_depth: torch.Tensor  # [C, M] measured depth (m), 0 = none
    obs_valid: torch.Tensor  # [C, M] bool
    # incidence A[K, C] int8: keyframe k observes mappoint c (kept in step)
    A_inc: torch.Tensor
    # tracking bookkeeping
    ref_kf: torch.Tensor  # int32 scalar
    prev_pose: torch.Tensor  # [7]
    fsm: torch.Tensor  # int32 scalar
    lost_count: torch.Tensor  # int32 scalar
    frame_index: torch.Tensor  # int32 scalar
    rng: torch.Tensor  # int64 [2]: threefry key words

    @property
    def mp_alive(self) -> torch.Tensor:
        return self.mp_valid & ~self.mp_outlier

    @property
    def mp_obs_count(self) -> torch.Tensor:
        """``[C]`` int32: valid observations of each map point."""
        return torch.sum(self.obs_valid, dim=-1, dtype=torch.int32)

    @property
    def obs_capacity(self) -> tuple[int, int]:
        """``(C, M)`` pool capacities (observation planes are ``[C, M]``)."""
        C, M = self.obs_kf.shape[-2:]
        return C, M

    def replace(self, **kw) -> "VOState":
        return dataclasses.replace(self, **kw)


_LEAVES = tuple(f.name for f in dataclasses.fields(VOState))

# a pytree, so torch.func.vmap maps over a stack of states (parallel/mesh.py)
pytree.register_pytree_node(
    VOState,
    lambda s: ([getattr(s, n) for n in _LEAVES], None),
    lambda leaves, _: VOState(*leaves),
    serialized_type_name=f"{__name__}.VOState",
)


def stack_states(states) -> VOState:
    """Per-stream states -> one state whose leaves have a leading stream axis."""
    return VOState(*(torch.stack([getattr(s, n) for s in states]) for n in _LEAVES))


def unstack_state(state: VOState, s: int) -> VOState:
    """Stream ``s`` of a stacked state."""
    return VOState(*(getattr(state, n)[s] for n in _LEAVES))


def _i32(v, device):
    return torch.tensor(v, dtype=torch.int32, device=device)


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``.  A CUDA device must exist: the port
    runs on the CPU only where the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device for {dev}; pass device='cpu' to run on the CPU")
    return dev


def init_state(cfg, seed: int = 0, device="cuda") -> VOState:
    device = resolve_device(device)
    K, C, M = cfg.max_keyframes, cfg.max_mappoints, cfg.max_obs_per_mappoint
    f32 = torch.float32
    z = lambda *s, dt=f32: torch.zeros(s, dtype=dt, device=device)  # noqa: E731
    return VOState(
        kf_pose=se3.identity(f32, device).repeat(K, 1),
        kf_valid=z(K, dt=torch.bool),
        kf_timestamp=z(K),
        num_kf=_i32(0, device),
        mp_pos=z(C, 3),
        mp_desc=z(C, 8, dt=torch.int32),
        mp_norm=z(C, 3),
        mp_valid=z(C, dt=torch.bool),
        mp_outlier=z(C, dt=torch.bool),
        mp_triangulated=z(C, dt=torch.bool),
        mp_optimized=z(C, dt=torch.bool),
        obs_kf=torch.full((C, M), -1, dtype=torch.int32, device=device),
        obs_uv=z(C, M, 2),
        obs_depth=z(C, M),
        obs_valid=z(C, M, dt=torch.bool),
        A_inc=z(K, C, dt=torch.int8),
        ref_kf=_i32(0, device),
        prev_pose=se3.identity(f32, device),
        fsm=_i32(INITIALIZING, device),
        lost_count=_i32(0, device),
        frame_index=_i32(0, device),
        rng=vo_random.PRNGKey(seed, device),
    )


# leaves stored C-minor by the JAX package: name -> permutation to row-major
_CMINOR = {
    "mp_pos": (1, 0), "mp_desc": (1, 0), "mp_norm": (1, 0),
    "obs_kf": (1, 0), "obs_depth": (1, 0), "obs_valid": (1, 0),
    "obs_uv": (2, 1, 0),
}


def _perm(name: str, lead: int):
    """The row-major permutation of a C-minor leaf behind ``lead`` stream axes."""
    return tuple(range(lead)) + tuple(p + lead for p in _CMINOR[name])


def state_from_numpy(leaves: dict, device="cuda") -> VOState:
    """A JAX ``VOState`` as numpy leaves (``jax.device_get(s)._asdict()``)
    -> the port's state: C-minor leaves transposed, ``mp_bip`` dropped,
    uint32 words reinterpreted as int32 bit patterns, the key kept.  A
    batched state (``MultiStreamVO.states``: every leaf with a leading
    stream axis) stays batched."""
    device = resolve_device(device)
    lead = np.ndim(leaves["num_kf"])  # a scalar per stream
    out = {}
    for f in dataclasses.fields(VOState):
        a = np.asarray(leaves[f.name])
        if f.name in _CMINOR:
            a = np.transpose(a, _perm(f.name, lead))
        if f.name == "rng":
            a = a.astype(np.uint32).astype(np.int64)
        elif a.dtype == np.uint32:
            a = a.view(np.int32)
        out[f.name] = torch.from_numpy(np.array(a, order="C")).to(device)
    return VOState(**out)


def state_to_numpy(state: VOState) -> dict:
    """The port's state, batched or not -> numpy leaves in the JAX
    package's layout and dtypes (``mp_bip`` comes back empty, ``[C, 0]``,
    as under ``packed_matching``)."""
    lead = state.num_kf.dim()
    out = {}
    for f in dataclasses.fields(VOState):
        a = getattr(state, f.name).detach().cpu().numpy()
        if f.name in _CMINOR:
            inv = np.argsort(_perm(f.name, lead))
            a = np.array(np.transpose(a, inv), order="C")
        if f.name in ("mp_desc",):
            a = a.view(np.uint32)
        elif f.name == "rng":
            a = a.astype(np.uint32)
        out[f.name] = a
    out["mp_bip"] = np.zeros(tuple(state.mp_valid.shape) + (0,), np.int8)
    return out


# ---------------------------------------------------------------------------
# incidence and tracking map
# ---------------------------------------------------------------------------


def incidence(state: VOState) -> torch.Tensor:
    """``A [K, C]`` int8: keyframe k observes mappoint c (the cached
    ``A_inc``)."""
    return state.A_inc


def with_spare(x: torch.Tensor) -> torch.Tensor:
    """``x`` with one zero row appended: masked index writes aim their
    dropped lanes at it (the JAX package's ``mode="drop"``)."""
    return torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])


def incidence_from_obs(state: VOState) -> torch.Tensor:
    """The incidence matrix rebuilt from the observation table: the ground
    truth that the incremental ``A_inc`` is tested against."""
    K = state.kf_pose.shape[0]
    C = state.obs_kf.shape[0]
    cols = torch.arange(C, device=state.obs_kf.device)[:, None]
    flat = state.obs_kf.clamp(0, K - 1).long() * C + cols
    flat = torch.where(state.obs_valid, flat, torch.full_like(flat, K * C)).reshape(-1)
    A = torch.zeros(K * C + 1, dtype=torch.int8, device=flat.device)
    A = A.scatter(0, flat, torch.ones_like(flat, dtype=torch.int8))  # out of place: vmaps
    return A[: K * C].reshape(K, C)


def covisibility_weights(A: torch.Tensor) -> torch.Tensor:
    """``W [K, K]`` int32 = ``A @ A^T``: shared-observation counts, the
    weight map of ``Frame::allCovisibleKeyframeIdToWeight_``
    (``src/frame.cpp:110-117``).  Exact in float32: counts stay below 2^24."""
    Af = A.float()
    return (Af @ Af.T).to(torch.int32)


def active_covisible(state: VOState, A: torch.Tensor, kf, threshold: int) -> torch.Tensor:
    """``[K]`` bool: valid keyframes sharing at least ``threshold``
    observations with ``kf``, and ``kf`` itself (``mapmanager.cpp:17-19``):
    one row of ``A @ A^T``."""
    Af = A.float()
    K = A.shape[0]
    kf = torch.as_tensor(kf, device=A.device).long()
    row = Af @ Af[kf]
    return ((row >= threshold) | (torch.arange(K, device=A.device) == kf)) & state.kf_valid


def tracking_map_mask(state: VOState, cfg) -> torch.Tensor:
    """``[C]`` bool: non-outlier mappoints observed by the reference keyframe
    or its active covisible keyframes (``src/frontend.cpp:156-166``,
    ``src/mapmanager.cpp:14-38``); the whole alive map below
    ``tracking_map_min_points``.  Counts are exact in float32."""
    A = state.A_inc.float()
    K = A.shape[0]
    ref = state.ref_kf.long()
    weights = A @ A[ref]  # [K] shared observations with ref_kf
    kfs = ((weights >= cfg.covisibility_weight_threshold) | (torch.arange(K, device=A.device) == ref))
    kfs = kfs & state.kf_valid
    observed = (kfs.float() @ A) > 0
    local = observed & state.mp_alive
    enough = torch.sum(local) >= cfg.tracking_map_min_points
    return torch.where(enough, local, state.mp_alive)


# ---------------------------------------------------------------------------
# state updates (predicate-masked)
# ---------------------------------------------------------------------------


def insert_keyframe(state: VOState, pose, timestamp, pred, eviction: str = "ring"):
    """``MapManager::InsertKeyframe`` with a fixed pool: ``"ring"`` recycles
    slots 1..K-1 (clearing the evicted keyframe's observations), ``"refuse"``
    drops the insert.  Returns ``(state, slot int32, inserted bool)``."""
    K = state.kf_pose.shape[0]
    full = state.num_kf >= K
    if eviction == "refuse":
        inserted = pred & ~full
        slot = state.num_kf.clamp(0, K - 1)
    elif eviction == "ring":
        inserted = pred
        ring = (state.num_kf - K) % (K - 1) + 1 if K > 1 else torch.zeros_like(state.num_kf)
        slot = torch.where(full, ring, state.num_kf).to(torch.int32)
        evict = inserted & full & state.kf_valid[slot.clamp(0, K - 1).long()]
        hit_obs = evict & (state.obs_kf == slot) & state.obs_valid
        obs_valid = state.obs_valid & ~hit_obs
        count = torch.sum(obs_valid, dim=1)
        mp_outlier = state.mp_outlier | (state.mp_valid & (count == 0))
        row = (torch.arange(K, device=slot.device) == slot) & evict
        A_inc = torch.where(row[:, None], torch.zeros_like(state.A_inc), state.A_inc)
        state = state.replace(obs_valid=obs_valid, mp_outlier=mp_outlier, A_inc=A_inc)
    else:
        raise ValueError(f"unknown keyframe eviction policy {eviction!r}")
    hit = (torch.arange(K, device=slot.device) == slot) & inserted
    state = state.replace(
        kf_pose=torch.where(hit[:, None], pose.to(state.kf_pose.dtype)[None, :], state.kf_pose),
        kf_valid=state.kf_valid | hit,
        kf_timestamp=torch.where(hit, timestamp.to(state.kf_timestamp.dtype), state.kf_timestamp),
        num_kf=torch.where(inserted, state.num_kf + 1, state.num_kf),
    )
    return state, slot, inserted


def _normalize_rows(d: torch.Tensor) -> torch.Tensor:
    return d / torch.clamp_min(torch.sqrt(torch.sum(d * d, dim=-1, keepdim=True)), 1e-12)


def _add_incidence(A_inc, kf_slot, cols):
    K = A_inc.shape[0]
    row = torch.arange(K, device=A_inc.device) == kf_slot.clamp(0, K - 1)
    return torch.where(row[:, None], torch.maximum(A_inc, cols.to(torch.int8)[None, :]), A_inc)


def add_observations(state: VOState, kf_slot, mp_mask, uv, cam_center, pred, depth) -> VOState:
    """``Frame::AddObservedMappoint`` + ``Mappoint::AddObservedByKeyframe``
    over the pool: each selected mappoint takes its first free observation
    slot and updates its viewing normal (``mappoint.h:59-64``).
    ``uv [C, 2]`` and ``depth [C]`` are per mappoint."""
    C, M = state.obs_kf.shape
    free = ~state.obs_valid
    has_free = torch.any(free, dim=1)
    first_free = torch.argmax(free.to(torch.uint8), dim=1)
    do = mp_mask & pred & has_free
    one_hot = (torch.arange(M, device=do.device)[None, :] == first_free[:, None]) & do[:, None]
    d = _normalize_rows(state.mp_pos - cam_center[None, :])
    new_norm = _normalize_rows(state.mp_norm + d)
    return state.replace(
        obs_kf=torch.where(one_hot, kf_slot.to(torch.int32), state.obs_kf),
        obs_uv=torch.where(one_hot[..., None], uv.float()[:, None, :], state.obs_uv),
        obs_depth=torch.where(one_hot, depth.float()[:, None], state.obs_depth),
        obs_valid=state.obs_valid | one_hot,
        mp_norm=torch.where(do[:, None], new_norm, state.mp_norm),
        A_inc=_add_incidence(state.A_inc, kf_slot, do),
    )


def create_mappoints(state: VOState, kf_slot, positions, desc, uv, create_mask, cam_center, pred, depth):
    """``FrontEnd::CreateNewMappoints`` (``src/frontend.cpp:372-406``): the
    rank-th created point takes the rank-th free slot (outlier slots are
    recycled) with the creating keyframe as first observer.  Returns
    ``(state, n_created)``; requests past the free supply are dropped."""
    C, M = state.obs_kf.shape
    N = positions.shape[0]
    create_mask = create_mask & pred
    free_mask = ~state.mp_valid | state.mp_outlier
    rank = (torch.cumsum(create_mask.to(torch.int64), 0) - 1).clamp(0, N - 1)
    free_idx, free_ok = packing.compact_indices(free_mask, N)
    slot = free_idx[rank]
    ok = create_mask & free_ok[rank]
    d = _normalize_rows(positions - cam_center[None, :])
    hit, inv = packing.inverse_lookup(C, slot, ok)
    first_col = torch.arange(M, device=hit.device) == 0
    h1 = hit[:, None]
    return state.replace(
        mp_pos=torch.where(h1, positions[inv], state.mp_pos),
        mp_desc=torch.where(h1, desc[inv], state.mp_desc),
        mp_norm=torch.where(h1, d[inv], state.mp_norm),
        mp_valid=state.mp_valid | hit,
        mp_outlier=state.mp_outlier & ~hit,
        mp_triangulated=state.mp_triangulated & ~hit,
        mp_optimized=state.mp_optimized & ~hit,
        obs_kf=torch.where(h1, torch.where(first_col, kf_slot.to(torch.int32), -1).to(torch.int32)[None, :], state.obs_kf),
        obs_uv=torch.where(h1[..., None], first_col[None, :, None] * uv.float()[inv][:, None, :], state.obs_uv),
        obs_depth=torch.where(h1, first_col[None, :] * depth.float()[inv][:, None], state.obs_depth),
        obs_valid=torch.where(h1, first_col[None, :], state.obs_valid),
        A_inc=_add_incidence(state.A_inc, kf_slot, hit),
    ), torch.sum(ok)


def remove_observations(state: VOState, rm_mask) -> VOState:
    """``Frame::RemoveObservedMappoint`` + outlier marking
    (``src/frame.cpp:123-154``, ``src/mappoint.cpp:39-49``) over the whole
    pool: clear the ``rm_mask [C, M]`` observation slots; a mappoint left
    with no observation becomes an outlier (its slot recyclable).
    :func:`remove_observations_rows` does the same for a compact set of
    rows (BA's write-back)."""
    K = state.A_inc.shape[0]
    C, M = state.obs_kf.shape
    obs_valid = state.obs_valid & ~rm_mask
    mp_outlier = state.mp_outlier | (state.mp_valid & ~torch.any(obs_valid, dim=1))
    # (keyframe, mappoint) pairs are unique, so each removed observation
    # clears its own incidence entry
    rows = torch.where(rm_mask & state.obs_valid, state.obs_kf.clamp(0, K - 1).long(), K)
    A_inc = with_spare(state.A_inc)
    A_inc[rows, torch.arange(C, device=rows.device)[:, None].expand(-1, M)] = 0
    return state.replace(obs_valid=obs_valid, mp_outlier=mp_outlier, A_inc=A_inc[:K])


def remove_observations_rows(state: VOState, pidx, pval, prune) -> VOState:
    """``Frame::RemoveObservedMappoint`` + outlier marking
    (``src/frame.cpp:123-154``, ``src/mappoint.cpp:39-49``) for a compact
    per-point problem: clear the ``prune [B, M]`` observation slots of the
    mappoints ``pidx [B]`` (where ``pval``); a mappoint left with no
    observation becomes an outlier.  ``prune`` is in the pool's own
    ``[C, M]`` row layout, so rows apply as they are."""
    K = state.A_inc.shape[0]
    C, M = state.obs_kf.shape
    prune = prune & pval[:, None]
    old = state.obs_valid[pidx]  # [B, M]
    new = old & ~prune
    obs_valid = with_spare(state.obs_valid)
    obs_valid[torch.where(pval, pidx, C)] = new
    newly_outlier = pval & state.mp_valid[pidx] & ~torch.any(new, dim=1)
    mp_outlier = with_spare(state.mp_outlier)
    mp_outlier[torch.where(newly_outlier, pidx, C)] = True
    hit = prune & old
    rows = torch.where(hit, state.obs_kf[pidx].clamp(0, K - 1).long(), K)
    A_inc = with_spare(state.A_inc)
    A_inc[rows, pidx[:, None].expand(-1, M)] = 0
    return state.replace(obs_valid=obs_valid[:C], mp_outlier=mp_outlier[:C], A_inc=A_inc[:K])
