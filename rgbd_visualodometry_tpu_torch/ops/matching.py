"""Exact Hamming matching of map candidates against the frame's keypoints.

Counterpart of ``rgbd_visualodometry_tpu/ops/matching.py``.  The
pose-independent half, :func:`nearest_keypoints_packed`, is kernel K2
(``csrc/hamming_nn.cu``: popc(a & b) of the packed words on single-bit
tensor cores, the masked argmin fused; S streams in one launch through
the custom op :func:`hamming_nn_streams`, which ``torch.func.vmap``
batches) on CUDA and :func:`hamming_nn_reference`, its plain torch
version, on the CPU.  Both read the packed descriptors, so the
port keeps no ``[C, 256]`` bipolar pool: the reference's two matching
layouts give identical distances (``tests/test_pipeline.py:329-340``) and
both map to this one path.  The adaptive distance gate
(``src/frontend.cpp:190-211``) is plain torch.

:func:`hamming_matrix_packed`, the full ``[C, N]`` distance matrix of
``rgbd_visualodometry_tpu/ops/pallas_match.py``, is kernel K3 (same
source: K2's single-bit tensor-core products, the distances staged in
shared memory and written with 16-byte streaming stores) on CUDA and
:func:`hamming_matrix_reference` on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rgbd_visualodometry_tpu_torch import kernels
from rgbd_visualodometry_tpu_torch.ops.orb import unpack_bits
from rgbd_visualodometry_tpu_torch.ops import collectives

BIG = 1 << 20


class NearestKeypoints(NamedTuple):
    kp_index: torch.Tensor  # [C] int32 best valid keypoint per candidate
    distance: torch.Tensor  # [C] int32 (BIG where no valid keypoint)


class MatchResult(NamedTuple):
    matched: torch.Tensor  # [C] bool
    kp_index: torch.Tensor  # [C] int32
    distance: torch.Tensor  # [C] int32
    min_distance: torch.Tensor  # scalar int32


def hamming_matrix_reference(cand_desc: torch.Tensor, kp_desc: torch.Tensor) -> torch.Tensor:
    """Plain torch version of kernel K3: ``[C, N]`` int32 Hamming distances
    as ``(256 - <a, b>) / 2`` over {-1, +1} bits (exact in float32 with TF32
    off: integers of magnitude <= 256)."""
    a = (unpack_bits(cand_desc) * 2 - 1).float()
    b = (unpack_bits(kp_desc) * 2 - 1).float()
    return ((256.0 - a @ b.T) * 0.5).to(torch.int32)


def hamming_nn_reference(cand_desc: torch.Tensor, kp_desc: torch.Tensor, kp_mask: torch.Tensor) -> NearestKeypoints:
    """Plain torch version of kernel K2: the distance matrix with masked
    keypoints at BIG, first-index argmin."""
    d = hamming_matrix_reference(cand_desc, kp_desc)
    d = torch.where(kp_mask[None, :], d, torch.full_like(d, BIG))
    best_d, best_kp = torch.min(d, dim=1)
    return NearestKeypoints(kp_index=best_kp.to(torch.int32), distance=best_d)


def _check_packed(cand_desc: torch.Tensor, kp_desc: torch.Tensor) -> None:
    if cand_desc.dim() != 2 or cand_desc.shape[1] != 8 or kp_desc.dim() != 2 or kp_desc.shape[1] != 8:
        raise ValueError(f"packed descriptors must be [*, 8], got {tuple(cand_desc.shape)}, {tuple(kp_desc.shape)}")
    if cand_desc.dtype != torch.int32 or kp_desc.dtype != torch.int32:
        raise ValueError("descriptors must be int32")
    if kp_desc.device != cand_desc.device:
        raise ValueError("all inputs must be on one device")


@torch.library.custom_op("rgbdvo::hamming_nn_streams", mutates_args=())
def hamming_nn_streams(cand_desc: torch.Tensor, kp_desc: torch.Tensor, kp_mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest valid keypoint of every pool row, for S streams at once:
    ``cand_desc [S, C, 8]``, ``kp_desc [S, N, 8]`` int32 words and
    ``kp_mask [S, N]`` bool -> ``(kp_index, distance)``, each ``[S, C]``
    int32.  One launch of kernel K2 on CUDA, the plain version per stream on
    the CPU.  Under ``torch.func.vmap`` the vmapped axis joins the stream
    axis: still one launch."""
    raise ValueError(f"nearest_keypoints_packed: no kernel for device {cand_desc.device}")


@hamming_nn_streams.register_kernel("cpu")
def _hamming_nn_streams_plain(cand_desc, kp_desc, kp_mask):
    if cand_desc.shape[0] == 0:
        empty = cand_desc.new_empty((0, cand_desc.shape[1]))
        return empty, empty.clone()
    nn = [hamming_nn_reference(c, k, m) for c, k, m in zip(cand_desc, kp_desc, kp_mask)]
    return torch.stack([r.kp_index for r in nn]), torch.stack([r.distance for r in nn])


@hamming_nn_streams.register_kernel("cuda")
def _hamming_nn_streams_kernel(cand_desc, kp_desc, kp_mask):
    cand_desc = cand_desc.contiguous()
    kp_desc = kp_desc.contiguous()
    kp_mask = kp_mask.contiguous()
    if cand_desc.data_ptr() % 16 or kp_desc.data_ptr() % 16:
        raise ValueError("descriptors must be 16-byte aligned")
    S, C, N = cand_desc.shape[0], cand_desc.shape[1], kp_desc.shape[1]
    kp_index = torch.empty((S, C), dtype=torch.int32, device=cand_desc.device)
    distance = torch.empty((S, C), dtype=torch.int32, device=cand_desc.device)
    if S:
        kernels.HAMMING_NN.launch(cand_desc, kp_desc, kp_mask, S, C, N, kp_index, distance)
    return kp_index, distance


@hamming_nn_streams.register_fake
def _hamming_nn_streams_shape(cand_desc, kp_desc, kp_mask):
    out = cand_desc.new_empty(cand_desc.shape[:2])
    return out, out.clone()


@hamming_nn_streams.register_vmap
def _hamming_nn_streams_vmap(info, in_dims, cand_desc, kp_desc, kp_mask):
    B = info.batch_size
    idx, dist = hamming_nn_streams(*(kernels.fold_streams(x, d, B) for x, d in zip((cand_desc, kp_desc, kp_mask), in_dims)))
    return (idx.reshape(B, -1, idx.shape[-1]), dist.reshape(B, -1, dist.shape[-1])), (0, 0)


def nearest_keypoints_packed(cand_desc: torch.Tensor, kp_desc: torch.Tensor, kp_mask: torch.Tensor) -> NearestKeypoints:
    """Nearest valid keypoint for every row of the packed pool.

    ``cand_desc [C, 8]`` and ``kp_desc [N, 8]`` are int32 words holding the
    uint32 bit patterns, ``kp_mask [N]`` bool.  Kernel K2 on CUDA, the plain
    version on the CPU (:func:`hamming_nn_streams` with one stream)."""
    _check_packed(cand_desc, kp_desc)
    if kp_mask.dtype != torch.bool or kp_mask.shape != (kp_desc.shape[0],):
        raise ValueError("kp_mask must be bool [N]")
    dev = cand_desc.device
    if kp_mask.device != dev:
        raise ValueError("all inputs must be on one device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"nearest_keypoints_packed: no kernel for device {dev}")
    kp_index, distance = hamming_nn_streams(cand_desc[None], kp_desc[None], kp_mask[None])
    return NearestKeypoints(kp_index=kp_index[0], distance=distance[0])


def hamming_matrix_packed(cand_desc: torch.Tensor, kp_desc: torch.Tensor) -> torch.Tensor:
    """``[C, N]`` int32 Hamming distances between every row of the packed
    pool ``cand_desc [C, 8]`` and every packed keypoint ``kp_desc [N, 8]``
    (int32 words holding the uint32 bit patterns).  Kernel K3 on CUDA, the
    plain version on the CPU."""
    _check_packed(cand_desc, kp_desc)
    dev = cand_desc.device
    if dev.type == "cpu":
        return hamming_matrix_reference(cand_desc, kp_desc)
    if dev.type != "cuda":
        raise ValueError(f"hamming_matrix_packed: no kernel for device {dev}")
    cand_desc = cand_desc.contiguous()
    kp_desc = kp_desc.contiguous()
    if cand_desc.data_ptr() % 16 or kp_desc.data_ptr() % 16:
        raise ValueError("descriptors must be 16-byte aligned")
    C, N = cand_desc.shape[0], kp_desc.shape[0]
    out = torch.empty((C, N), dtype=torch.int32, device=dev)
    if C and N:
        kernels.HAMMING_MATRIX.launch(cand_desc, kp_desc, C, N, out)
    return out


def gate_matches(
    nn: NearestKeypoints,
    cand_mask: torch.Tensor,
    match_ratio: float = 2.0,
    min_match_distance: float = 30.0,
    shard=None,
) -> MatchResult:
    """Keep a candidate iff ``dist <= max(min_dist * match_ratio, 30)``
    (``src/frontend.cpp:190-211``).  On a pool split over ranks
    (``shard``, a :class:`collectives.MapShard`) ``min_dist`` is the minimum
    over every rank's rows (``lax.pmin``)."""
    row_ok = cand_mask & (nn.distance < BIG)
    min_dis = collectives.pool_min(shard, torch.min(torch.where(row_ok, nn.distance, torch.full_like(nn.distance, BIG))))
    max_dis = torch.clamp_min(min_dis.float() * match_ratio, min_match_distance)
    matched = row_ok & (nn.distance.float() <= max_dis)
    return MatchResult(matched=matched, kp_index=nn.kp_index, distance=nn.distance, min_distance=min_dis)


def match_descriptors(
    cand_desc: torch.Tensor,
    cand_mask: torch.Tensor,
    kp_desc: torch.Tensor,
    kp_mask: torch.Tensor,
    match_ratio: float = 2.0,
    min_match_distance: float = 30.0,
) -> MatchResult:
    """For every valid candidate row of the packed pool ``cand_desc [C, 8]``,
    its nearest valid keypoint of ``kp_desc [N, 8]`` (K2) and the adaptive
    distance gate: the JAX package's ``match_descriptors`` on the same
    descriptors in its bipolar form (``flannMatcher_.match(candidateDescs,
    currDescs)``, ``src/frontend.cpp:187``; several candidates may share a
    keypoint)."""
    return gate_matches(nearest_keypoints_packed(cand_desc, kp_desc, kp_mask), cand_mask, match_ratio, min_match_distance)
