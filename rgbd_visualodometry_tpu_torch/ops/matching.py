"""Exact Hamming matching of map candidates against the frame's keypoints.

Counterpart of ``rgbd_visualodometry_tpu/ops/matching.py``.  The
pose-independent half, :func:`nearest_keypoints_packed`, is kernel K2
(``csrc/hamming_nn.cu``) on CUDA and :func:`hamming_nn_reference`, its
plain torch version, on the CPU.  Both read the packed descriptors, so the
port keeps no ``[C, 256]`` bipolar pool: the reference's two matching
layouts give identical distances (``tests/test_pipeline.py:329-340``) and
both map to this one path.  The adaptive distance gate
(``src/frontend.cpp:190-211``) is plain torch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rgbd_visualodometry_tpu_torch import kernels
from rgbd_visualodometry_tpu_torch.ops.orb import unpack_bits

BIG = 1 << 20


class NearestKeypoints(NamedTuple):
    kp_index: torch.Tensor  # [C] int32 best valid keypoint per candidate
    distance: torch.Tensor  # [C] int32 (BIG where no valid keypoint)


class MatchResult(NamedTuple):
    matched: torch.Tensor  # [C] bool
    kp_index: torch.Tensor  # [C] int32
    distance: torch.Tensor  # [C] int32
    min_distance: torch.Tensor  # scalar int32


def hamming_nn_reference(cand_desc: torch.Tensor, kp_desc: torch.Tensor, kp_mask: torch.Tensor) -> NearestKeypoints:
    """Plain torch version of kernel K2: Hamming distances as
    ``(256 - <a, b>) / 2`` over {-1, +1} bits (exact in float32 with TF32
    off), masked keypoints at BIG, first-index argmin."""
    a = (unpack_bits(cand_desc) * 2 - 1).float()
    b = (unpack_bits(kp_desc) * 2 - 1).float()
    dot = a @ b.T  # [C, N], integers of magnitude <= 256: exact
    d = ((256.0 - dot) * 0.5).to(torch.int32)
    d = torch.where(kp_mask[None, :], d, torch.full_like(d, BIG))
    best_d, best_kp = torch.min(d, dim=1)
    return NearestKeypoints(kp_index=best_kp.to(torch.int32), distance=best_d)


def nearest_keypoints_packed(cand_desc: torch.Tensor, kp_desc: torch.Tensor, kp_mask: torch.Tensor) -> NearestKeypoints:
    """Nearest valid keypoint for every row of the packed pool.

    ``cand_desc [C, 8]`` and ``kp_desc [N, 8]`` are int32 words holding the
    uint32 bit patterns, ``kp_mask [N]`` bool.  Kernel K2 on CUDA, the plain
    version on the CPU."""
    if cand_desc.dim() != 2 or cand_desc.shape[1] != 8 or kp_desc.dim() != 2 or kp_desc.shape[1] != 8:
        raise ValueError(f"packed descriptors must be [*, 8], got {tuple(cand_desc.shape)}, {tuple(kp_desc.shape)}")
    if cand_desc.dtype != torch.int32 or kp_desc.dtype != torch.int32 or kp_mask.dtype != torch.bool:
        raise ValueError("descriptors must be int32 and kp_mask bool")
    if kp_mask.shape != (kp_desc.shape[0],):
        raise ValueError("kp_mask must be [N]")
    dev = cand_desc.device
    if not (kp_desc.device == dev and kp_mask.device == dev):
        raise ValueError("all inputs must be on one device")
    if dev.type == "cpu":
        return hamming_nn_reference(cand_desc, kp_desc, kp_mask)
    if dev.type != "cuda":
        raise ValueError(f"nearest_keypoints_packed: no kernel for device {dev}")
    cand_desc = cand_desc.contiguous()
    kp_desc = kp_desc.contiguous()
    kp_mask = kp_mask.contiguous()
    if cand_desc.data_ptr() % 16:
        raise ValueError("cand_desc must be 16-byte aligned")
    C, N = cand_desc.shape[0], kp_desc.shape[0]
    kp_index = torch.empty(C, dtype=torch.int32, device=dev)
    distance = torch.empty(C, dtype=torch.int32, device=dev)
    kernels.HAMMING_NN.launch(cand_desc, kp_desc, kp_mask, C, N, kp_index, distance)
    return NearestKeypoints(kp_index=kp_index, distance=distance)


def gate_matches(
    nn: NearestKeypoints,
    cand_mask: torch.Tensor,
    match_ratio: float = 2.0,
    min_match_distance: float = 30.0,
) -> MatchResult:
    """Keep a candidate iff ``dist <= max(min_dist * match_ratio, 30)``
    (``src/frontend.cpp:190-211``)."""
    row_ok = cand_mask & (nn.distance < BIG)
    min_dis = torch.min(torch.where(row_ok, nn.distance, torch.full_like(nn.distance, BIG)))
    max_dis = torch.clamp_min(min_dis.float() * match_ratio, min_match_distance)
    matched = row_ok & (nn.distance.float() <= max_dis)
    return MatchResult(matched=matched, kp_index=nn.kp_index, distance=nn.distance, min_distance=min_dis)
