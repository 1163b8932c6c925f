"""Exact Hamming matching of map candidates against the frame's keypoints.

The reference's copy of the port's ``ops/matching.py`` with the plain
version of kernel K2 (:func:`hamming_nn_reference`: the full distance
matrix from {-1, +1} bits, the masked first-index argmin) in place of the
CUDA kernel, and the adaptive distance gate (``src/frontend.cpp:190-211``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vobench.reference.ops.orb import unpack_bits

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


def nearest_keypoints_packed(cand_desc: torch.Tensor, kp_desc: torch.Tensor, kp_mask: torch.Tensor) -> NearestKeypoints:
    """Nearest valid keypoint for every row of the packed pool: the plain
    version (the program launches kernel K2 here)."""
    return hamming_nn_reference(cand_desc, kp_desc, kp_mask)


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
