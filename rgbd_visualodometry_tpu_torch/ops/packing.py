"""Mask -> fixed-size index compaction, and its inverse.

Counterpart of ``rgbd_visualodometry_tpu/ops/packing.py``.  The reference
avoids scatters and sorts (TPU workarounds: searchsorted over a prefix sum,
dense one-hot inversions); the port keeps the results - ascending slot
order, the threshold-bin tie-break by slot - and computes them with plain
torch scatters.  The scatters are out of place, into fresh tensors, so the
functions run under ``torch.func.vmap`` (``parallel/mesh.py``).
"""

from __future__ import annotations

import torch


def top_k(values: torch.Tensor, k: int):
    """``lax.top_k`` along the last axis: ``(values, indices)`` of the ``k``
    largest, ties to the lower index (``torch.topk`` leaves tie order
    unspecified, so a stable sort is used)."""
    vals, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def compact_indices(mask: torch.Tensor, k: int):
    """The lowest ``min(count, k)`` True indices of ``mask`` in ascending
    order, in ``k`` slots; empty slots hold index 0 with ``valid=False``.
    Returns ``(indices int64 [k], valid bool [k])``."""
    n = mask.shape[0]
    rank = torch.cumsum(mask.to(torch.int64), 0) - 1
    keep = mask & (rank < k)
    target = torch.where(keep, rank, torch.full_like(rank, k))
    idx = torch.zeros(k + 1, dtype=torch.int64, device=mask.device).scatter(0, target, torch.arange(n, device=mask.device))
    valid = torch.arange(k, device=mask.device) < torch.sum(mask)
    return torch.where(valid, idx[:k], torch.zeros_like(idx[:k])), valid


def compact_best_indices(mask: torch.Tensor, score: torch.Tensor, k: int, n_bins: int = 258):
    """Up to ``k`` True indices preferring low integer ``score`` (< n_bins - 1);
    ties in the threshold bin go to the lower slot; output in slot order."""
    s = torch.where(mask, score.clamp(0, n_bins - 1), torch.full_like(score, n_bins - 1)).long()
    counts = torch.zeros(n_bins, dtype=torch.int64, device=mask.device).scatter_add(0, s, mask.to(torch.int64))
    ccum = torch.cumsum(counts, 0)
    t = torch.sum(ccum < k)  # searchsorted(ccum, k, side="left"): ccum is ascending
    below = mask & (s < t)
    quota_t = k - torch.sum(below)
    at_t = mask & (s == t)
    keep_t = at_t & (torch.cumsum(at_t.to(torch.int64), 0) <= quota_t)
    return compact_indices(below | keep_t, k)


def scatter_back(size: int, indices: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Expand packed boolean ``values [k]`` to a ``[size]`` mask (invalid
    slots carry ``values=False``)."""
    tgt = torch.where(values, indices, torch.full_like(indices, size))
    out = torch.zeros(size + 1, dtype=torch.bool, device=values.device).scatter(0, tgt, torch.ones_like(values))
    return out[:size]


def inverse_lookup(size: int, indices: torch.Tensor, valid: torch.Tensor):
    """For each slot ``c`` of a ``[size]`` array, which packed row targets it:
    ``(hit bool [size], inv int64 [size])`` with ``indices[inv[c]] == c``
    where ``hit[c]`` (``inv`` is 0 elsewhere).  ``indices`` must be unique
    where ``valid``.  Invalid rows land in a spare slot that is cut off."""
    dev = indices.device
    tgt = torch.where(valid, indices, torch.full_like(indices, size))
    hit = torch.zeros(size + 1, dtype=torch.bool, device=dev).scatter(0, tgt, torch.ones_like(valid))
    inv = torch.zeros(size + 1, dtype=torch.int64, device=dev).scatter(0, tgt, torch.arange(indices.shape[0], device=dev))
    hit, inv = hit[:size], inv[:size]
    return hit, torch.where(hit, inv, torch.zeros_like(inv))
