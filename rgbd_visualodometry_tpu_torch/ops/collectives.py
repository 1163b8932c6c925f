"""Cross-rank primitives over a pool split into contiguous blocks.

The JAX package shards the map-point axis C with a ``NamedSharding`` and
leaves the reductions over it to XLA's SPMD partitioner
(``rgbd_visualodometry_tpu/parallel/mesh.py:243-253``).  torch has no
partitioner, so the port's step calls these primitives where it reduces,
compacts or gathers over C, and each one issues its collectives itself.

A :class:`MapShard` describes one rank's block: of an axis of ``size``
entries split over the ``world`` ranks of ``group``, rank ``r`` owns the
global indices ``[r * size / world, (r + 1) * size / world)``.  Ascending
global order is therefore rank order, then local order, which is what makes
the compactions below equal to their single-process versions.  The same
record splits the streams of a multi-process ``MultiStreamVO``.

Every primitive is built on ``dist.all_reduce`` (SUM and MIN) and
``dist.broadcast`` alone, so one code path runs on gloo with CPU tensors,
on gloo with CUDA tensors (where torch's gloo backend offers only those
two) and on NCCL.  A gather of blocks or rows is an all-reduce SUM of bytes
into a zeroed buffer that only the owner of each entry fills: every byte
has one nonzero contributor, so the sum is exact, whatever the dtype.

With ``shard=None`` each primitive is the local op it stands for
(``packing.compact_indices``, an index, a sum), issuing no extra launch: the
single-process ``VisualOdometry`` and the vmapped ``MultiStreamVO`` run the
same code as before.
"""

from __future__ import annotations

import dataclasses
import math
import pickle

import torch
import torch.distributed as dist

from rgbd_visualodometry_tpu_torch.ops import packing


@dataclasses.dataclass(frozen=True)
class MapShard:
    """This rank's contiguous block of an axis of ``size`` entries split
    over the ranks of ``group``; collectives run on ``device``."""

    group: object  # a torch.distributed ProcessGroup
    rank: int
    world: int
    size: int
    device: torch.device

    @classmethod
    def of(cls, group, size: int, device) -> "MapShard":
        world = dist.get_world_size(group)
        if size % world:
            raise ValueError(f"{size} entries must divide evenly over {world} ranks")
        return cls(group, dist.get_rank(group), world, size, torch.device(device))

    @property
    def local_size(self) -> int:
        return self.size // self.world

    @property
    def offset(self) -> int:
        return self.rank * self.local_size


# ---------------------------------------------------------------------------
# byte packing: tensors of any dtype through one collective
# ---------------------------------------------------------------------------


def _pack(tensors) -> torch.Tensor:
    """Tensors with a common leading axis ``[L, ...]`` -> one ``[L, bytes]``
    uint8 buffer, each tensor's segment padded to 8 bytes so that it views
    back as its dtype."""
    parts = []
    for x in tensors:
        b = x.contiguous().reshape(x.shape[0], math.prod(x.shape[1:])).view(torch.uint8)
        pad = -b.shape[1] % 8
        parts.append(torch.nn.functional.pad(b, (0, pad)) if pad else b)
    return torch.cat(parts, dim=1)


def _unpack(buf: torch.Tensor, likes):
    """Inverse of :func:`_pack`: ``buf [R, bytes]`` -> one ``[R, *like.shape[1:]]``
    tensor for each of the tensors ``likes`` that were packed."""
    out, off = [], 0
    for x in likes:
        n = math.prod(x.shape[1:]) * x.element_size()
        seg = buf[:, off : off + n].contiguous().view(x.dtype)
        out.append(seg.reshape((buf.shape[0],) + tuple(x.shape[1:])))
        off += n + (-n % 8)
    return out


def _sum_(shard: MapShard, x: torch.Tensor) -> torch.Tensor:
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=shard.group)
    return x


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


def pool_sum(shard: MapShard | None, *xs: torch.Tensor):
    """The sums over all ranks of same-shaped integer (or exactly summable)
    tensors, in one all-reduce; with ``shard=None`` the tensors as they are.
    One tensor in, one out; several in, a tuple out."""
    if shard is not None:
        flat = torch.cat([x.reshape(-1).to(torch.float64 if x.is_floating_point() else torch.int64) for x in xs])
        flat = _sum_(shard, flat)
        sizes = [x.numel() for x in xs]
        xs = tuple(p.reshape(x.shape).to(x.dtype) for p, x in zip(flat.split(sizes), xs))
    return xs[0] if len(xs) == 1 else tuple(xs)


def pool_min(shard: MapShard | None, x: torch.Tensor) -> torch.Tensor:
    """The elementwise minimum over all ranks (``lax.pmin``)."""
    if shard is None:
        return x
    y = x.reshape(-1).clone()
    dist.all_reduce(y, op=dist.ReduceOp.MIN, group=shard.group)
    return y.reshape(x.shape)


def all_gather_blocks(shard: MapShard, *xs: torch.Tensor):
    """Every rank's ``x`` (same shape and dtype on all ranks), stacked in
    rank order: ``[world, *x.shape]`` for each ``x``, one all-reduce."""
    W = shard.world
    likes = [x.reshape(1, -1) for x in xs]
    mine = _pack(likes)
    buf = torch.zeros((W, mine.shape[1]), dtype=torch.uint8, device=mine.device)
    buf[shard.rank] = mine[0]
    buf = _sum_(shard, buf)
    return [g.reshape((W,) + tuple(x.shape)) for g, x in zip(_unpack(buf, likes), xs)]


def pool_compact_indices(shard: MapShard | None, mask: torch.Tensor, k: int):
    """``packing.compact_indices`` over the whole pool from each rank's local
    ``mask``: the lowest ``min(count, k)`` global indices in ascending
    order, in ``k`` slots (empty ones 0, ``valid`` False), the same on every
    rank.  One all-reduce: each rank's lowest ``k`` and its count."""
    if shard is None:
        return packing.compact_indices(mask, k)
    dev = mask.device
    idx, ok = packing.compact_indices(mask, k)
    mine = torch.cat([torch.where(ok, idx + shard.offset, torch.zeros_like(idx)), torch.sum(mask).reshape(1)])
    (blocks,) = all_gather_blocks(shard, mine)
    cand, counts = blocks[:, :k], blocks[:, k]
    prefix = torch.cumsum(counts, 0) - counts  # global rank of each rank's first entry
    j = torch.arange(k, device=dev)
    pos = prefix[:, None] + j[None, :]
    take = (j[None, :] < counts[:, None]) & (pos < k)
    out = torch.zeros(k + 1, dtype=torch.int64, device=dev)
    out = out.scatter(0, torch.where(take, pos, k).reshape(-1), cand.reshape(-1))[:k]
    valid = j < torch.sum(counts)
    return out, valid


def pool_compact_best_indices(shard: MapShard | None, mask: torch.Tensor, score: torch.Tensor, k: int,
                              n_bins: int = 258):
    """``packing.compact_best_indices`` over the whole pool: the histogram
    of ``score`` summed over ranks gives the global threshold bin, and the
    threshold bin's quota is shared out in global slot order through the
    lower ranks' counts in that bin.  Two all-reduces."""
    if shard is None:
        return packing.compact_best_indices(mask, score, k, n_bins)
    dev = mask.device
    s = torch.where(mask, score.clamp(0, n_bins - 1), torch.full_like(score, n_bins - 1)).long()
    local = torch.zeros(n_bins, dtype=torch.int64, device=dev).scatter_add(0, s, mask.to(torch.int64))
    (hist,) = all_gather_blocks(shard, local)  # [W, n_bins]
    counts = torch.sum(hist, 0)
    t = torch.sum(torch.cumsum(counts, 0) < k)  # searchsorted(ccum, k, side="left")
    bins = torch.arange(n_bins, device=dev)
    quota_t = k - torch.sum(torch.where(bins < t, counts, 0))
    at_t = mask & (s == t)
    lower = torch.sum(torch.where(torch.arange(shard.world, device=dev) < shard.rank,
                                  hist.index_select(1, t.clamp_max(n_bins - 1).reshape(1))[:, 0], 0))
    keep_t = at_t & (lower + torch.cumsum(at_t.to(torch.int64), 0) <= quota_t)
    return pool_compact_indices(shard, (mask & (s < t)) | keep_t, k)


def pool_rows(shard: MapShard | None, idx: torch.Tensor, *tensors: torch.Tensor):
    """``[x[idx] for x in tensors]`` for global indices ``idx`` into the
    pool, each row supplied by the rank that owns it (one all-reduce of
    bytes); ``idx`` must lie in ``[0, size)``.  The same on every rank."""
    if shard is None:
        return [x[idx] for x in tensors]
    local = idx - shard.offset
    own = (local >= 0) & (local < shard.local_size)
    li = local.clamp(0, shard.local_size - 1)
    rows = [x[li] for x in tensors]
    buf = _pack(rows)
    buf = _sum_(shard, torch.where(own[:, None], buf, torch.zeros_like(buf)))
    return _unpack(buf, rows)


def pool_to_local(shard: MapShard | None, idx: torch.Tensor, valid: torch.Tensor):
    """Global indices -> ``(local index, owned)``: the entries this rank
    holds, their local slot, and ``valid`` cleared for the others (local
    index 0 there); with ``shard=None``, ``(idx, valid)``."""
    if shard is None:
        return idx, valid
    local = idx - shard.offset
    own = valid & (local >= 0) & (local < shard.local_size)
    return torch.where(own, local, torch.zeros_like(local)), own


def pool_local_mask(shard: MapShard | None, size: int, idx: torch.Tensor, valid: torch.Tensor):
    """Global indices -> this rank's ``[local size]`` mask of the slots they
    hit and, for each hit slot, which entry hits it:
    ``packing.inverse_lookup`` on the rank's block (of ``size`` slots
    without a shard)."""
    if shard is None:
        return packing.inverse_lookup(size, idx, valid)
    return packing.inverse_lookup(shard.local_size, *pool_to_local(shard, idx, valid))


def broadcast_tensors(shard: MapShard | None, *tensors: torch.Tensor):
    """Rank 0's values of replicated tensors, on every rank, in one
    broadcast.  Ranks compute the replicated work each on their own; where
    it decides what a rank writes into its block, they take rank 0's result
    first, so that run-to-run rounding (CUDA atomics) cannot set two ranks'
    writes apart."""
    if shard is None:
        return tensors
    likes = [x.reshape(1, -1) for x in tensors]
    buf = _pack(likes)
    dist.broadcast(buf, src=dist.get_global_rank(shard.group, 0), group=shard.group)
    return tuple(g.reshape(x.shape) for g, x in zip(_unpack(buf, likes), tensors))


def broadcast_object(shard: MapShard, obj):
    """Rank 0's ``obj`` (picklable, tensors on the CPU) on every rank: its
    length, then its bytes, each one broadcast on ``shard.device``."""
    src = dist.get_global_rank(shard.group, 0)
    data = pickle.dumps(obj) if shard.rank == 0 else b""
    n = torch.tensor([len(data)], dtype=torch.int64, device=shard.device)
    dist.broadcast(n, src=src, group=shard.group)
    buf = torch.zeros(int(n), dtype=torch.uint8, device=shard.device)
    if shard.rank == 0:
        buf.copy_(torch.frombuffer(bytearray(data), dtype=torch.uint8))
    dist.broadcast(buf, src=src, group=shard.group)
    return obj if shard.rank == 0 else pickle.loads(buf.cpu().numpy().tobytes())
