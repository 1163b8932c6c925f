"""Rank workers of the port's distributed tests (``tests/test_torch_sharded.py``).

The workers run in processes started with the ``spawn`` method, several to
a ``gloo`` group on the CPU.  This module imports torch, numpy and the port
only: the children load no jax and no file of the JAX package, as on the
machine with the card, and each child reports any such module it finds
loaded.  A group rendezvouses through a file in the test's temporary
directory (``file://``), so tests in parallel workers cannot collide on a
port.

:func:`spawn` runs ``worker(group, rank, world, *args)`` on every rank and
returns the ranks' results, which each child pickles into the directory.
"""

from __future__ import annotations

import os
import pickle
import sys

import numpy as np
import torch
import torch.multiprocessing as mp

# tests/test_torch_parallel.py's tiny configuration (128x96, 64 features, 2
# levels), which tests/test_torch_sharded.py runs with packed matching
TINY = dict(
    image_width=128, image_height=96,
    camera_fx=100.0, camera_fy=100.0, camera_cx=64.0, camera_cy=48.0,
    number_of_features=64, level_pyramid=2, edge_threshold=16,
    max_keyframes=8, max_mappoints=512, max_obs_per_mappoint=4,
    pnp_max_points=128, triangulation_batch=64, ransac_hypotheses=16,
    tracking_map_min_points=10, packed_matching=True,
    ba_max_poses=4, ba_max_points=256, ba_min_frame_gap=0, ba_bf16=False,
)


def spawn(worker, world: int, tmp_dir, *args) -> list:
    """``worker(group, rank, world, *args)`` on ``world`` spawned ranks of
    one gloo group; returns their results in rank order."""
    out = os.path.join(str(tmp_dir), f"{worker.__name__}_{world}")
    os.makedirs(out)
    mp.start_processes(_rank_main, args=(worker, world, out, args), nprocs=world, start_method="spawn")
    results = []
    for r in range(world):
        with open(os.path.join(out, f"rank{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


def foreign_modules() -> list[str]:
    """Loaded modules that a rank must not load: jax, and any file of the
    JAX package."""
    ref = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "rgbd_visualodometry_tpu") + os.sep
    return sorted(n for n, m in list(sys.modules.items())
                  if n == "jax" or n.startswith("jax.")
                  or os.path.abspath(getattr(m, "__file__", None) or "").startswith(ref))


def _rank_main(rank, worker, world, out, args):
    import torch.distributed as dist

    from rgbd_visualodometry_tpu_torch.parallel import open_group

    torch.set_num_threads(1)
    group = open_group("gloo", f"file://{out}/rendezvous", world, rank)
    try:
        result = worker(group, rank, world, *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(dict(result=result, foreign=foreign_modules()), f)


def _np(x):
    return x.detach().cpu().numpy()


def _leaves(state) -> dict:
    return {k: _np(v) for k, v in vars(state).items()}


# ---------------------------------------------------------------------------
# workers
# ---------------------------------------------------------------------------


def primitives_worker(group, rank, world, cases):
    """Every primitive of ``ops.collectives`` on this rank's block of
    each case's whole-pool arrays."""
    from rgbd_visualodometry_tpu_torch.ops import collectives

    out = {}
    for name, case in cases.items():
        C = case["mask"].shape[0]
        shard = collectives.MapShard.of(group, C, "cpu")
        own = slice(shard.offset, shard.offset + shard.local_size)
        blk = {k: torch.from_numpy(v[own].copy()) for k, v in case.items() if k in ("mask", "score", "f32", "i32", "b", "i8")}
        k = case["k"]
        idx = torch.from_numpy(case["idx"])
        lidx, lvalid = torch.from_numpy(case["lidx"]), torch.from_numpy(case["lvalid"])
        r = dict(
            compact=[_np(t) for t in collectives.pool_compact_indices(shard, blk["mask"], k)],
            best=[_np(t) for t in collectives.pool_compact_best_indices(shard, blk["mask"], blk["score"], k)],
            rows=[_np(t) for t in collectives.pool_rows(shard, idx, blk["f32"], blk["i32"], blk["b"], blk["i8"])],
            local_mask=[_np(t) for t in collectives.pool_local_mask(shard, C, lidx, lvalid)],
            to_local=[_np(t) for t in collectives.pool_to_local(shard, lidx, lvalid)],
            sums=[_np(t) for t in collectives.pool_sum(shard, blk["mask"].sum(), blk["i32"].sum(0).float())],
            one_sum=_np(collectives.pool_sum(shard, blk["i32"].sum(0))),
            min=_np(collectives.pool_min(shard, blk["i32"].amin(0))),
            blocks=[_np(t) for t in collectives.all_gather_blocks(shard, blk["mask"], blk["f32"][:3])],
            bcast=[_np(t) for t in collectives.broadcast_tensors(shard, torch.full((2, 3), rank, dtype=torch.float32),
                                                                 torch.tensor(rank % 2 == 1))],
            obj=collectives.broadcast_object(shard, {"rank": rank, "a": np.arange(rank + 2)}),
        )
        out[name] = r
    return out


def match_worker(group, rank, world, cand_desc, cand_mask, kp_desc, kp_mask):
    """``sharded_match_descriptors`` on this rank's rows of the pool."""
    from rgbd_visualodometry_tpu_torch.parallel import sharded_match_descriptors

    Cw = cand_desc.shape[0] // world
    own = slice(rank * Cw, (rank + 1) * Cw)
    res = sharded_match_descriptors(group, torch.from_numpy(cand_desc[own].copy()),
                                    torch.from_numpy(cand_mask[own].copy()), torch.from_numpy(kp_desc),
                                    torch.from_numpy(kp_mask))
    return {k: _np(v) for k, v in res._asdict().items()}


def _inject_levels(levels: dict) -> None:
    """Make ``image.build_pyramid`` return the given levels, looked up by the
    gray image's bytes (the reference pyramid, computed by the parent)."""
    from rgbd_visualodometry_tpu_torch.ops import image as tim

    def lookup(gray, nlevels, scale):
        return [torch.from_numpy(lv) for lv in levels[_np(gray).tobytes()]]

    tim.build_pyramid = lookup


def sharded_vo_worker(group, rank, world, cfg_kw, frames, levels, ckpt_dir):
    """``ShardedMapVO`` over ``frames`` ``(rgb, depth, t)``: per frame its
    results and a checksum of every replicated leaf, then the gathered
    state, one offline ``global_relax`` (report, gathered state, map
    snapshot), a checkpoint round trip and the divisibility check."""
    from rgbd_visualodometry_tpu_torch import VOConfig, mapstate
    from rgbd_visualodometry_tpu_torch.io import checkpoint
    from rgbd_visualodometry_tpu_torch.parallel import ShardedMapVO, map_partition_specs, shard_state
    from rgbd_visualodometry_tpu_torch.pipeline import globalopt

    if levels is not None:
        _inject_levels(levels)
    cfg = VOConfig(**cfg_kw)
    vo = ShardedMapVO(cfg, group, device="cpu")
    replicated = [n for n, d in vars(map_partition_specs()).items() if d is None]
    results, sums = [], []
    for rgb, depth, t in frames:
        r = vo.process(rgb, depth, t)
        results.append(dict(tracked=r.tracked, is_keyframe=r.is_keyframe, fsm=r.fsm, pose_w_c=r.pose_w_c,
                            stats=r.stats))
        sums.append({n: _np(getattr(vo.state, n)).tobytes() for n in replicated})
    out = dict(results=results, replicated=sums, ba_dispatches=vo.ba_dispatches,
               local_rows=int(vo.state.mp_pos.shape[0]), state=_leaves(vo.whole_state()))
    rep = vo.global_relax(loop_gap_s=0.1)
    out["relax"] = dict(report=vars(rep), state=_leaves(vo.whole_state()), snapshot=vo.map_snapshot())
    path = os.path.join(ckpt_dir, "sharded_map.npz")
    before = vo.whole_state()
    if rank == 0:
        checkpoint.save_state(before, cfg, path, meta={"time_base": vo.time_base})
    torch.distributed.barrier(group)
    state, _, meta = checkpoint.load_state(path, with_meta=True, device="cpu")
    vo.state = shard_state(state, vo.shard)
    try:
        shard_state(mapstate.init_state(VOConfig(**dict(cfg_kw, max_mappoints=2 * cfg.max_mappoints)), 0, "cpu"),
                    vo.shard)
        wrong = None
    except ValueError as e:
        wrong = str(e)
    out["checkpoint"] = dict(meta=meta, equal=all(torch.equal(getattr(before, n), getattr(vo.whole_state(), n))
                                                  for n in vars(before)), wrong_capacity=wrong)
    # a relaxation that fails on rank 0, synchronous and asynchronous: which
    # ranks computed one, and what each raised
    calls, raised = [], {}

    def failing(*args, **kwargs):
        calls.append(rank)
        raise FloatingPointError("planted")

    real, globalopt.compute_relaxation = globalopt.compute_relaxation, failing
    try:
        for mode in ("sync", "async"):
            raised[mode] = None
            try:
                if mode == "sync":
                    vo.global_relax(loop_gap_s=0.1)
                else:
                    vo._start_async_relax()
                    vo._finish_async_relax(wait=True)
            except Exception as e:
                raised[mode] = f"{type(e).__name__}: {e}"
    finally:
        globalopt.compute_relaxation = real
    out["relax_failure"] = dict(calls=calls, raised=raised)
    try:
        ShardedMapVO(VOConfig(**dict(cfg_kw, max_mappoints=cfg.max_mappoints + 1)), group, device="cpu")
        out["divisibility"] = None
    except ValueError as e:
        out["divisibility"] = str(e)
    return out


def relax_run_worker(group, rank, world, cfg_kw, frames):
    """``ShardedMapVO.run`` with an online relaxation after every keyframe,
    synchronous then asynchronous: the results as this rank sees them, the
    relaxations run and the gathered state."""
    from rgbd_visualodometry_tpu_torch import VOConfig
    from rgbd_visualodometry_tpu_torch.parallel import ShardedMapVO

    out = {}
    for mode in (False, True):
        cfg = VOConfig(**dict(cfg_kw, relax_every_kf=1, relax_async=mode, relax_loop_gap_s=0.1))
        vo = ShardedMapVO(cfg, group, device="cpu")
        results = vo.run(iter(frames))
        out["async" if mode else "sync"] = dict(
            results=[(r.timestamp, r.tracked, r.is_keyframe, r.fsm, r.pose_w_c) for r in results],
            relaxes=vo.num_auto_relaxes, state=_leaves(vo.whole_state()))
    return out


def multistream_worker(group, rank, world, cfg_kw, n_streams, batches):
    """``MultiStreamVO`` over the ranks: the whole records every rank gets,
    its BA dispatches, its streams, and the divisibility check."""
    from rgbd_visualodometry_tpu_torch import VOConfig
    from rgbd_visualodometry_tpu_torch.parallel import MultiStreamVO

    cfg = VOConfig(**cfg_kw)
    vo = MultiStreamVO(cfg, n_streams, device="cpu", group=group)
    outs = [vo.step(*b) for b in batches]
    vo.finish()
    out = dict(records=np.stack([_np(o.packed) for o in outs]), ba_dispatches=vo.ba_dispatches,
               streams=list(vo.streams), metrics=vo.aggregate_metrics(outs[-1]))
    try:
        MultiStreamVO(cfg, n_streams + 1, device="cpu", group=group)
        out["divisibility"] = None
    except ValueError as e:
        out["divisibility"] = str(e)
    return out
