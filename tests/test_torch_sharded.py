"""The port's multi-process half (``rgbd_visualodometry_tpu_torch/parallel``)
against the JAX package's device-mesh half, on the CPU.

Ranks are processes spawned into a gloo group (``tests/torch_dist.py``, which
loads no jax: every test also checks that no rank loaded jax or a file of
the JAX package).  The JAX side runs on the virtual CPU devices of
``tests/conftest.py``.  Configuration: ``tests/test_torch_parallel.py``'s
tiny one (128x96, 64 features, 2 levels, 512 map points, local BA on with
``ba_bf16=False``) with packed matching.

- ``map_partition_specs``: equal to the JAX function's on every leaf, through
  the layout permutation ``mapstate._perm``.
- The primitives of ``ops.collectives`` for 2 and 4 ranks: exactly
  the single-process ``packing`` functions, indexing and sums on the whole
  arrays, on masks with threshold-bin ties across a block boundary, empty
  blocks, more hits than slots and no hit at all.
- ``sharded_match_descriptors`` on 2 ranks: exactly the JAX function on a
  2-device mesh.
- ``ShardedMapVO`` on 2 ranks, 5 frames, on the reference's pyramid levels:
  against the JAX ``ShardedMapVO`` on a 2-device ``map`` mesh, ``tracked``,
  ``is_keyframe`` and ``fsm`` equal and poses within 1 mm and 0.05 degrees
  (as ``test_torch_parallel.py``); against the port's ``VisualOdometry``,
  the gathered state's integer and boolean leaves equal and float leaves
  within 1e-5, the replicated leaves bit-equal across ranks after every
  frame.  One offline ``global_relax`` and an online relaxation after
  every keyframe (synchronous) equal ``VisualOdometry``'s within 1e-5; with
  ``relax_async`` both ranks see the same results.  Rank 0 alone computes
  a relaxation, and one that fails there raises on both ranks.
- ``MultiStreamVO`` with 4 streams over 2 ranks: against 4 streams in one
  process, integer and boolean record fields equal, poses within 1e-5 (a
  quaternion and its negation are one rotation: a vmapped batch of 2 and
  one of 4 can come out with opposite signs), the same BA dispatches.
"""

import numpy as np
import pytest
import torch

import torch_dist
from torch_parity import quat_angle_deg, reference_pyramid, x64_off  # noqa: F401
from rgbd_visualodometry_tpu.config import VOConfig as JaxVOConfig
from rgbd_visualodometry_tpu.mapstate import init_state as jax_init_state
from rgbd_visualodometry_tpu.ops import matching as jmatching
from rgbd_visualodometry_tpu.parallel import ShardedMapVO as JaxShardedMapVO
from rgbd_visualodometry_tpu.parallel import make_mesh
from rgbd_visualodometry_tpu.parallel import map_partition_specs as jax_map_partition_specs
from rgbd_visualodometry_tpu.parallel import sharded_match_descriptors as jax_sharded_match
from rgbd_visualodometry_tpu_torch import VOConfig, VisualOdometry, mapstate
from rgbd_visualodometry_tpu_torch.io import synthetic
from rgbd_visualodometry_tpu_torch.ops import image as tim
from rgbd_visualodometry_tpu_torch.ops import packing
from rgbd_visualodometry_tpu_torch.parallel import MultiStreamVO, map_partition_specs

pytestmark = pytest.mark.usefixtures("x64_off")

TINY = torch_dist.TINY
FLAGS = slice(14, 29)  # StepOutput._FIELDS: every integer and boolean field


def _results(runs):
    """The ranks' results, after checking that no rank loaded jax or a file
    of the JAX package."""
    for r, run in enumerate(runs):
        assert run["foreign"] == [], f"rank {r} loaded {run['foreign']}"
    return [run["result"] for run in runs]


def _frames(n=5):
    scene = synthetic.SyntheticScene(width=128, height=96, fx=100.0, fy=100.0, cx=64.0, cy=48.0, cell_size=0.12)
    return synthetic.generate_sequence(n, scene=scene, step_t=(0.04, 0.01, 0.0))


def _assert_close_state(got: dict, want: dict, atol=1e-5):
    """Integer and boolean leaves equal, float leaves within ``atol``."""
    assert got.keys() == want.keys()
    for k in want:
        if np.issubdtype(want[k].dtype, np.floating):
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# layout
# ---------------------------------------------------------------------------


def test_map_partition_specs_match_jax():
    jcfg = JaxVOConfig(**TINY)
    jspecs = jax_map_partition_specs(jcfg, "map")._asdict()
    jleaves = jax_init_state(jcfg)._asdict()
    got = vars(map_partition_specs())
    assert set(jspecs) - set(got) == {"mp_bip"}  # the port keeps no bipolar pool
    for name, dim in got.items():
        spec = tuple(jspecs[name]) + (None,) * (jleaves[name].ndim - len(tuple(jspecs[name])))
        jdim = spec.index("map") if "map" in spec else None
        if jdim is None:
            assert dim is None, name
            continue
        perm = mapstate._perm(name, 0) if name in mapstate._CMINOR else tuple(range(len(spec)))
        assert perm.index(jdim) == dim, name


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

C_PRIM = 96  # 48 rows a rank at 2, 24 at 4


def _case(seed, mask, score, k):
    """A mask and scores over the whole pool, rows of several dtypes, row
    indices (repeats, both ends, a block boundary) and unique slots with a
    validity mask for the inverse lookup."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, C_PRIM, 40).astype(np.int64)
    idx[:4] = [0, C_PRIM - 1, 47, 48]
    return dict(
        mask=mask, score=score.astype(np.int32), k=k, idx=idx,
        lidx=rng.choice(C_PRIM, 12, replace=False).astype(np.int64), lvalid=rng.random(12) < 0.7,
        f32=rng.normal(size=(C_PRIM, 3)).astype(np.float32), i32=rng.integers(-99, 99, (C_PRIM, 8)).astype(np.int32),
        b=rng.random((C_PRIM, 4)) < 0.5, i8=rng.integers(-3, 3, (C_PRIM, 2)).astype(np.int8),
    )


def _cases():
    rng = np.random.default_rng(7)
    ties = np.zeros(C_PRIM, bool)
    ties[20:76] = True  # hits on every block at 2 and at 4 ranks
    score = np.full(C_PRIM, 40)  # one threshold bin, straddling the boundaries
    score[[21, 50, 70]] = 3
    score[[30, 60]] = 300  # past the last bin: clamped into it
    last_only = np.zeros(C_PRIM, bool)
    last_only[80:] = True  # the lower blocks are empty
    full = np.ones(C_PRIM, bool)
    return {
        "threshold-bin ties across blocks": _case(1, ties, score, 20),
        "empty blocks": _case(2, last_only, rng.integers(0, 258, C_PRIM), 12),
        "more hits than slots": _case(3, full, rng.integers(0, 5, C_PRIM), 30),
        "fewer hits than slots": _case(4, rng.random(C_PRIM) < 0.15, rng.integers(0, 258, C_PRIM), 40),
        "no hit": _case(5, np.zeros(C_PRIM, bool), rng.integers(0, 258, C_PRIM), 8),
    }


CASES = _cases()


@pytest.fixture(scope="module")
def primitive_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("primitives")
    return {W: _results(torch_dist.spawn(torch_dist.primitives_worker, W, tmp, CASES)) for W in (2, 4)}


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", list(CASES))
def test_collective_primitives_match_single_process(primitive_runs, world, name):
    c = CASES[name]
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    mask, score, k, idx = t(c["mask"]), t(c["score"]), c["k"], t(c["idx"])
    want_compact = [x.numpy() for x in packing.compact_indices(mask, k)]
    want_best = [x.numpy() for x in packing.compact_best_indices(mask, score, k)]
    want_rows = [t(c[n])[idx].numpy() for n in ("f32", "i32", "b", "i8")]
    lidx, lval = t(c["lidx"]), t(c["lvalid"])
    hit, inv = packing.inverse_lookup(C_PRIM, lidx, lval)
    Cw = C_PRIM // world
    for rank, got in enumerate(primitive_runs[world]):
        r = got[name]
        for a, b in zip(r["compact"], want_compact):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(r["best"], want_best):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(r["rows"], want_rows):
            np.testing.assert_array_equal(a, b)
        own = slice(rank * Cw, (rank + 1) * Cw)
        np.testing.assert_array_equal(r["local_mask"][0], hit[own].numpy())
        np.testing.assert_array_equal(r["local_mask"][1], inv[own].numpy())
        owned = lval.numpy() & (lidx.numpy() // Cw == rank)
        np.testing.assert_array_equal(r["to_local"][1], owned)
        np.testing.assert_array_equal(r["to_local"][0], np.where(owned, lidx.numpy() - rank * Cw, 0))
        assert int(r["sums"][0]) == int(c["mask"].sum())
        np.testing.assert_array_equal(r["sums"][1], c["i32"].sum(0).astype(np.float32))
        np.testing.assert_array_equal(r["one_sum"], c["i32"].sum(0))
        np.testing.assert_array_equal(r["min"], c["i32"].min(0))
        np.testing.assert_array_equal(r["blocks"][0], c["mask"].reshape(world, Cw))
        np.testing.assert_array_equal(r["blocks"][1], c["f32"].reshape(world, Cw, 3)[:, :3])
        np.testing.assert_array_equal(r["bcast"][0], np.zeros((2, 3), np.float32))
        assert r["bcast"][1].dtype == np.bool_ and not r["bcast"][1]
        assert r["obj"]["rank"] == 0 and list(r["obj"]["a"]) == [0, 1]


# ---------------------------------------------------------------------------
# sharded matching
# ---------------------------------------------------------------------------


def test_sharded_match_descriptors_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    C, N = 512, 64
    cand_bits = rng.integers(0, 2, (C, 256)).astype(np.uint8)
    kp_bits = rng.integers(0, 2, (N, 256)).astype(np.uint8)
    kp_bits[:5] = cand_bits[[3, 300, 301, 400, 511]] ^ (rng.random((5, 256)) < 0.05)  # close matches on both ranks
    cand_mask = rng.random(C) < 0.8
    kp_mask = rng.random(N) < 0.9

    def words(bits):  # LSB first within each 32-bit word, as ops.orb packs them
        w = (bits.reshape(-1, 8, 32).astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(-1)
        return w.astype(np.uint32).view(np.int32)

    runs = _results(torch_dist.spawn(torch_dist.match_worker, 2, tmp_path, words(cand_bits), cand_mask,
                                     words(kp_bits), kp_mask))
    mesh = make_mesh(2, axis="map")
    want = jax_sharded_match(mesh, (cand_bits.astype(np.int8) * 2 - 1), cand_mask, (kp_bits.astype(np.int8) * 2 - 1),
                             kp_mask)
    for key in ("matched", "kp_index", "distance"):
        np.testing.assert_array_equal(np.concatenate([r[key] for r in runs]), np.asarray(getattr(want, key)), key)
    for r in runs:
        assert int(r["min_distance"]) == int(want.min_distance)
    single = jmatching.match_descriptors(cand_bits.astype(np.int8) * 2 - 1, cand_mask,
                                         kp_bits.astype(np.int8) * 2 - 1, kp_mask)
    assert int(single.min_distance) == int(want.min_distance) and np.asarray(single.matched).sum() > 0


# ---------------------------------------------------------------------------
# ShardedMapVO
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def frames():
    return _frames()


@pytest.fixture(scope="module")
def reference_levels(frames):
    """The reference's pyramid levels of every frame, by gray image bytes,
    for the ranks (which load no jax)."""
    levels = {}
    for f in frames:
        gray = tim.rgb_to_gray(torch.from_numpy(f.rgb))
        cfg = VOConfig(**TINY)
        levels[gray.numpy().tobytes()] = [lv.numpy() for lv in reference_pyramid(gray, cfg.level_pyramid,
                                                                                  cfg.scale_factor)]
    return levels


@pytest.fixture(scope="module")
def sharded_run(frames, reference_levels, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded")
    feed = [(f.rgb, f.depth, f.timestamp) for f in frames]
    return _results(torch_dist.spawn(torch_dist.sharded_vo_worker, 2, tmp, TINY, feed, reference_levels, str(tmp)))


@pytest.fixture(scope="module")
def port_run(frames):
    """The port's ``VisualOdometry`` on the same frames and pyramid levels:
    per-frame results, the state, then one offline relax."""
    saved = tim.build_pyramid
    tim.build_pyramid = reference_pyramid
    try:
        vo = VisualOdometry(VOConfig(**TINY), device="cpu")
        results = [vo.process(f.rgb, f.depth, f.timestamp) for f in frames]
        state = {k: v.numpy().copy() for k, v in vars(vo.state).items()}
        report = vo.global_relax(loop_gap_s=0.1)
        relaxed = {k: v.numpy().copy() for k, v in vars(vo.state).items()}
        return dict(results=results, state=state, report=report, relaxed=relaxed, snapshot=vo.map_snapshot(),
                    ba_dispatches=vo.ba_dispatches)
    finally:
        tim.build_pyramid = saved


def test_sharded_map_vo_matches_jax(sharded_run, frames):
    vo = JaxShardedMapVO(JaxVOConfig(**TINY), make_mesh(2, axis="map"))
    want = [vo.process(f.rgb, f.depth, f.timestamp) for f in frames]
    assert "map" in str(vo.state.obs_uv.sharding.spec)
    for run in sharded_run:
        for got, w in zip(run["results"], want, strict=True):
            assert (got["tracked"], got["is_keyframe"], got["fsm"]) == (w.tracked, w.is_keyframe, w.fsm)
            assert np.abs(got["pose_w_c"][4:7] - w.pose_w_c[4:7]).max() < 1e-3
            assert quat_angle_deg(got["pose_w_c"][:4], w.pose_w_c[:4]) < 0.05
    assert all(r["tracked"] for r in sharded_run[0]["results"])
    assert sum(r["is_keyframe"] for r in sharded_run[0]["results"]) >= 2


def test_sharded_map_vo_matches_visual_odometry(sharded_run, port_run):
    assert sharded_run[0]["local_rows"] == sharded_run[1]["local_rows"] == TINY["max_mappoints"] // 2
    # the replicated leaves are bit-equal across ranks after every frame
    assert sharded_run[0]["replicated"] == sharded_run[1]["replicated"]
    for run in sharded_run:
        for got, want in zip(run["results"], port_run["results"], strict=True):
            assert (got["tracked"], got["is_keyframe"], got["fsm"], got["stats"]) == (
                want.tracked, want.is_keyframe, want.fsm, want.stats)
            np.testing.assert_allclose(got["pose_w_c"], want.pose_w_c, rtol=0, atol=1e-5)
        _assert_close_state(run["state"], port_run["state"])
        assert run["ba_dispatches"] == port_run["ba_dispatches"] >= 1


def test_sharded_global_relax_matches_visual_odometry(sharded_run, port_run):
    want = port_run["report"]
    for run in sharded_run:
        rep = run["relax"]["report"]
        assert (rep["num_edges"], rep["num_loop_edges"], rep["num_chain_edges"], rep["num_appearance_edges"]) == (
            want.num_edges, want.num_loop_edges, want.num_chain_edges, want.num_appearance_edges)
        assert want.kf_ts.size >= 2
        for key in ("kf_ts", "old_T_w_k", "new_T_w_k", "loop_pairs_w"):
            np.testing.assert_allclose(rep[key], getattr(want, key), rtol=0, atol=1e-5, err_msg=key)
        _assert_close_state(run["relax"]["state"], port_run["relaxed"])
        for key in ("mappoints", "keyframe_poses"):
            np.testing.assert_allclose(run["relax"]["snapshot"][key], port_run["snapshot"][key], rtol=0, atol=1e-5)
        assert run["relax"]["snapshot"]["num_keyframes"] == port_run["snapshot"]["num_keyframes"]


def test_sharded_checkpoint_round_trip(sharded_run, frames):
    for run in sharded_run:
        assert run["checkpoint"]["equal"]
        assert run["checkpoint"]["meta"] == {"time_base": frames[0].timestamp}
        assert "holds 1024 map points, the shards 512" in run["checkpoint"]["wrong_capacity"]


def test_sharded_relax_failure_raises_on_every_rank(sharded_run):
    """Rank 0 alone computes a relaxation; when it fails there, synchronous
    or asynchronous, every rank raises instead of waiting for it."""
    assert sharded_run[0]["relax_failure"]["calls"] == [0, 0]
    assert sharded_run[1]["relax_failure"]["calls"] == []
    for mode in ("sync", "async"):
        assert sharded_run[0]["relax_failure"]["raised"][mode] == "FloatingPointError: planted"
        assert sharded_run[1]["relax_failure"]["raised"][mode] == (
            "RuntimeError: the relaxation failed on rank 0: FloatingPointError: planted")


def test_sharded_online_relax(tmp_path):
    """``relax_every_kf=1`` on 2 ranks over 10 frames (``run`` reads its
    records 3 frames late): synchronous, it equals the port's
    ``VisualOdometry.run``; asynchronous, both ranks see the same run."""
    frames = _frames(10)
    runs = _results(torch_dist.spawn(torch_dist.relax_run_worker, 2, tmp_path, TINY,
                                     [(f.rgb, f.depth, f.timestamp) for f in frames]))
    cfg = VOConfig(**dict(TINY, relax_every_kf=1, relax_async=False, relax_loop_gap_s=0.1))
    vo = VisualOdometry(cfg, device="cpu")
    want = vo.run((f.rgb, f.depth, f.timestamp) for f in frames)
    assert vo.num_auto_relaxes >= 2
    for run in runs:
        sync = run["sync"]
        assert sync["relaxes"] == vo.num_auto_relaxes
        for got, w in zip(sync["results"], want, strict=True):
            assert got[:4] == (w.timestamp, w.tracked, w.is_keyframe, w.fsm)
            np.testing.assert_allclose(got[4], w.pose_w_c, rtol=0, atol=1e-5)
        _assert_close_state(sync["state"], {k: v.numpy() for k, v in vars(vo.state).items()})
    a, b = runs[0]["async"], runs[1]["async"]
    assert a["relaxes"] == b["relaxes"] >= 1 and len(a["results"]) == len(frames)
    for x, y in zip(a["results"], b["results"], strict=True):
        assert x[:4] == y[:4] and np.array_equal(x[4], y[4])
    _assert_close_state(a["state"], b["state"], atol=0)


def test_sharded_map_vo_capacity_must_divide(sharded_run):
    for run in sharded_run:
        assert "divide evenly over 2 ranks" in run["divisibility"]


# ---------------------------------------------------------------------------
# MultiStreamVO over ranks
# ---------------------------------------------------------------------------

S = 4


@pytest.fixture(scope="module")
def stream_batches():
    seqs = [
        synthetic.generate_sequence(
            8, scene=synthetic.SyntheticScene(width=128, height=96, fx=100.0, fy=100.0, cx=64.0, cy=48.0,
                                              cell_size=0.12, seed=s),
            step_t=(0.03, 0.004, 0.0), step_r=(0.0, 0.0, 0.006),
        )
        for s in range(S)
    ]
    return [(np.stack([q[i].rgb for q in seqs]), np.stack([q[i].depth for q in seqs]),
             np.asarray([q[i].timestamp for q in seqs]) + 100.0 * np.arange(S)) for i in range(8)]


@pytest.fixture(scope="module")
def multistream_runs(stream_batches, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multistream")
    return _results(torch_dist.spawn(torch_dist.multistream_worker, 2, tmp, TINY, S, stream_batches))


def test_multistream_over_ranks_matches_one_process(multistream_runs, stream_batches):
    vo = MultiStreamVO(VOConfig(**TINY), S, device="cpu")
    outs = [vo.step(*b) for b in stream_batches]
    vo.finish()
    want = np.stack([o.packed.numpy() for o in outs])
    assert vo.ba_dispatches >= 2
    assert [r["streams"] for r in multistream_runs] == [[0, 1], [2, 3]]
    for run in multistream_runs:
        got = run["records"]
        assert got.shape == want.shape
        np.testing.assert_array_equal(got[..., FLAGS], want[..., FLAGS])
        for t0 in (0, 7):  # T_c_w, T_w_c: translation, then the quaternion up to its sign
            np.testing.assert_allclose(got[..., t0 + 4 : t0 + 7], want[..., t0 + 4 : t0 + 7], rtol=0, atol=1e-5)
            q, qw = got[..., t0 : t0 + 4], want[..., t0 : t0 + 4]
            assert np.minimum(np.abs(q - qw).max(-1), np.abs(q + qw).max(-1)).max() < 1e-5
        assert run["ba_dispatches"] == vo.ba_dispatches
        assert run["metrics"] == vo.aggregate_metrics(outs[-1])
    assert (want[..., 14] > 0.5).all()


def test_multistream_stream_count_must_divide(multistream_runs):
    for run in multistream_runs:
        assert "divide evenly over 2 ranks" in run["divisibility"]
