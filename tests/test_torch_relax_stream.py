"""The async loop-closure relax computes what the synchronous one does, and
the evaltools shell scripts have port twins.

- One asynchronous run of the port at 320x240 (a module fixture): the
  first 24 frames of the closed circuit of ``tests/test_torch_relax_online.py``,
  a relaxation every 2 keyframes on the worker thread, with a 0.25 s loop
  gap so that the short run finds loop edges; each frame waits for the
  relaxation in flight (as the gated run of ``test_torch_relax_async.py``),
  so where relaxations land does not depend on thread timing.
  ``compute_relaxation`` is spied: each call on the worker keeps a clone of
  the snapshot it was given.  Held: every relaxation the run applied equals
  ``compute_relaxation`` called again on this thread on its snapshot, to
  the bit (``delta_w``, ``snap_valid``, ``snap_ts``, ``ref_delta_w`` and
  every report field); and the JAX package's ``compute_relaxation`` on the
  last acting relaxation's snapshot (the largest graph) gives the same
  report within the tolerances of
  ``tests/test_torch_loopclosure.py::test_relax_map_matches``.  On a card
  the worker runs on a CUDA stream of its own; ``chip_smoke.py`` holds the
  same equality there.
- ``scripts/run_{associate,ate,rpe}_torch.sh`` against the JAX package's
  ``scripts/run_{associate,ate,rpe}.sh`` on one dataset listing and one
  trajectory pair written by ``io.trajectory``: byte-equal stdout (and
  ``associate.txt``), the port's scripts with jax unimportable (a ``jax``
  package first on ``PYTHONPATH`` that raises on import; the JAX scripts
  fail under the same block, which shows that it holds).  Two runs at a
  time at most, each with one interpreter thread.
"""

import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from torch_parity import faulted_depth, loop_frames, relax_cfgs, x64_off  # noqa: F401
from rgbd_visualodometry_tpu_torch import VisualOdometry, mapstate
from rgbd_visualodometry_tpu_torch.io.trajectory import TrajectoryWriter
from rgbd_visualodometry_tpu_torch.ops import posegraph
from rgbd_visualodometry_tpu_torch.pipeline import globalopt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_CIRCUIT, N_FRAMES = 64, 24
T0 = 1305031102.175304  # a TUM epoch stamp
TENSORS = ("delta_w", "snap_valid", "snap_ts", "ref_delta_w")


@pytest.fixture(scope="module")
def async_run():
    """``(cfgs, [(snapshot, kwargs, relaxation applied)], [(poses, graph,
    kwargs) of each solve]`` of one gated asynchronous run."""
    frames = loop_frames(N_CIRCUIT, step=0.03)[:N_FRAMES]
    cfg, jcfg = relax_cfgs(enable_local_optimization=False, relax_every_kf=2, relax_loop_gap_s=0.25, relax_async=True)
    vo = VisualOdometry(cfg, device="cpu")
    real, kept, applied = globalopt.compute_relaxation, [], []
    real_solve, solves = posegraph.optimize_pose_graph, []

    def spied(state, c, **kw):
        if threading.current_thread().name != "vo-relax":
            return real(state, c, **kw)
        snap = pytree.tree_map(torch.clone, state)
        rlx = real(state, c, **kw)
        kept.append((snap, kw, rlx))
        return rlx

    def spied_solve(poses, graph, **kw):
        if threading.current_thread().name == "vo-relax":
            solves.append((poses.clone(), posegraph.PoseGraph(*(x.clone() for x in graph)), kw))
        return real_solve(poses, graph, **kw)

    finish = vo._finish_async_relax

    def spied_finish(wait=False):
        rlx = finish(wait)
        if rlx is not None:
            applied.append(rlx)
        return rlx

    def stream():
        for i, f in enumerate(frames):
            if vo._relax_thread is not None:
                vo._relax_thread.join()
            yield f.rgb, faulted_depth(i, N_CIRCUIT, f.depth), f.timestamp

    vo._finish_async_relax = spied_finish
    globalopt.compute_relaxation, posegraph.optimize_pose_graph = spied, spied_solve
    try:
        results = vo.run(stream())
    finally:
        globalopt.compute_relaxation, posegraph.optimize_pose_graph = real, real_solve
    assert len(results) == N_FRAMES and all(r.tracked for r in results)
    assert [id(r) for *_, r in kept] == [id(r) for r in applied]
    assert sum(bool(r.report.kf_ts.size) for r in applied) >= 1, "no relaxation from the worker acted"
    assert solves, "no relaxation on the worker solved"
    return (cfg, jcfg), kept, solves


def test_async_relaxation_equals_compute_relaxation(async_run):
    (cfg, _), kept, _ = async_run
    for snap, kw, got in kept:
        want = globalopt.compute_relaxation(snap, cfg, **kw)
        for f in TENSORS:
            assert torch.equal(getattr(got, f), getattr(want, f)), f
        for f, x in vars(got.report).items():
            y = getattr(want.report, f)
            if isinstance(x, np.ndarray):
                assert x.dtype == y.dtype and np.array_equal(x, y), f
            else:
                assert x == y, f


def test_async_relaxation_matches_the_jax_package(async_run, x64_off):
    import jax.numpy as jnp

    from rgbd_visualodometry_tpu import mapstate as jms
    from rgbd_visualodometry_tpu.pipeline import globalopt as jgo

    (_, jcfg), kept, _ = async_run
    # the last acting relaxation: the largest graph (one JAX compile)
    snap, kw, rlx = [k for k in kept if k[2].report.kf_ts.size][-1]
    jstate = jms.VOState(**{k: jnp.asarray(v) for k, v in mapstate.state_to_numpy(snap).items()})
    trep, jrep = rlx.report, jgo.compute_relaxation(jstate, jcfg, **kw).report
    for f in ("num_edges", "num_loop_edges", "num_chain_edges", "num_appearance_edges"):
        assert getattr(trep, f) == getattr(jrep, f), f
    np.testing.assert_array_equal(trep.kf_ts, jrep.kf_ts)
    np.testing.assert_allclose(trep.old_T_w_k, jrep.old_T_w_k, atol=1e-6)
    np.testing.assert_allclose(trep.new_T_w_k, jrep.new_T_w_k, atol=1e-4)
    np.testing.assert_allclose(trep.loop_pairs_w, jrep.loop_pairs_w, atol=1e-4)
    assert abs(trep.max_correction_m - jrep.max_correction_m) < 1e-4


def test_padded_solve_matches_the_unpadded_and_the_jax_package(async_run, x64_off):
    """The last solve of the run (the largest graph) padded to its edge
    bucket, as ``compute_relaxation`` pads it on CUDA and the JAX package
    everywhere: within 1e-4 (``tests/test_torch_posegraph.py``'s solver
    tolerance) of the unpadded solve and of the JAX package's
    ``optimize_pose_graph`` on the padded graph.  Here on the CPU the rows
    in a vectorised loop's scalar tail round otherwise, so the two port
    solves agree to float32 rounding; on the card they agree to the bit
    (``test_torch_relax_async.py::test_graphed_solve_equals_eager_gpu``,
    ``chip_smoke.py``)."""
    import jax.numpy as jnp

    from rgbd_visualodometry_tpu.ops import posegraph as jpg

    *_, solves = async_run
    poses, graph, kw = solves[-1]
    padded = posegraph.pad_graph(graph, posegraph.edge_bucket(int(graph.edge_i.shape[0])))
    assert padded.edge_i.shape[0] > graph.edge_i.shape[0]
    want = posegraph.optimize_pose_graph(poses, graph, **kw).numpy()
    got = posegraph.optimize_pose_graph(poses, padded, **kw).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    jkw = dict(kw, fixed=jnp.asarray(kw["fixed"].numpy()))
    jgot = jpg.optimize_pose_graph(jnp.asarray(poses.numpy()), jpg.PoseGraph(*(jnp.asarray(x.numpy()) for x in padded)),
                                   **jkw)
    np.testing.assert_allclose(np.asarray(jgot), want, atol=1e-4)


# ---- the evaltools shell scripts ------------------------------------------

SCRIPTS = ("associate", "ate", "rpe")


def _write_inputs(root):
    """A TUM dataset listing (``dataset/rgb.txt``, ``dataset/depth.txt``)
    and a trajectory pair (``groundtruth.txt``, ``estimate.txt``) written by
    ``io.trajectory``."""
    rng = np.random.default_rng(3)
    n = 90
    ts = T0 + np.arange(n) / 30.0
    q = np.cumsum(rng.normal(0, 0.02, (n, 4)), axis=0) + [1.0, 0, 0, 0]
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    gt = np.concatenate([q, np.cumsum(rng.normal(0, 0.01, (n, 3)), axis=0)], axis=1)
    est = gt + np.concatenate([np.zeros((n, 4)), rng.normal(0, 0.003, (n, 3))], axis=1)
    for name, poses, stamps in (("groundtruth.txt", gt, ts), ("estimate.txt", est, ts + 0.004)):
        with TrajectoryWriter(str(root / name)) as w:
            for t, p in zip(stamps, poses):
                w.write(float(t), p.astype(np.float32))
    data = root / "dataset"
    data.mkdir()
    for name, stamps in (("rgb", ts), ("depth", ts + rng.uniform(-0.01, 0.01, n))):
        lines = [f"{t:.6f} {name}/{t:.6f}.png" for t in stamps]
        (data / f"{name}.txt").write_text("# timestamp filename\n" + "\n".join(lines) + "\n")


@pytest.fixture(scope="module")
def script_runs(tmp_path_factory):
    """Each script run on the inputs of :func:`_write_inputs`: the JAX
    package's (``"jax"``) and the port's with jax blocked (``"torch"``)
    side by side, then the JAX package's with jax blocked (``"jax
    blocked"``), each in a directory of its own with relative paths (so
    that what they print names the same paths) and one interpreter thread,
    two processes at a time at most, beside the suite's other workers.
    ``{(script, side): (exit code, stdout, stderr, associate.txt bytes or
    None)}``."""
    block = tmp_path_factory.mktemp("block")
    (block / "jax").mkdir()
    (block / "jax" / "__init__.py").write_text('raise ImportError("jax is blocked here")\n')
    runs = {}
    for script in SCRIPTS:
        args = ["dataset"] if script == "associate" else ["groundtruth.txt", "estimate.txt"]
        for sides in (("jax", "torch"), ("jax blocked",)):
            procs = {}
            for side in sides:
                cwd = tmp_path_factory.mktemp(f"{script}_{side.replace(' ', '_')}")
                _write_inputs(cwd)
                path = [REPO] if side == "jax" else [str(block), REPO]
                env = dict(os.environ, PYTHONPATH=os.pathsep.join(path), OMP_NUM_THREADS="1",
                           PATH=os.path.dirname(sys.executable) + os.pathsep + os.environ.get("PATH", ""))
                name = f"run_{script}_torch.sh" if side == "torch" else f"run_{script}.sh"
                procs[side] = cwd, subprocess.Popen(
                    ["sh", os.path.join(REPO, "scripts", name), *args], cwd=cwd, env=env,
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for side, (cwd, p) in procs.items():
                out, err = p.communicate(timeout=120)
                assoc = cwd / "dataset" / "associate.txt"
                runs[script, side] = p.returncode, out, err, assoc.read_bytes() if assoc.exists() else None
    return runs


@pytest.mark.parametrize("script", SCRIPTS)
def test_torch_script_prints_what_the_jax_script_prints(script, script_runs):
    rc, out, err, assoc = script_runs[script, "jax"]
    assert rc == 0, err
    trc, tout, terr, tassoc = script_runs[script, "torch"]
    assert trc == 0, terr
    assert tout == out and out.strip()
    assert tassoc == assoc
    if script == "associate":
        assert assoc.count(b"\n") > 10


@pytest.mark.parametrize("script", SCRIPTS)
def test_jax_script_fails_where_jax_does_not_import(script, script_runs):
    rc, _, err, _ = script_runs[script, "jax blocked"]
    assert "jax is blocked here" in err
    if script != "associate":  # run_associate.sh ends with an echo and returns its status
        assert rc != 0
