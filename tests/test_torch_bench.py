"""The port's bench program (``rgbd_visualodometry_tpu_torch.bench``)
against the root ``bench.py``: the same configurations field for field, the
same constants, byte-equal frames, the same phase summaries and result line
on the same windows, the same divisors; its phases on the CPU at 160x120
with the windows shrunk; and its budget guards, signal handlers and
out-of-memory fallback, driven in subprocesses with the phases stubbed.

The card runs the full protocol (``python3 -m
rgbd_visualodometry_tpu_torch.bench``) and ``chip_smoke.py``'s short
bench phase."""

import dataclasses
import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest

from rgbd_visualodometry_tpu_torch import bench as tbench
from rgbd_visualodometry_tpu_torch.config import VOConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_KEYS = ["metric", "value", "unit", "vs_baseline", "vs_strongest_twin", "best", "median", "passes"]
TINY = dict(image_width=160, image_height=120, camera_fx=129.3, camera_fy=129.1, camera_cx=79.6, camera_cy=63.8,
            number_of_features=150, level_pyramid=3)


@pytest.fixture(scope="module")
def jbench():
    """The root ``bench.py`` (it imports the JAX package only inside its
    functions)."""
    sys.path.insert(0, REPO)
    try:
        import bench
    finally:
        sys.path.remove(REPO)
    return bench


@pytest.fixture
def shrunk(monkeypatch):
    """The protocol's frame counts cut to 2 warm-up frames and 3 windows of
    2 frames or steps (the phases read them at call time)."""
    monkeypatch.setattr(tbench, "WARMUP_FRAMES", 2)
    monkeypatch.setattr(tbench, "MEASURE_FRAMES", 2)
    monkeypatch.setattr(tbench, "MS_MEASURE_FRAMES", 6)


@pytest.mark.parametrize("base", [{}, {"ba_min_frame_gap": 20}, {"ba_min_frame_gap": 3, "image_width": 320}])
@pytest.mark.parametrize("kind", ["single", "tracking", "full_vo"])
def test_configs_equal_bench_py(jbench, base, kind):
    from rgbd_visualodometry_tpu.config import VOConfig as JaxVOConfig

    if kind == "single":
        got, want = tbench.single_stream_cfg(VOConfig(**base)), jbench.single_stream_cfg(JaxVOConfig(**base))
    else:
        full = kind == "full_vo"
        got, want = (tbench.multistream_cfg(VOConfig(**base), full_vo=full),
                     jbench.multistream_cfg(JaxVOConfig(**base), full_vo=full))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if kind == "full_vo":
        assert got.ba_min_frame_gap == max(base.get("ba_min_frame_gap", 0), 14)


def test_constants_equal_bench_py(jbench):
    names = ("WARMUP_FRAMES", "MEASURE_FRAMES", "MS_MEASURE_FRAMES", "TRACKING_STREAMS", "FULL_VO_STREAMS",
             "FULL_VO_FALLBACK", "PASSES_HEADLINE", "PASSES_SECONDARY")
    assert {n: getattr(tbench, n) for n in names} == {n: getattr(jbench, n) for n in names}
    assert tbench.BENCH_BUDGET_S == jbench.BUDGET_S == 1500.0
    assert (tbench.SINGLE_MIN_BUDGET_S, tbench.TRACKING_MIN_BUDGET_S) == (240.0, 180.0)


@pytest.mark.parametrize("size,seed", [((640, 480), 0), ((160, 120), 5)])
def test_make_frames_byte_equal(jbench, size, seed):
    from rgbd_visualodometry_tpu.config import VOConfig as JaxVOConfig

    w, h = size
    kw = dict(TINY, image_width=w, image_height=h) if w == 160 else {}
    got = tbench._make_frames(VOConfig(**kw), 3, seed=seed)
    want = jbench._make_frames(JaxVOConfig(**kw), 3, seed=seed)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert a.timestamp == b.timestamp and a.rgb.shape == (h, w, 3)
        for x, y in ((a.rgb, b.rgb), (a.depth, b.depth), (a.T_c_w, b.T_c_w)):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def test_render_streams_equal_make_frames(tmp_path):
    cfg = VOConfig(**TINY)
    got = tbench.render_streams(cfg, 3, 5, str(tmp_path))
    assert got["rgb"].shape == (5, 3, 120, 160, 3) and got["depth"].shape == (5, 3, 120, 160)
    for s in range(3):
        for i, f in enumerate(tbench._make_frames(cfg, 5, seed=s)):
            np.testing.assert_array_equal(got["rgb"][i, s], f.rgb)
            np.testing.assert_array_equal(got["depth"][i, s], f.depth)
            np.testing.assert_array_equal(got["T_c_w"][i, s], f.T_c_w)
            assert got["timestamp"][i, s] == f.timestamp


def test_render_streams_splits_one_stream(tmp_path, monkeypatch):
    """One stream of many frames is split over the workers in chunks."""
    monkeypatch.setattr(tbench, "_MIN_CHUNK_FRAMES", 2)
    monkeypatch.setattr(os, "cpu_count", lambda: 3)
    cfg = VOConfig(**TINY)
    got = tbench.render_streams(cfg, 1, 7, str(tmp_path))
    for i, f in enumerate(tbench._make_frames(cfg, 7)):
        np.testing.assert_array_equal(got["rgb"][i, 0], f.rgb)
        np.testing.assert_array_equal(got["depth"][i, 0], f.depth)


def test_divisors_equal_bench_py(jbench):
    assert tbench.load_baseline() == {"full_vo": jbench.BASELINE_FPS_FULL_VO,
                                      "frontend_only": jbench.BASELINE_FPS_FRONTEND}
    assert tbench.load_baseline() == {"full_vo": 3.45, "frontend_only": 7.66}


def test_summary_and_result_line_equal_bench_py(jbench, tmp_path, monkeypatch):
    monkeypatch.setattr(jbench, "WINDOW_LOG", str(tmp_path / "jax.jsonl"))  # not the repository's log
    rng = np.random.default_rng(3)
    phases = [("72-stream batched full VO", rng.uniform(50, 200, (5, 3)).tolist(), "full_vo"),
              ("single-stream full VO", rng.uniform(1, 4, (5, 3)).tolist(), "full_vo"),
              ("32-stream batched tracking", rng.uniform(100, 300, (1, 3)).tolist(), "frontend_only")]
    divisors = tbench.load_baseline()
    jrep, trep = jbench._Reporter(), tbench._Reporter(divisors["frontend_only"])
    jout, tout = io.StringIO(), io.StringIO()
    for label, windows, kind in phases:
        want = jbench._summarize(label, windows)
        got = tbench._summarize(label, windows, str(tmp_path / "torch.jsonl"))
        assert got == want
        with redirect_stdout(jout):
            jrep.add(want, divisors[kind], label)
        with redirect_stdout(tout):
            trep.add(got, divisors[kind], label)
    assert tout.getvalue() == jout.getvalue()
    lines = tout.getvalue().splitlines()
    assert len(lines) == 3 and list(json.loads(lines[-1])) == JAX_KEYS
    logged = [json.loads(x) for x in open(tmp_path / "torch.jsonl")]
    want_log = [json.loads(x) for x in open(tmp_path / "jax.jsonl")]
    assert [r["windows_fps"] for r in logged] == [r["windows_fps"] for r in want_log]
    assert [r["phase"] for r in logged] == [p[0] for p in phases]
    assert all("card" in r for r in logged)


def test_import_is_jax_free():
    code = (
        "import os, sys\n"
        "import chip_smoke\n"
        "from rgbd_visualodometry_tpu_torch import bench\n"
        "chip_smoke.full_vo_config(); chip_smoke.multistream_config(); chip_smoke.slice_config()\n"
        "ref = os.path.join(sys.argv[1], 'rgbd_visualodometry_tpu') + os.sep\n"
        "loaded = sorted(n for n, m in list(sys.modules.items())\n"
        "                if n == 'bench' or os.path.abspath(getattr(m, '__file__', None) or '').startswith(ref))\n"
        "print('ok', loaded, sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code, REPO], cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "ok [] []", proc.stdout[-3000:]


def test_entry_points_need_the_card(shrunk):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbench.bench_single(VOConfig(**TINY), repeats=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbench.bench_multistream(VOConfig(**TINY), 2, repeats=1)


def _windows_ok(got, passes):
    assert got["passes"] == passes and len(got["windows"]) == passes
    assert all(len(p) == 3 and all(np.isfinite(w) and w > 0 for w in p) for p in got["windows"])
    assert got["best"] == max(max(p) for p in got["windows"])
    assert got["median"] == float(np.median([max(p) for p in got["windows"]]))


def test_bench_single_on_cpu(shrunk, tmp_path, monkeypatch):
    """Single-stream full VO at 160x120: every frame tracked (the phase
    raises otherwise), a fresh VO per pass, BA in the drain."""
    import rgbd_visualodometry_tpu_torch.bench as b

    made = []
    real = b.VisualOdometry

    def counted(*a, **k):
        made.append(real(*a, **k))
        return made[-1]

    monkeypatch.setattr(b, "VisualOdometry", counted)
    log = str(tmp_path / "w.jsonl")
    got = tbench.bench_single(VOConfig(**TINY), repeats=2, device="cpu", window_log=log)
    _windows_ok(got, 2)
    assert len(made) == 2 and all(len(v.results) == 2 + 3 * 2 for v in made)
    assert all(all(r.tracked for r in v.results) for v in made)
    assert made[0].cfg.enable_local_optimization and sum(v.ba_dispatches for v in made) >= 1
    (rec,) = [json.loads(x) for x in open(log)]
    assert rec["phase"] == "single-stream full VO" and len(rec["windows_fps"]) == 2 and "card" in rec


@pytest.mark.parametrize("full_vo", [False, True])
def test_bench_multistream_on_cpu(shrunk, tmp_path, full_vo):
    log = str(tmp_path / "w.jsonl")
    got = tbench.bench_multistream(VOConfig(**TINY), 2, full_vo=full_vo, repeats=1, device="cpu", window_log=log)
    _windows_ok(got, 1)
    (rec,) = [json.loads(x) for x in open(log)]
    assert rec["phase"] == f"2-stream batched {'full VO' if full_vo else 'tracking'}"


def _run_main(tmp_path, stubs: str, budget: float = 1500.0):
    """``bench.main`` on the CPU in a subprocess, its phases replaced by
    ``stubs`` (Python defining ``bench_multistream`` and ``bench_single``)."""
    script = tmp_path / "drive.py"
    script.write_text(
        "import os, signal, sys, time\n"
        "import torch\n"
        "from rgbd_visualodometry_tpu_torch import bench\n"
        "def summary(median, passes):\n"
        "    return {'median': median, 'best': median + 1.5, 'passes': passes, 'windows': [[median]] * passes}\n"
        + stubs +
        "bench.bench_multistream, bench.bench_single = bench_multistream, bench_single\n"
        "sys.exit(bench.main(['--window-log', sys.argv[1]], device='cpu'))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO, BENCH_BUDGET_S=str(budget))
    return subprocess.run([sys.executable, str(script), str(tmp_path / "w.jsonl")], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)


def _want_line(jbench, median, passes, label, divisor):
    out = io.StringIO()
    with redirect_stdout(out):
        jbench._Reporter().add({"median": median, "best": median + 1.5, "passes": passes}, divisor, label)
    return out.getvalue().strip()


def test_sigalrm_mid_phase_prints_best_so_far(jbench, tmp_path):
    proc = _run_main(tmp_path, (
        "def bench_multistream(cfg, n, full_vo=False, repeats=2, device='cuda', window_log=None):\n"
        "    assert full_vo and n == 72 and repeats == 5\n"
        "    return summary(250.0, repeats)\n"
        "def bench_single(cfg, repeats=5, device='cuda', window_log=None):\n"
        "    os.kill(os.getpid(), signal.SIGALRM)\n"
        "    time.sleep(60)\n"
    ))
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = _want_line(jbench, 250.0, 5, "72-stream batched full VO", jbench.BASELINE_FPS_FULL_VO)
    assert proc.stdout.strip().splitlines() == [want, want]
    assert "signal 14: emitting best-so-far JSON" in proc.stderr


def test_oom_falls_back_to_64_streams(jbench, tmp_path):
    proc = _run_main(tmp_path, (
        "def bench_multistream(cfg, n, full_vo=False, repeats=2, device='cuda', window_log=None):\n"
        "    if n == 72:\n"
        "        raise torch.OutOfMemoryError('out of memory')\n"
        "    return summary({64: 200.0, 32: 150.0}[n], repeats)\n"
        "def bench_single(cfg, repeats=5, device='cuda', window_log=None):\n"
        "    return summary(2.0, repeats)\n"
    ))
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 4 and lines[0] == lines[1] == lines[2] == lines[3]
    assert lines[-1] == _want_line(jbench, 200.0, 2, "64-stream batched full VO", jbench.BASELINE_FPS_FULL_VO)
    assert "ran out of device memory" in proc.stderr


def test_other_error_is_reported_without_fallback(jbench, tmp_path):
    proc = _run_main(tmp_path, (
        "def bench_multistream(cfg, n, full_vo=False, repeats=2, device='cuda', window_log=None):\n"
        "    assert n != 64, 'the 64-stream phase ran'\n"
        "    if n == 72:\n"
        "        raise ValueError('not a memory error')\n"
        "    return summary(150.0, repeats)\n"
        "def bench_single(cfg, repeats=5, device='cuda', window_log=None):\n"
        "    return summary(3.0, repeats)\n"
    ))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "ValueError: not a memory error" in proc.stderr and "64-stream" not in proc.stderr
    want = _want_line(jbench, 150.0, 1, "32-stream batched tracking", jbench.BASELINE_FPS_FRONTEND)
    assert proc.stdout.strip().splitlines()[-1] == want


def test_budget_skips_later_phases(jbench, tmp_path):
    proc = _run_main(tmp_path, (
        "def bench_multistream(cfg, n, full_vo=False, repeats=2, device='cuda', window_log=None):\n"
        "    assert n == 72, 'a skipped phase ran'\n"
        "    return summary(250.0, repeats)\n"
        "def bench_single(cfg, repeats=5, device='cuda', window_log=None):\n"
        "    raise AssertionError('a skipped phase ran')\n"
    ), budget=100.0)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "skipping single-stream phase" in proc.stderr and "skipping tracking phase" in proc.stderr
    want = _want_line(jbench, 250.0, 5, "72-stream batched full VO", jbench.BASELINE_FPS_FULL_VO)
    assert proc.stdout.strip().splitlines() == [want, want]  # after the phase, and at the end
