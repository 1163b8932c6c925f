"""The live viewer of the port against the JAX package's: the per-frame
payload of ``frontend.track_step``, ``viz.MapViewer`` and the viewer
wiring of ``VisualOdometry`` (``enable_viewer``).

- Payload: the JAX package tracks 6 frames with the viewer on; from each of
  its states the port takes the same step (on the reference's pyramid
  levels, so ORB is identical) and its ``StepOutput.viewer`` - x, y and the
  matched flag per keypoint - equals the JAX one exactly.
- ``draw_keypoints`` exact, ``export_html`` byte-equal, an overlay PNG that
  decodes to the JAX package's overlay (the port writes it with
  ``io/png.py``, the JAX package with matplotlib).
- An ``enable_viewer`` run of each package writes the same set of files
  (overlays, map renders every ``viewer_map_every`` frames, ``map.html``),
  and the port's overlays decode to ``draw_keypoints`` of its payloads.
"""

import os

import cv2
import jax
import numpy as np
import pytest

from torch_parity import inject_reference_pyramid, small_cfgs, small_scene, x64_off  # noqa: F401
from rgbd_visualodometry_tpu.pipeline.system import VisualOdometry as JaxVO
from rgbd_visualodometry_tpu.viz import MapViewer as JaxViewer
from rgbd_visualodometry_tpu_torch import VisualOdometry, mapstate
from rgbd_visualodometry_tpu_torch.camera import Camera
from rgbd_visualodometry_tpu_torch.io import png, synthetic
from rgbd_visualodometry_tpu_torch.pipeline import frontend
from rgbd_visualodometry_tpu_torch.viz import MapViewer

pytestmark = pytest.mark.usefixtures("x64_off", "inject_reference_pyramid")
N_FRAMES = 6
VIEW = dict(enable_viewer=True, viewer_map_every=3)


@pytest.fixture(scope="module")
def seq():
    return synthetic.generate_sequence(N_FRAMES, scene=small_scene())


@pytest.fixture(scope="module")
def jax_view(x64_off, seq, tmp_path_factory):
    """The JAX package's viewer run: the state before each step, each
    step's payload, and its output directory."""
    out_dir = str(tmp_path_factory.mktemp("jax_view"))
    _, jcfg = small_cfgs(viewer_dir=out_dir, **VIEW)
    vo = JaxVO(jcfg)
    states, payloads = [], []
    step = vo._step

    def spy(state, frame):
        states.append({k: np.asarray(v) for k, v in jax.device_get(state)._asdict().items()})
        new, out = step(state, frame)
        payloads.append(np.asarray(out.viewer))
        return new, out

    vo._step = spy
    results = vo.run((f.rgb, f.depth, f.timestamp) for f in seq)
    assert all(r.tracked for r in results)
    return states, payloads, out_dir


def test_viewer_payload_matches(jax_view, seq):
    states, payloads, _ = jax_view
    cfg, _ = small_cfgs(**VIEW)
    cam = Camera.from_config(cfg)
    for i, f in enumerate(seq):
        state = mapstate.state_from_numpy(states[i], device="cpu")
        fin = frontend.frame_input(f.rgb, f.depth, f.timestamp - seq[0].timestamp, "cpu")
        _, out = frontend.track_step(cfg, cam, state, fin)
        got = out.viewer.numpy()
        assert got.dtype == payloads[i].dtype == np.float32 and got.shape == (cfg.number_of_features, 3)
        np.testing.assert_array_equal(got, payloads[i], err_msg=f"frame {i}")
        flags = got[:, 2] > 0.5
        assert flags.sum() > (100 if i else -1) and flags.sum() <= int(out.num_matches)
    _, out = frontend.track_step(small_cfgs()[0], cam, state, fin)
    assert out.viewer is None  # off unless enable_viewer


def test_draw_keypoints_exact():
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (60, 80, 3), dtype=np.uint8)
    xy = np.stack([rng.uniform(-1.4, 80.4, 40), rng.uniform(-1.4, 60.4, 40)], axis=1)  # boxes clipped at every edge
    xy = np.concatenate([xy, [[0, 0], [79.6, 59.4], [-1.4, 30], [40.5, 60.2]]]).astype(np.float32)
    valid = rng.random(len(xy)) > 0.3
    for v in (valid, None):
        for radius in (1, 2, 3):
            got = MapViewer.draw_keypoints(rgb, xy, v, radius=radius)
            want = JaxViewer.draw_keypoints(rgb, xy, v, radius=radius)
            assert (got != rgb).any()
            np.testing.assert_array_equal(got, want)


def _snapshot(rng, n_pts, n_kf):
    q = rng.normal(size=(n_kf, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return dict(
        mappoints=rng.normal(size=(n_pts, 3)).astype(np.float32),
        keyframe_poses=np.concatenate([q, rng.normal(size=(n_kf, 3))], axis=1).astype(np.float32),
        num_keyframes=n_kf,
    )


@pytest.mark.parametrize("case", ["full", "empty", "subsampled"])
def test_export_html_byte_equal(tmp_path, case):
    rng = np.random.default_rng(1)
    snap = _snapshot(rng, {"full": 500, "empty": 0, "subsampled": 60001}[case], 0 if case == "empty" else 7)
    kw = {} if case == "empty" else dict(trajectory=rng.normal(size=(20, 3)), edges=rng.normal(size=(3, 2, 3)))
    got = MapViewer(str(tmp_path / "port")).export_html(snap, **kw)
    want = JaxViewer(str(tmp_path / "jax")).export_html(snap, **kw)
    assert os.path.basename(got) == os.path.basename(want) == "map.html"
    assert open(got, "rb").read() == open(want, "rb").read()


def test_render_overlay_decodes_to_the_jax_overlay(tmp_path):
    rng = np.random.default_rng(2)
    rgb = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
    xy, valid = np.stack([rng.uniform(0, 63, 30), rng.uniform(0, 47, 30)], axis=1), rng.random(30) > 0.5
    got = MapViewer(str(tmp_path / "port")).render_overlay(rgb, xy, valid)
    want = JaxViewer(str(tmp_path / "jax")).render_overlay(rgb, xy, valid)
    assert os.path.basename(got) == os.path.basename(want) == "frame_00000.png"
    img = png.read(got)
    np.testing.assert_array_equal(img, MapViewer.draw_keypoints(rgb, xy, valid))
    np.testing.assert_array_equal(img, cv2.imread(want, cv2.IMREAD_COLOR)[..., ::-1])


def test_viewer_run_writes_the_same_files(jax_view, seq, tmp_path):
    _, _, jax_dir = jax_view
    cfg, _ = small_cfgs(viewer_dir=str(tmp_path), **VIEW)
    vo = VisualOdometry(cfg, device="cpu")
    payloads = []
    step = frontend.track_step

    def spy(*a):
        state, out = step(*a)
        payloads.append(out.viewer.numpy())
        return state, out

    frontend.track_step = spy
    try:
        results = vo.run((f.rgb, f.depth, f.timestamp) for f in seq)
    finally:
        frontend.track_step = step
    assert all(r.tracked for r in results)
    files = sorted(os.listdir(tmp_path))
    assert files == sorted(os.listdir(jax_dir))
    assert files == [f"frame_{i:05d}.png" for i in range(N_FRAMES)] + ["map.html", "map_00000.png", "map_00003.png"]
    for i, (f, v) in enumerate(zip(seq, payloads)):
        want = MapViewer.draw_keypoints(f.rgb, v[:, :2], v[:, 2] > 0.5)
        np.testing.assert_array_equal(png.read(str(tmp_path / f"frame_{i:05d}.png")), want)
    html = (tmp_path / "map.html").read_text()
    assert f"{int((vo.state.mp_valid & ~vo.state.mp_outlier).sum())} points" in html


def test_staged_frames_draw_the_same_overlays(seq, tmp_path):
    """A staged ``FrameInput`` overlays its device copy of the image."""
    out = {}
    for name in ("numpy", "staged"):
        cfg, _ = small_cfgs(viewer_dir=str(tmp_path / name), enable_viewer=True, viewer_map_every=100)
        vo = VisualOdometry(cfg, device="cpu")
        for f in seq[:3]:
            if name == "staged":
                vo.process_async(vo.put_frame(f.rgb, f.depth, f.timestamp), timestamp=f.timestamp)
            else:
                vo.process_async(f.rgb, f.depth, f.timestamp)
        vo.drain(0)
        out[name] = [(tmp_path / name / f"frame_{i:05d}.png").read_bytes() for i in range(3)]
    assert out["numpy"] == out["staged"]
    assert VisualOdometry(small_cfgs()[0], device="cpu").export_map_html() is None
