"""The port's TUM dataset input against the JAX package's: ``io/tum.py``,
its PNG codec ``io/png.py`` and the native loader ``native/``.

``io/tum.py`` and ``native/`` are copies, so the port loads no file of the
JAX package; the one difference is the decoder without the native loader:
the port's ``io/png.py`` (numpy + zlib) where the JAX package calls
``cv2.imread``.  Every comparison is exact: file lists, associations,
records, decoded arrays.  PNGs come from ``cv2.imwrite`` (libpng's adaptive
row filters) and from the port's writer, at small sizes.
"""

import os
import struct
import zlib

import cv2
import numpy as np
import pytest

from rgbd_visualodometry_tpu import native as jnative
from rgbd_visualodometry_tpu.io import tum as jtum
from rgbd_visualodometry_tpu_torch import native as tnative
from rgbd_visualodometry_tpu_torch.io import png
from rgbd_visualodometry_tpu_torch.io import tum as ttum

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def native_libs(tmp_path_factory):
    """Both packages' native libraries (skip without g++/libpng).  The JAX
    package's is built into a directory of this test's own: it writes its
    library in place, and other test files build it at the same time."""
    prev = os.environ.get("RGBD_VO_NATIVE_CACHE")
    os.environ["RGBD_VO_NATIVE_CACHE"] = str(tmp_path_factory.mktemp("jax_native"))
    try:
        ok = tnative.available() and jnative.available()
    finally:
        if prev is None:
            del os.environ["RGBD_VO_NATIVE_CACHE"]
        else:
            os.environ["RGBD_VO_NATIVE_CACHE"] = prev
    if not ok:
        pytest.skip(f"no native toolchain: {tnative.build_error()}")


def _images(seed: int = 0):
    rng = np.random.default_rng(seed)
    smooth = np.cumsum(rng.integers(0, 3, (48, 64, 3)), axis=1).astype(np.uint8)  # filters other than None pay off
    return {
        "rgb": rng.integers(0, 256, (48, 64, 3), dtype=np.uint8),
        "rgb smooth": smooth,
        "rgba": rng.integers(0, 256, (33, 17, 4), dtype=np.uint8),
        "gray": rng.integers(0, 256, (21, 40), dtype=np.uint8),
        "gray smooth": smooth[..., 0].copy(),
        "depth": rng.integers(0, 40000, (48, 64), dtype=np.uint16),
        "depth smooth": np.cumsum(rng.integers(0, 40, (30, 50)), axis=0).astype(np.uint16),
        "1x1": rng.integers(0, 256, (1, 1, 3), dtype=np.uint8),
    }


def _cv2_write(path, img, level=3):
    if img.ndim == 3:
        img = img[..., [2, 1, 0, 3][: img.shape[2]]]  # cv2 writes BGR(A)
    assert cv2.imwrite(str(path), img, [cv2.IMWRITE_PNG_COMPRESSION, level])


def _cv2_read(path, flag=cv2.IMREAD_UNCHANGED):
    img = cv2.imread(str(path), flag)
    if img.ndim == 3:
        img = img[..., [2, 1, 0, 3][: img.shape[2]]]
    return img


@pytest.mark.parametrize("name", list(_images()))
@pytest.mark.parametrize("level", [0, 3, 9])
def test_png_reads_cv2_files(tmp_path, name, level):
    img = _images()[name]
    path = tmp_path / "a.png"
    _cv2_write(path, img, level)
    got = png.read(str(path))
    want = _cv2_read(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(png.read_color(str(path)), _cv2_read(path, cv2.IMREAD_COLOR))


@pytest.mark.parametrize("name", list(_images()))
def test_cv2_reads_port_pngs(tmp_path, name):
    img = _images(1)[name]
    path = tmp_path / "a.png"
    png.write(str(path), img)
    back = _cv2_read(path)
    assert back.dtype == img.dtype
    np.testing.assert_array_equal(back, img)
    np.testing.assert_array_equal(png.read(str(path)), img)


def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _filtered_png(img, ftypes) -> bytes:
    """A PNG of ``img`` whose row ``r`` uses filter ``ftypes[r]`` (PNG spec
    9.2, byte by byte)."""
    H, W = img.shape[:2]
    depth = 16 if img.dtype == np.uint16 else 8
    color = 0 if img.ndim == 2 else {3: 2, 4: 6}[img.shape[2]]
    px = (img.astype(">u2").view(np.uint8) if depth == 16 else img).reshape(H, -1).astype(np.int64)
    bpp = px.shape[1] // W
    out, prev = [], np.zeros_like(px[0])
    for r, k in enumerate(ftypes):
        x = px[r]
        a = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        p = a + prev - c
        pa, pb, pc = abs(p - a), abs(p - prev), abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prev, c))
        pred = [0, a, prev, (a + prev) // 2, paeth][k]
        out.append(bytes([k]) + ((x - pred) % 256).astype(np.uint8).tobytes())
        prev = x
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, color, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(b"".join(out))) + _chunk(b"IEND", b""))


@pytest.mark.parametrize("name", ["rgb", "rgba", "gray", "depth"])
@pytest.mark.parametrize("filters", ["none", "sub", "up", "runs of none, sub, up", "all five"])
def test_png_reads_every_row_filter(tmp_path, name, filters):
    """Rows with None, Sub and Up only take the run-wise unfilter; any
    Average or Paeth row takes the diagonal walk.  Both read as cv2 does."""
    img = _images(2)[name]
    rng = np.random.default_rng(3)
    H = img.shape[0]
    ftypes = {"none": [0] * H, "sub": [1] * H, "up": [2] * H,
              "runs of none, sub, up": np.repeat(rng.integers(0, 3, H), rng.integers(1, 4, H))[:H],
              "all five": rng.integers(0, 5, H)}[filters]
    path = tmp_path / "f.png"
    path.write_bytes(_filtered_png(img, [int(k) for k in ftypes]))
    got = png.read(str(path))
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(got, _cv2_read(path))


@pytest.mark.parametrize("case", ["palette", "interlaced", "rgb16", "gray4", "gray_alpha", "bad crc", "truncated", "not png"])
def test_png_rejects_what_it_does_not_read(tmp_path, case):
    ihdr = {"palette": (4, 4, 8, 3, 0, 0, 0), "interlaced": (4, 4, 8, 2, 0, 0, 1), "rgb16": (4, 4, 16, 2, 0, 0, 0),
            "gray4": (4, 4, 4, 0, 0, 0, 0), "gray_alpha": (4, 4, 8, 4, 0, 0, 0)}.get(case, (4, 4, 8, 0, 0, 0, 0))
    data = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", *ihdr))
    if case == "palette":
        data += _chunk(b"PLTE", bytes(12))
    idat = _chunk(b"IDAT", zlib.compress(bytes(4 * 5)))
    if case == "bad crc":
        idat = idat[:-1] + bytes([idat[-1] ^ 1])
    data += idat + _chunk(b"IEND", b"")
    if case == "truncated":
        data = data[:-20]
    if case == "not png":
        data = b"GIF89a" + data
    path = tmp_path / "bad.png"
    path.write_bytes(data)
    with pytest.raises(ValueError):
        png.read(str(path))
    if case == "gray4":
        return
    with pytest.raises(ValueError):
        png.read_depth(str(path))


def test_png_depth_must_be_gray(tmp_path):
    path = tmp_path / "c.png"
    png.write(str(path), _images()["rgb"])
    with pytest.raises(ValueError, match="gray"):
        png.read_depth(str(path))


def test_read_file_list_equal(tmp_path):
    p = tmp_path / "rgb.txt"
    p.write_text("# comment\n\n1305031102.175304 rgb/1.png\n1305031102.211214 rgb/2.png extra\n  # indented\n")
    assert ttum.read_file_list(str(p)) == jtum.read_file_list(str(p)) == {
        1305031102.175304: ["rgb/1.png"], 1305031102.211214: ["rgb/2.png", "extra"]}


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("offset", [0.0, 0.013])
def test_associate_equal(seed, offset):
    rng = np.random.default_rng(seed)
    t1 = 1305031102.0 + np.sort(rng.uniform(0, 3, 60))
    t2 = np.sort(np.concatenate([t1[:45] + rng.normal(0, 0.01, 45), 1305031102.0 + rng.uniform(0, 3, 10)]))
    want = jtum.associate(t1, t2, offset=offset)
    assert ttum.associate(t1, t2, offset=offset) == want and len(want) > 20
    assert ttum.associate(list(t1), t2.tolist(), offset, 0.005) == jtum.associate(list(t1), t2.tolist(), offset, 0.005)
    assert ttum.associate([], t2) == jtum.associate([], t2) == []


def _write_tum_dir(d, n=5, with_associate=False, seed=0):
    """A miniature TUM directory (cv2-written PNGs, jittered depth stamps)."""
    rng = np.random.default_rng(seed)
    (d / "rgb").mkdir()
    (d / "depth").mkdir()
    rgb_lines, depth_lines, assoc = ["# color images"], ["# depth maps"], []
    for i in range(n):
        ts = 1305031102.175304 + i / 30.0
        dts = ts + rng.uniform(-0.008, 0.008)
        _cv2_write(d / "rgb" / f"{ts:.6f}.png", rng.integers(0, 256, (24, 32, 3), dtype=np.uint8))
        cv2.imwrite(str(d / "depth" / f"{dts:.6f}.png"), rng.integers(0, 30000, (24, 32), dtype=np.uint16))
        rgb_lines.append(f"{ts:.6f} rgb/{ts:.6f}.png")
        depth_lines.append(f"{dts:.6f} depth/{dts:.6f}.png")
        assoc.append(f"{ts:.6f} rgb/{ts:.6f}.png {dts:.6f} depth/{dts:.6f}.png")
    depth_lines.append(f"{ts + 1.0:.6f} depth/none.png")  # no partner: dropped by association
    (d / "rgb.txt").write_text("\n".join(rgb_lines) + "\n")
    (d / "depth.txt").write_text("\n".join(depth_lines) + "\n")
    if with_associate:
        (d / "associate.txt").write_text("\n".join(assoc[::-1]) + "\n")  # its own order wins
    return d


@pytest.mark.parametrize("with_associate", [False, True])
def test_records_equal(tmp_path, with_associate):
    d = _write_tum_dir(tmp_path, with_associate=with_associate)
    got = ttum.build_associate_records(str(d))
    want = jtum.build_associate_records(str(d))
    assert [vars(r) for r in got] == [vars(r) for r in want] and len(got) == 5
    if with_associate:
        got, want = ttum.parse_associate_file(str(d)), jtum.parse_associate_file(str(d))
        assert [vars(r) for r in got] == [vars(r) for r in want]
        assert got[0].timestamp > got[-1].timestamp


@pytest.mark.parametrize("use_native", [False, True])
@pytest.mark.parametrize("with_associate", [False, True])
def test_iter_dataset_equal(tmp_path, use_native, with_associate, native_libs):
    d = str(_write_tum_dir(tmp_path, with_associate=with_associate, seed=3))
    got = list(ttum.iter_dataset(d, width=32, height=24, use_native=use_native))
    want = list(jtum.iter_dataset(d, width=32, height=24, use_native=use_native))
    assert len(got) == len(want) == 5
    for (r1, rgb1, d1), (r2, rgb2, d2) in zip(got, want):
        assert vars(r1) == vars(r2)
        assert rgb1.dtype == rgb2.dtype == np.uint8 and d1.dtype == d2.dtype == np.uint16
        np.testing.assert_array_equal(rgb1, rgb2)
        np.testing.assert_array_equal(d1, d2)


def test_load_frame_equal(tmp_path):
    d = _write_tum_dir(tmp_path)
    for rec in ttum.build_associate_records(str(d)):
        (a, b), (c, e) = ttum.load_frame(rec), jtum.load_frame(rec)
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, e)
        assert b.dtype == e.dtype == np.uint16
    with pytest.raises(FileNotFoundError):
        ttum.load_frame(ttum.TumRecord(0.0, str(tmp_path / "none.png"), str(tmp_path / "none.png")))


# ---- the native loader (modelled on tests/test_native.py) -----------------


@pytest.fixture(scope="module")
def png_dataset(tmp_path_factory, native_libs):
    d = tmp_path_factory.mktemp("tum")
    rng = np.random.default_rng(0)
    rgb_paths, depth_paths, rgbs, depths = [], [], [], []
    for i in range(6):
        rgb = rng.integers(0, 255, (48, 64, 3), dtype=np.uint8)
        depth = rng.integers(0, 40000, (48, 64), dtype=np.uint16)
        rp, dp = str(d / f"rgb_{i}.png"), str(d / f"depth_{i}.png")
        if i % 2:  # half of them from the port's writer
            png.write(rp, rgb)
            png.write(dp, depth)
        else:
            _cv2_write(rp, rgb)
            cv2.imwrite(dp, depth)
        rgb_paths.append(rp)
        depth_paths.append(dp)
        rgbs.append(rgb)
        depths.append(depth)
    return rgb_paths, depth_paths, rgbs, depths


def test_native_sources_are_copies():
    for rel in ("src/dataloader.cpp",):
        a = os.path.join(REPO, "rgbd_visualodometry_tpu_torch", "native", rel)
        b = os.path.join(REPO, "rgbd_visualodometry_tpu", "native", rel)
        assert open(a, "rb").read() == open(b, "rb").read()


def test_native_builds_into_the_build_dir(native_libs):
    path = tnative._lib_path()
    assert path.exists() and path.parent == tnative.BUILD_DIR and path.parent.name == "_build"
    assert tnative.build_error() is None


def test_native_decode_matches_opencv_and_jax(png_dataset):
    rgb_paths, depth_paths, rgbs, depths = png_dataset
    got = list(tnative.NativeLoader(rgb_paths, depth_paths, width=64, height=48))
    want = list(jnative.NativeLoader(rgb_paths, depth_paths, width=64, height=48))
    assert [i for i, _, _ in got] == [i for i, _, _ in want] == list(range(6))
    for (idx, rgb, depth), (_, rgb2, depth2) in zip(got, want):
        np.testing.assert_array_equal(rgb, rgbs[idx])
        np.testing.assert_array_equal(depth, depths[idx])
        np.testing.assert_array_equal(rgb, rgb2)
        np.testing.assert_array_equal(depth, depth2)


def test_native_loader_in_order(png_dataset):
    rgb_paths, depth_paths, *_ = png_dataset
    loader = tnative.NativeLoader(rgb_paths, depth_paths, 64, 48, prefetch=3, workers=3)
    assert [idx for idx, _, _ in loader] == list(range(6))


def test_native_loader_errors(png_dataset):
    rgb_paths, depth_paths, *_ = png_dataset
    with pytest.raises(IOError):
        list(tnative.NativeLoader(rgb_paths, depth_paths, width=10, height=10))
    with pytest.raises(IOError):  # an RGB image where depth belongs: decode error
        list(tnative.NativeLoader(rgb_paths, rgb_paths, width=64, height=48))
    with pytest.raises(ValueError):
        tnative.NativeLoader(rgb_paths, depth_paths[:2], width=64, height=48)


@pytest.mark.parametrize("seed", range(3))
def test_native_associate_equal(seed, native_libs):
    rng = np.random.default_rng(seed)
    t1 = np.sort(rng.uniform(0, 10, 40))
    t2 = np.sort(t1[:30] + rng.normal(0, 0.008, 30))
    want = jtum.associate(t1, t2)
    assert tnative.native_associate(t1, t2) == jnative.native_associate(t1, t2) == want
    assert ttum.associate(t1, t2, 0.01, 0.05) == tnative.native_associate(t1, t2, 0.01, 0.05)
    assert tnative.native_associate([0.0, 1.0], [0.015, 2.0]) == [(0, 0)]
    assert tnative.native_associate([10.0], [9.5], offset=0.5) == [(0, 0)]
