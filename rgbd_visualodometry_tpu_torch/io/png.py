"""PNG reading and writing with numpy and the standard library's ``zlib``.

The port decodes TUM frames without OpenCV, which the CUDA machines may
lack: this module reads what ``cv2.imread`` reads for the TUM formats and
writes files that ``cv2.imread`` reads back exactly.  Supported: 8-bit
gray, RGB and RGBA and 16-bit gray, not interlaced, with any of the five
row filters (PNG spec 9.2); anything else raises ``ValueError``.  Chunk
CRCs are checked.

The four filters that predict from the previous row or the left pixel make
each byte depend on bytes decoded before it, so rows cannot be unfiltered
independently.  Where no row uses Average or Paeth, :func:`_unfilter`
takes each run of rows with one filter in one vectorized step: Sub is a
running sum modulo 256 along the row, Up one down the columns.  Otherwise
it walks the image by anti-diagonals (pixel ``(r, c)`` on diagonal
``r + c``): every pixel's left, upper and upper-left neighbours lie on
earlier diagonals, so one diagonal is one vectorized step whatever filter
each row uses.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels, for the types this module reads and writes
_CHANNELS = {0: 1, 2: 3, 6: 4}


def _chunks(data: bytes):
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos : pos + 8])
        body = data[pos + 8 : pos + 8 + length]
        crc = data[pos + 8 + length : pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"truncated PNG chunk {kind!r}")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG file has no IEND chunk")


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, ftype: np.ndarray) -> np.ndarray:
    """Filtered bytes ``[H, W, bpp]`` with each row's filter type ``[H]`` ->
    the image's bytes ``[H, W, bpp]`` uint8."""
    H, W, bpp = raw.shape
    if H == 0 or W == 0:
        return raw.copy()
    if (ftype <= 2).all():
        return _unfilter_runs(raw, ftype)
    return _unfilter_diagonals(raw, ftype)


def _unfilter_runs(raw: np.ndarray, ftype: np.ndarray) -> np.ndarray:
    """:func:`_unfilter` for rows filtered with None, Sub or Up only, one
    step per run of rows with the same filter (uint8 sums wrap modulo 256)."""
    out = raw.copy()
    ends = np.flatnonzero(np.diff(ftype.astype(np.int16))) + 1
    for r0, r1 in zip(np.concatenate([[0], ends]), np.concatenate([ends, [len(ftype)]])):
        if ftype[r0] == 1:  # Sub: the same byte of the pixel to the left
            out[r0:r1] = np.cumsum(raw[r0:r1], axis=1, dtype=np.uint8)
        elif ftype[r0] == 2:  # Up: the same byte of the row above
            out[r0:r1] = np.cumsum(raw[r0:r1], axis=0, dtype=np.uint8)
            if r0 > 0:
                out[r0:r1] += out[r0 - 1]
    return out


def _unfilter_diagonals(raw: np.ndarray, ftype: np.ndarray) -> np.ndarray:
    """:func:`_unfilter` for any mix of the five filters."""
    H, W, bpp = raw.shape
    # skewed layout: pixel (r, c) at column r + c, so a diagonal is a column
    # slice; skew[r + 1, d + 2] holds diagonal d, with a zero row above and
    # two zero columns on the left for the neighbours outside the image
    rows, cols = np.arange(H)[:, None], np.arange(W)[None, :]
    filtered = np.zeros((H, H + W - 1, bpp), np.int32)
    filtered[rows, rows + cols] = raw
    skew = np.zeros((H + 1, H + W + 1, bpp), np.int32)
    masks = [(ftype == k)[:, None].astype(np.int32) for k in range(5)]
    count = [np.concatenate([[0], np.cumsum(m[:, 0])]) for m in masks]
    for d in range(H + W - 1):
        r0, r1 = max(0, d - W + 1), min(H, d + 1)
        a = skew[r0 + 1 : r1 + 1, d + 1]  # left
        b = skew[r0:r1, d + 1]  # up
        pred = masks[1][r0:r1] * a + masks[2][r0:r1] * b
        if count[3][r1] > count[3][r0]:
            pred += masks[3][r0:r1] * ((a + b) >> 1)
        if count[4][r1] > count[4][r0]:
            pred += masks[4][r0:r1] * _paeth(a, b, skew[r0:r1, d])
        skew[r0 + 1 : r1 + 1, d + 2] = (filtered[r0:r1, d] + pred) & 0xFF
    return skew[rows + 1, rows + cols + 2].astype(np.uint8)


def read(path: str) -> np.ndarray:
    """The pixels of a PNG file: ``[H, W]`` uint8 or uint16 for gray,
    ``[H, W, 3]`` RGB or ``[H, W, 4]`` RGBA uint8."""
    with open(path, "rb") as f:
        data = f.read()
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"PLTE":
            raise ValueError(f"{path}: palette PNGs are not supported")
    if header is None:
        raise ValueError(f"{path}: PNG file has no IHDR chunk")
    W, H, depth, color, compression, filt, interlace = header
    if color not in _CHANNELS or compression != 0 or filt != 0 or interlace != 0:
        raise ValueError(f"{path}: unsupported PNG (colour type {color}, interlace {interlace})")
    if depth != 8 and not (depth == 16 and color == 0):
        raise ValueError(f"{path}: unsupported PNG bit depth {depth} for colour type {color}")
    ch = _CHANNELS[color]
    bpp = ch * depth // 8
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if rows.size != H * (1 + W * bpp):
        raise ValueError(f"{path}: PNG image data has {rows.size} bytes, expected {H * (1 + W * bpp)}")
    rows = rows.reshape(H, 1 + W * bpp)
    ftype = rows[:, 0]
    if (ftype > 4).any():
        raise ValueError(f"{path}: unknown PNG row filter {int(ftype.max())}")
    img = _unfilter(rows[:, 1:].reshape(H, W, bpp), ftype)
    if depth == 16:
        return (img[..., 0].astype(np.uint16) << 8) | img[..., 1]
    return img[..., 0] if ch == 1 else img


def read_color(path: str) -> np.ndarray:
    """``[H, W, 3]`` uint8 RGB, as ``cv2.imread(path, cv2.IMREAD_COLOR)``
    gives it reversed to RGB: gray replicated, 16 bits cut to their high 8,
    alpha dropped."""
    img = read(path)
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


def read_depth(path: str) -> np.ndarray:
    """``[H, W]`` uint16 raw depth, as ``cv2.imread(path,
    cv2.IMREAD_UNCHANGED)`` gives a gray PNG; a colour PNG raises."""
    img = read(path)
    if img.ndim != 2:
        raise ValueError(f"{path}: a depth image must be a gray PNG")
    return img.astype(np.uint16)


def write(path: str, img: np.ndarray, level: int = 6) -> None:
    """Write ``[H, W]`` uint8 or uint16 gray, ``[H, W, 3]`` RGB or
    ``[H, W, 4]`` RGBA uint8 as a PNG (every row with the Sub filter)."""
    img = np.asarray(img)
    if img.dtype == np.uint16 and img.ndim == 2:
        color, depth = 0, 16
        px = img.astype(">u2").view(np.uint8).reshape(img.shape[0], img.shape[1], 2)
    elif img.dtype == np.uint8 and (img.ndim == 2 or (img.ndim == 3 and img.shape[2] in (3, 4))):
        color = 0 if img.ndim == 2 else {3: 2, 4: 6}[img.shape[2]]
        depth = 8
        px = img.reshape(img.shape[0], img.shape[1], -1)
    else:
        raise ValueError(f"cannot write a {img.dtype} image of shape {img.shape} as PNG")
    H, W = px.shape[:2]
    left = np.zeros_like(px)
    left[:, 1:] = px[:, :-1]
    sub = (px.astype(np.int16) - left).astype(np.uint8).reshape(H, -1)
    rows = np.concatenate([np.ones((H, 1), np.uint8), sub], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    data = (
        _SIGNATURE
        + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, color, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
        + chunk(b"IEND", b"")
    )
    with open(path, "wb") as f:
        f.write(data)
