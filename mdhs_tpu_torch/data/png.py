"""PNG reading and writing with the standard library's zlib and numpy.

The dataset opens images with PIL where it imports (``data/datasets.py``);
on a machine without PIL it reads PNG here: 8-bit gray, RGB or RGBA, not interlaced, all five row filters. Any
other file or PNG variant raises an error that names PIL. ``encode_png``
writes 8-bit gray, RGB or RGBA with filter 0 on every row.
``decode_png.calls`` counts the images decoded here.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}  # colour type -> samples a pixel


class UnsupportedImage(ValueError):
    """An image this reader does not decode; PIL would."""


def is_png(data: bytes) -> bool:
    return data[:8] == SIGNATURE


def _chunks(data: bytes):
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length or zlib.crc32(kind + body) != struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])[0]:
            raise ValueError(f"corrupt PNG chunk {kind!r}")
        yield kind, body
        pos += 12 + length


def _paeth_row(raw: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(len(raw)):
        a = raw[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        raw[i] = (raw[i] + pred) & 0xFF


def _average_row(raw: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(len(raw)):
        a = raw[i - bpp] if i >= bpp else 0
        raw[i] = (raw[i] + ((a + prev[i]) >> 1)) & 0xFF


def _unfilter(data: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    if len(data) != height * (stride + 1):
        raise ValueError(f"PNG image data holds {len(data)} bytes, expected {height * (stride + 1)}")
    rows = np.frombuffer(data, np.uint8).reshape(height, stride + 1)
    filters = rows[:, 0]
    out = rows[:, 1:].copy()
    if not filters.any():  # filter 0 throughout: the bytes as they are
        return out
    if int(filters.max()) > 4:
        raise ValueError(f"PNG row filter {int(filters.max())} does not exist")
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        f = filters[y]
        if f == 1:  # Sub: a running sum along each channel, mod 256
            out[y] = np.cumsum(out[y].reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif f == 2:  # Up
            out[y] += prev
        elif f in (3, 4):  # Average, Paeth: each byte on the one decoded before it
            row = bytearray(out[y].tobytes())
            (_average_row if f == 3 else _paeth_row)(row, prev.tobytes(), bpp)
            out[y] = np.frombuffer(row, np.uint8)
        prev = out[y]
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 (H, W) for gray, (H, W, 3) for RGB, (H, W, 4) for RGBA."""
    if not is_png(data):
        raise UnsupportedImage("not a PNG file: without PIL only PNG images are read (install Pillow for others)")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    width, height, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in _CHANNELS or interlace != 0:
        raise UnsupportedImage(f"PNG of bit depth {depth}, colour type {colour}, interlace {interlace}: "
                               "without PIL only 8-bit gray, RGB and RGBA non-interlaced PNGs are read "
                               "(install Pillow for others)")
    c = _CHANNELS[colour]
    pixels = _unfilter(zlib.decompress(b"".join(idat)), height, width * c, c)
    decode_png.calls += 1
    return pixels.reshape(height, width) if c == 1 else pixels.reshape(height, width, c)


decode_png.calls = 0


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def encode_png(img: np.ndarray) -> bytes:
    """uint8 (H, W), (H, W, 1), (H, W, 3) or (H, W, 4) -> PNG bytes, filter 0 on every row, the
    image data deflated at zlib level 1 (the fastest: any level reads back the same pixels)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"encode_png takes uint8, got {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    c = 1 if img.ndim == 2 else img.shape[2]
    colour = {1: 0, 3: 2, 4: 6}.get(c)
    if colour is None or img.ndim not in (2, 3):
        raise ValueError(f"encode_png takes (H, W[, 1|3|4]), got {img.shape}")
    h, w = img.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), np.ascontiguousarray(img).reshape(h, w * c)], axis=1)
    return (SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)) + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))
