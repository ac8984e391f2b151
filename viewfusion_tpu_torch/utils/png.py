"""A PNG codec of the port's own (``zlib`` and numpy; no PIL).

:func:`decode_png` reads exactly the set that the native loader decodes
(``native/vfloader.cpp``): 8-bit gray, RGB, palette, gray-alpha and RGBA,
non-interlaced, all five row filters, and returns (H, W, 3) uint8 with the
alpha dropped, which is what PIL's ``Image.open(...).convert("RGB")``
gives for those files.  Interlaced files and other bit depths raise.

:func:`encode_png` writes RGB uint8, each row with the filter (None, Sub
or Up) whose output has the least sum of absolute values.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = ["decode_png", "encode_png"]

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples per pixel
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunks(data: bytes):
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"truncated PNG chunk {kind!r}")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG file ends without IEND")


def _paeth_row(line: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(len(line)):
        a = line[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        line[i] = (line[i] + pred) & 0xFF


def _average_row(line: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(len(line)):
        a = line[i - bpp] if i >= bpp else 0
        line[i] = (line[i] + ((a + prev[i]) >> 1)) & 0xFF


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters: (H, stride) uint8."""
    if len(raw) < h * (stride + 1):
        raise ValueError("PNG image data is shorter than its header says")
    rows = np.frombuffer(raw, np.uint8, h * (stride + 1)).reshape(
        h, stride + 1)
    kinds, data = rows[:, 0], rows[:, 1:]
    if kinds.max(initial=0) > 4:
        raise ValueError(f"unknown PNG row filter {int(kinds.max())}")
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = kinds[y], data[y]
        if kind == 0:
            out[y] = line
        elif kind == 1:  # Sub: a running sum per channel, mod 256
            out[y] = np.cumsum(line.reshape(-1, bpp), axis=0,
                               dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            out[y] = line + prev
        else:
            buf = bytearray(line.tobytes())
            (_average_row if kind == 3 else _paeth_row)(
                buf, prev.tobytes(), bpp)
            out[y] = np.frombuffer(bytes(buf), np.uint8)
        prev = out[y]
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, 3) uint8 RGB (see the module docstring)."""
    header, palette, idat = None, None, []
    for kind, body in _chunks(bytes(data)):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG file has no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if interlace:
        raise ValueError("interlaced PNG files are not supported")
    if depth != 8:
        raise ValueError(f"{depth}-bit PNG files are not supported "
                         "(8-bit only)")
    if color not in _CHANNELS:
        raise ValueError(f"unknown PNG colour type {color}")
    ch = _CHANNELS[color]
    pix = _unfilter(zlib.decompress(b"".join(idat)), h, w * ch, ch)
    pix = pix.reshape(h, w, ch)
    if color == 3:
        if palette is None:
            raise ValueError("palette PNG file has no PLTE chunk")
        if pix.max(initial=0) >= len(palette):
            raise ValueError("PNG palette index out of range")
        return palette[pix[..., 0]]
    if color in (0, 4):
        return np.repeat(pix[..., :1], 3, axis=2)
    return np.ascontiguousarray(pix[..., :3])


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def encode_png(image: np.ndarray, level: int = 6) -> bytes:
    """(H, W, 3) uint8 RGB -> PNG bytes."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"encode_png takes (H, W, 3) uint8, got "
                         f"{image.dtype} {image.shape}")
    h, w, _ = image.shape
    rows = image.reshape(h, w * 3)
    left = np.zeros_like(rows)
    left[:, 3:] = rows[:, :-3]
    up = np.zeros_like(rows)
    up[1:] = rows[:-1]
    candidates = np.stack([rows, rows - left, rows - up])  # None, Sub, Up
    # the PNG spec's heuristic: least sum of |byte| as signed values
    cost = np.abs(candidates.astype(np.int8).astype(np.int32)).sum(axis=2)
    kind = cost.argmin(axis=0)
    filtered = np.empty((h, w * 3 + 1), np.uint8)
    filtered[:, 0] = kind
    filtered[:, 1:] = candidates[kind, np.arange(h)]
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(filtered.tobytes(), level))
            + _chunk(b"IEND", b""))
