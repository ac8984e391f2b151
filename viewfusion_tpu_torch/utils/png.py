"""A PNG codec of the port's own (``zlib`` and numpy; no PIL).

:func:`decode_png` reads every standard PNG: gray at 1, 2, 4, 8 and 16
bits, palette at 1, 2, 4 and 8, RGB, gray-alpha and RGBA at 8 and 16,
non-interlaced or Adam7-interlaced, all five row filters, and returns
(H, W, 3) uint8 equal to PIL's ``Image.open(...).convert("RGB")``: alpha
and ``tRNS`` are dropped, gray below 8 bits is scaled to 0..255 (1 bit
opens as mode "1", 2 and 4 bits as "L;2"/"L;4"), and 16-bit samples keep
their high byte, except 16-bit gray, which PIL opens as "I;16" and whose
``convert("RGB")`` clips the value at 255 (0, 1000, 2000 -> 0, 255, 255).
(The native loader, ``native/vfloader.cpp``, reads only the 8-bit,
non-interlaced ones.)  A malformed file raises a ``ValueError``, and so
does an image of more than :data:`MAX_PIXELS` pixels, as PIL's
``DecompressionBombError`` does, before its data is inflated; the data is
inflated no further than the header's size needs.  Every decoder of the
port takes ``max_side``: a frame whose header declares more rows or
columns raises :class:`FrameTooLarge` (a ``ValueError``) before anything
past the header is read, so that a server bounds a view's work by the size
it serves.

:func:`encode_png` writes RGB uint8, each row with the filter (None, Sub
or Up) whose output has the least sum of absolute values.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = ["decode_png", "encode_png", "MAX_PIXELS", "FrameTooLarge",
           "check_side"]

# PIL's Image.MAX_IMAGE_PIXELS (1024 ** 3 // 4 // 3) twice: the size above
# which ``Image.open`` raises DecompressionBombError (JPEG holds to it too)
MAX_PIXELS = 2 * (1024 * 1024 * 1024 // 4 // 3)


class FrameTooLarge(ValueError):
    """A frame whose header declares more rows or columns than the caller
    takes."""


def check_side(w: int, h: int, max_side) -> None:
    """Raise :class:`FrameTooLarge` where ``w`` or ``h`` is over
    ``max_side`` (None: no limit)."""
    if max_side is not None and max(w, h) > max_side:
        raise FrameTooLarge(f"a frame of {w}x{h} is over the side of "
                            f"{max_side} pixels asked for")

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples per pixel
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# colour type -> the bit depths the PNG spec allows for it
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
# Adam7: (x0, y0, dx, dy) of the seven passes
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


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


def _samples(rows: np.ndarray, w: int, depth: int, ch: int) -> np.ndarray:
    """Unfiltered rows (H, stride) -> (H, W, ch) samples (uint16 at 16
    bits, else uint8)."""
    h = rows.shape[0]
    if depth == 16:
        return rows.view(">u2").astype(np.uint16).reshape(h, -1)[
            :, :w * ch].reshape(h, w, ch)
    if depth < 8:  # packed MSB first
        bits = np.unpackbits(rows, axis=1).reshape(h, -1, depth)
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        rows = (bits * weights).sum(axis=2, dtype=np.uint8)
    return rows[:, :w * ch].reshape(h, w, ch)


def decode_png(data: bytes, max_side=None) -> np.ndarray:
    """PNG bytes -> (H, W, 3) uint8 RGB (see the module docstring)."""
    header, palette, idat = None, None, []
    for kind, body in _chunks(bytes(data)):
        if kind == b"IHDR":
            if len(body) != 13:
                raise ValueError("corrupt PNG file: an IHDR chunk of "
                                 f"{len(body)} bytes")
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG file has no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if color not in _CHANNELS:
        raise ValueError(f"unknown PNG colour type {color}")
    if depth not in _DEPTHS[color]:
        raise ValueError(f"{depth}-bit PNG files of colour type {color} do "
                         "not exist")
    if interlace not in (0, 1):
        raise ValueError(f"unknown PNG interlace method {interlace}")
    if w * h > MAX_PIXELS:
        raise ValueError(f"PNG image of {w}x{h} = {w * h} pixels is over "
                         f"the limit of {MAX_PIXELS}")
    check_side(w, h, max_side)
    ch = _CHANNELS[color]
    bpp = max(1, depth * ch // 8)  # the filters' byte distance

    def stride(width):
        return (width * depth * ch + 7) // 8

    if not interlace:
        size = h * (stride(w) + 1)
    else:
        size = sum(-(-(h - y0) // dy) * (stride(-(-(w - x0) // dx)) + 1)
                   for x0, y0, dx, dy in _ADAM7 if w > x0 and h > y0)
    try:
        raw = zlib.decompressobj().decompress(b"".join(idat), size)
    except zlib.error as e:
        raise ValueError(f"corrupt PNG image data: {e}") from e
    if not interlace:
        pix = _samples(_unfilter(raw, h, stride(w), bpp), w, depth, ch)
    else:
        pix = np.zeros((h, w, ch), np.uint16 if depth == 16 else np.uint8)
        pos = 0
        for x0, y0, dx, dy in _ADAM7:
            pw, ph = (w - x0 + dx - 1) // dx, (h - y0 + dy - 1) // dy
            if pw <= 0 or ph <= 0:
                continue  # an empty pass has no bytes, not even filters
            n = ph * (stride(pw) + 1)
            pix[y0::dy, x0::dx] = _samples(
                _unfilter(raw[pos:pos + n], ph, stride(pw), bpp), pw,
                depth, ch)
            pos += n
    if color == 3:
        if palette is None:
            raise ValueError("palette PNG file has no PLTE chunk")
        if pix.max(initial=0) >= len(palette):
            raise ValueError("PNG palette index out of range")
        return palette[pix[..., 0]]
    if depth == 16:
        if color == 0:  # PIL's "I;16" -> RGB clips rather than shifts
            return np.repeat(np.minimum(pix, 255).astype(np.uint8), 3, 2)
        pix = (pix >> 8).astype(np.uint8)
    elif depth < 8:  # gray: PIL's "1", "L;2" and "L;4" scale to 0..255
        pix = pix * np.uint8(255 // ((1 << depth) - 1))
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
