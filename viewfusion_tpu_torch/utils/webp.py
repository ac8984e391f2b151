"""The WebP (RIFF) container, read as libwebp's demuxer and animation
decoder read it for Pillow, on the port's own VP8 and VP8L decoders.

:func:`decode_webp` returns (H, W, 3) uint8 equal to
``Image.open(...).convert("RGB")``; :func:`decode_webp_rgba` also returns
the alpha that Pillow's RGBA decode holds.

* Simple files: one ``VP8 `` (lossy, :mod:`.vp8`) or ``VP8L`` (lossless,
  :mod:`.vp8l`) chunk.
* Extended files (``VP8X``): the canvas size; a still image of that size,
  lossy with an optional ``ALPH`` chunk before it (raw or VP8L-coded alpha
  under the none, horizontal, vertical or gradient filter), or lossless;
  ``ICCP``, ``EXIF``, ``XMP `` and unknown chunks are skipped.
* Animations (``ANIM``, then ``ANMF`` frames): the first frame, of its
  bitstream's size, placed at its offset on a canvas of transparent black,
  as libwebp's ``WebPAnimDecoder`` gives it to Pillow.

Pillow asks libwebp for non-premultiplied RGBA, and ``convert("RGB")``
drops the alpha, so alpha changes no RGB value.  :func:`decode_webp`
still reads a coded alpha stream, since a file whose alpha does not decode
fails in libwebp too, but does not undo its filter, which cannot fail.  A
canvas or frame of more than :data:`MAX_PIXELS` pixels (checked before
anything is allocated), a truncated or malformed container, a frame
outside the canvas, and any fault of the bitstreams raise a
``ValueError``; so does a canvas over ``max_side`` (see
:func:`~viewfusion_tpu_torch.utils.png.check_side`).
"""

from __future__ import annotations

import struct

import numpy as np

from viewfusion_tpu_torch.utils.png import MAX_PIXELS, check_side
from viewfusion_tpu_torch.utils.vp8 import decode_vp8, vp8_size
from viewfusion_tpu_torch.utils.vp8l import (decode_vp8l, decode_vp8l_stream,
                                             vp8l_size)

__all__ = ["decode_webp", "decode_webp_rgba"]

_ANIMATION = 0x02  # the VP8X flag of an animation


def _chunks(data: bytes, pos: int, end: int):
    """(fourcc, payload start, payload size) of the chunks in
    ``data[pos:end]``."""
    while pos + 8 <= end:
        kind = data[pos:pos + 4]
        (size,) = struct.unpack("<I", data[pos + 4:pos + 8])
        if pos + 8 + size > end:
            raise ValueError(f"truncated WebP file: chunk {kind!r} is cut "
                             "short")
        yield kind, pos + 8, size
        pos += 8 + size + (size & 1)
    if pos < end:
        raise ValueError("truncated WebP file: a chunk header is cut short")


def _check_size(w: int, h: int, what: str) -> None:
    if w * h > MAX_PIXELS:
        raise ValueError(f"WebP {what} of {w}x{h} = {w * h} pixels is over "
                         f"the limit of {MAX_PIXELS}")


def _image_size(kind: bytes, payload: bytes):
    return vp8_size(payload) if kind == b"VP8 " else vp8l_size(payload)


def _alpha(payload: bytes, w: int, h: int, unfilter: bool) -> np.ndarray:
    """An ``ALPH`` chunk -> (h, w) uint8 alpha, its filter undone where
    ``unfilter`` asks for it."""
    if not payload:
        raise ValueError("corrupt WebP file: an empty ALPH chunk")
    head = payload[0]
    method, filt, pre = head & 3, (head >> 2) & 3, (head >> 4) & 3
    if method > 1 or pre > 1 or head >> 6:
        raise ValueError(f"corrupt WebP file: ALPH header {head:#04x}")
    if method == 0:
        if len(payload) - 1 < w * h:
            raise ValueError("truncated WebP file: raw alpha is cut short")
        a = np.frombuffer(payload, np.uint8, w * h, 1).reshape(h, w)
    else:
        a = ((decode_vp8l_stream(payload[1:], w, h) >> 8) & 255).astype(
            np.uint8)
    if filt == 0 or not unfilter:
        return a
    a = a.astype(np.int64)
    out = np.empty_like(a)
    out[0] = np.cumsum(a[0]) & 255  # the first row: left prediction
    if filt == 1:  # horizontal: column 0 from above, then left
        for y in range(1, h):
            row = a[y].copy()
            row[0] += out[y - 1, 0]
            out[y] = np.cumsum(row) & 255
    elif filt == 2:  # vertical
        out[1:] = (np.cumsum(a[1:], axis=0) + out[0]) & 255
    else:  # gradient: clip(left + top - top-left), column 0 from above
        prev = out[0].tolist()
        for y in range(1, h):
            row = a[y].tolist()
            left = prev[0]
            cur = []
            for x in range(w):
                if x == 0:
                    pred = prev[0]
                else:
                    pred = min(max(left + prev[x] - prev[x - 1], 0), 255)
                left = (row[x] + pred) & 255
                cur.append(left)
            out[y] = cur
            prev = cur
    return out.astype(np.uint8)


def _frame(data: bytes, parts: dict, w: int, h: int,
           rgba: bool) -> np.ndarray:
    """An image (with its ALPH chunk, if any) -> (h, w, 4) uint8 RGBA (the
    alpha of a lossy image left filtered unless ``rgba``)."""
    kind, start, size = parts["image"]
    payload = data[start:start + size]
    if kind == b"VP8L":
        argb = decode_vp8l(payload)
        return np.stack([(argb >> 16) & 255, (argb >> 8) & 255, argb & 255,
                         argb >> 24], -1).astype(np.uint8)
    rgb = decode_vp8(payload)
    alpha = np.full((h, w), 255, np.uint8)
    if "alpha" in parts:
        _, a0, an = parts["alpha"]
        alpha = _alpha(data[a0:a0 + an], w, h, rgba)
    return np.concatenate([rgb, alpha[..., None]], axis=2)


def decode_webp_rgba(data: bytes) -> np.ndarray:
    """WebP bytes -> (H, W, 4) uint8 RGBA of the first frame (see the
    module docstring)."""
    return _decode(data, None, True)


def decode_webp(data: bytes, max_side=None) -> np.ndarray:
    """WebP bytes -> (H, W, 3) uint8 RGB (see the module docstring)."""
    return np.ascontiguousarray(_decode(data, max_side, False)[..., :3])


def _decode(data: bytes, max_side, rgba: bool) -> np.ndarray:
    data = bytes(data)
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WEBP":
        raise ValueError("not a WebP file")
    (riff,) = struct.unpack("<I", data[4:8])
    if riff < 12:
        raise ValueError(f"corrupt WebP file: RIFF size {riff}")
    end = riff + 8
    if len(data) < end:
        raise ValueError("truncated WebP file: shorter than its RIFF size")
    # the generator reads no further than the first chunk here
    kind, start, size = next(_chunks(data, 12, end), (None, 0, 0))
    if kind in (b"VP8 ", b"VP8L"):  # a simple file: its one chunk is read
        w, h = _image_size(kind, data[start:start + size])
        _check_size(w, h, "image")
        check_side(w, h, max_side)
        return _frame(data, {"image": (kind, start, size)}, w, h, rgba)
    if kind != b"VP8X":
        raise ValueError(f"corrupt WebP file: first chunk {kind!r}")
    chunks = list(_chunks(data, 12, end))
    if size < 10:
        raise ValueError("corrupt WebP file: a VP8X chunk of "
                         f"{size} bytes")
    flags = data[start]
    cw = 1 + int.from_bytes(data[start + 4:start + 7], "little")
    ch = 1 + int.from_bytes(data[start + 7:start + 10], "little")
    _check_size(cw, ch, "canvas")
    check_side(cw, ch, max_side)
    animated = bool(flags & _ANIMATION)
    still, first, anim = {}, None, False
    for kind, start, size in chunks[1:]:
        if kind == b"VP8X":
            raise ValueError("corrupt WebP file: a second VP8X chunk")
        if kind in (b"ALPH", b"VP8 ", b"VP8L"):
            if anim or animated:
                raise ValueError("corrupt WebP file: an image chunk outside "
                                 "ANMF in an animation")
            if "image" in still:
                if kind == b"ALPH":
                    continue
                raise ValueError("corrupt WebP file: a second image")
            if kind == b"ALPH":
                still.setdefault("alpha", (kind, start, size))
            elif kind == b"VP8L" and "alpha" in still:
                raise ValueError("corrupt WebP file: ALPH before a lossless "
                                 "image")
            else:
                still["image"] = (kind, start, size)
        elif kind == b"ANIM":
            if size < 6:
                raise ValueError("corrupt WebP file: a short ANIM chunk")
            anim = True
        elif kind == b"ANMF":
            if not anim:
                raise ValueError("corrupt WebP file: ANMF before ANIM")
            if size < 16:
                raise ValueError("corrupt WebP file: a short ANMF chunk")
            if animated and first is None:
                first = (start, size)
    if not animated:
        if "image" not in still:
            raise ValueError("WebP file holds no image")
        kind, start, size = still["image"]
        w, h = _image_size(kind, data[start:start + size])
        if (w, h) != (cw, ch):
            raise ValueError(f"corrupt WebP file: an image of {w}x{h} on a "
                             f"canvas of {cw}x{ch}")
        return _frame(data, still, w, h, rgba)
    if first is None:
        raise ValueError("WebP animation holds no frame")
    start, size = first
    x0 = 2 * int.from_bytes(data[start:start + 3], "little")
    y0 = 2 * int.from_bytes(data[start + 3:start + 6], "little")
    parts = {}
    for kind, s, n in _chunks(data, start + 16, start + size):
        if kind == b"ALPH" and not parts:
            parts["alpha"] = (kind, s, n)
        elif kind in (b"VP8 ", b"VP8L"):
            if kind == b"VP8L" and "alpha" in parts:
                raise ValueError("corrupt WebP file: ALPH before a lossless "
                                 "frame")
            parts["image"] = (kind, s, n)
            break
    if "image" not in parts:
        raise ValueError("WebP animation frame holds no image")
    kind, s, n = parts["image"]
    w, h = _image_size(kind, data[s:s + n])
    _check_size(w, h, "frame")
    if x0 + w > cw or y0 + h > ch:
        raise ValueError(f"corrupt WebP file: a frame of {w}x{h} at "
                         f"({x0}, {y0}) outside the {cw}x{ch} canvas")
    canvas = np.zeros((ch, cw, 4), np.uint8)
    canvas[y0:y0 + h, x0:x0 + w] = _frame(data, parts, w, h, rgba)
    return canvas
