"""Image grid / PNG / GIF utilities on NHWC numpy (the port's copy of
``viewfusion_tpu/utils/image.py``), and the image reader of the port's
entry points.

``make_grid`` follows torchvision's semantics: row-major tiles,
``padding`` pixels of ``pad_value`` between tiles and around the border,
and an optional per-image min-max rescale (``scale_each``).  PNGs go
through the port's codec (:mod:`viewfusion_tpu_torch.utils.png`), GIFs
through the GIF89a writer below; neither needs PIL.

:func:`decode_image` reads what the JAX package reads through PIL's
``Image.open(...).convert("RGB")``, choosing the decoder by the file's
signature: PNG (``utils/png.py``), JPEG (``utils/jpeg.py``), GIF
(``utils/gif.py``), BMP (``utils/bmp.py``), TIFF (``utils/tiff.py``) and
WebP (``utils/webp.py`` over ``utils/vp8.py`` and ``utils/vp8l.py``).
Each is bit-equal to Pillow on what it accepts; a variant it does not read
(named in its module) and any other file raise a ``ValueError`` naming it.
"""

from __future__ import annotations

import struct
from typing import List, Sequence

import numpy as np

from viewfusion_tpu_torch.utils.bmp import decode_bmp
from viewfusion_tpu_torch.utils.gif import decode_gif
from viewfusion_tpu_torch.utils.jpeg import decode_jpeg, is_jpeg
from viewfusion_tpu_torch.utils.png import decode_png, encode_png
from viewfusion_tpu_torch.utils.tiff import decode_tiff
from viewfusion_tpu_torch.utils.webp import decode_webp

__all__ = ["make_grid", "to_uint8", "save_png", "save_gif", "encode_gif",
           "gif_palette", "decode_image", "image_format"]

# signature -> format, after PNG and JPEG
_SIGNATURES = ((b"GIF87a", "GIF"), (b"GIF89a", "GIF"), (b"BM", "BMP"),
               (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"))
_DECODERS = {"PNG": decode_png, "JPEG": decode_jpeg, "GIF": decode_gif,
             "BMP": decode_bmp, "TIFF": decode_tiff, "WebP": decode_webp}


def image_format(data: bytes) -> str:
    """The format of encoded image bytes, by signature: "PNG", "JPEG",
    "GIF", "BMP", "TIFF", "WebP" or "unknown"."""
    head = bytes(data[:16])
    if head.startswith(b"\x89PNG\r\n\x1a\n"):
        return "PNG"
    if is_jpeg(head):
        return "JPEG"
    if head[:4] == b"RIFF" and head[8:12] == b"WEBP":
        return "WebP"
    for signature, name in _SIGNATURES:
        if head.startswith(signature):
            return name
    return "unknown"


def decode_image(data: bytes, max_side=None) -> np.ndarray:
    """Image bytes -> (H, W, 3) uint8 RGB, equal to PIL's
    ``Image.open(...).convert("RGB")``; an unrecognised file, or a variant
    its decoder does not read, raises a ``ValueError`` that names it.  An
    image whose header declares more than ``max_side`` rows or columns
    raises ``png.FrameTooLarge`` before its data is decoded."""
    kind = image_format(data)
    if kind == "unknown":
        raise ValueError("not a PNG, JPEG, GIF, BMP, TIFF or WebP file "
                         "(unrecognised image format)")
    return _DECODERS[kind](data, max_side)


def make_grid(images: np.ndarray, nrow: int = 8, padding: int = 2,
              pad_value: float = 0.0, scale_each: bool = False) -> np.ndarray:
    """Tile (N, H, W, C) into one (H', W', C) image."""
    images = np.asarray(images, dtype=np.float32)
    n, h, w, c = images.shape
    if scale_each:
        flat = images.reshape(n, -1)
        lo = flat.min(axis=1).reshape(n, 1, 1, 1)
        hi = flat.max(axis=1).reshape(n, 1, 1, 1)
        images = (images - lo) / np.maximum(hi - lo, 1e-5)
    ncols = min(nrow, n)
    nrows = (n + ncols - 1) // ncols
    grid = np.full((padding + nrows * (h + padding),
                    padding + ncols * (w + padding), c), pad_value,
                   np.float32)
    for idx in range(n):
        r, col = divmod(idx, ncols)
        y = padding + r * (h + padding)
        x = padding + col * (w + padding)
        grid[y:y + h, x:x + w] = images[idx]
    return grid


def to_uint8(image: np.ndarray) -> np.ndarray:
    """[0,1] float -> uint8 (the reference's ``(x * 255).to(uint8)``)."""
    image = np.asarray(image)
    if image.dtype == np.uint8:
        return image
    return (np.clip(image, 0.0, 1.0) * 255).astype(np.uint8)


def save_png(image: np.ndarray, path: str) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(to_uint8(image)))


# ----------------------------------------------------------------------
# GIF89a
# ----------------------------------------------------------------------
# The uniform colour cube of the fallback palette: 6 levels of red and
# blue and 7 of green (252 colours), so each channel is off by at most
# half a level: 25.5 (red, blue) and 21.25 (green) of 255.
_CUBE = (6, 7, 6)


def gif_palette(frames: np.ndarray):
    """One global palette for ``frames`` (F, H, W, 3) uint8 and every
    pixel's index in it: the frames' own colours when there are at most
    256 of them (lossless), else the uniform 6x7x6 cube with each channel
    rounded to its nearest level.  Returns (palette (256, 3) uint8,
    indices (F, H, W) uint8)."""
    flat = frames.reshape(-1, 3)
    key = (flat[:, 0].astype(np.int32) << 16 | flat[:, 1].astype(np.int32)
           << 8 | flat[:, 2])
    colours, idx = np.unique(key, return_inverse=True)
    palette = np.zeros((256, 3), np.uint8)
    if len(colours) <= 256:
        palette[:len(colours)] = np.stack(
            [colours >> 16, colours >> 8 & 255, colours & 255], 1)
        return palette, idx.reshape(frames.shape[:3]).astype(np.uint8)
    steps = [255.0 / (n - 1) for n in _CUBE]
    levels = [np.rint(flat[:, c] / steps[c]).astype(np.int32)
              for c in range(3)]
    idx = (levels[0] * _CUBE[1] + levels[1]) * _CUBE[2] + levels[2]
    grid = np.stack(np.meshgrid(*[np.arange(n) for n in _CUBE],
                                indexing="ij"), -1).reshape(-1, 3)
    palette[:len(grid)] = np.rint(grid * np.asarray(steps)).astype(np.uint8)
    return palette, idx.reshape(frames.shape[:3]).astype(np.uint8)


def _lzw(indices: np.ndarray, min_bits: int = 8) -> bytes:
    """GIF's variable-width LZW (LSB-first codes, clear code first, table
    reset when it reaches 4096 codes) of a flat uint8 index stream."""
    clear, eoi = 1 << min_bits, (1 << min_bits) + 1
    out = bytearray()
    acc = nbits = 0
    width = min_bits + 1

    def emit(code):
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += width
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8

    table = {}
    next_code = eoi + 1
    emit(clear)
    data = indices.tobytes()
    prefix = data[0]
    for k in data[1:]:
        key = prefix << 8 | k
        code = table.get(key)
        if code is not None:
            prefix = code
            continue
        emit(prefix)
        if next_code < 4096:
            table[key] = next_code
            next_code += 1
            if next_code > (1 << width) and width < 12:
                width += 1
        else:  # full table: start over
            emit(clear)
            table.clear()
            next_code, width = eoi + 1, min_bits + 1
        prefix = k
    emit(prefix)
    emit(eoi)
    if nbits:
        out.append(acc & 0xFF)
    return bytes(out)


def _sub_blocks(data: bytes) -> bytes:
    parts = [bytes([len(data[i:i + 255])]) + data[i:i + 255]
             for i in range(0, len(data), 255)]
    return b"".join(parts) + b"\x00"


def encode_gif(frames: Sequence[np.ndarray], duration: float = 0.1) -> bytes:
    """An animated, looping GIF89a of (H, W, 3) frames (uint8 or [0, 1]
    float) with one global palette (:func:`gif_palette`) and
    ``duration`` seconds per frame."""
    stack = np.stack([to_uint8(f) for f in frames])
    if stack.ndim != 4 or stack.shape[3] != 3:
        raise ValueError(f"GIF frames must be (H, W, 3), got {stack.shape}")
    n, h, w, _ = stack.shape
    palette, idx = gif_palette(stack)
    delay = int(round(duration * 100))  # hundredths of a second
    out = [b"GIF89a", struct.pack("<HHBBB", w, h, 0xF7, 0, 0),
           palette.tobytes(),
           b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"]  # loop forever
    for i in range(n):
        out.append(b"\x21\xf9\x04\x04" + struct.pack("<H", delay)
                   + b"\x00\x00")
        out.append(b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0))
        out.append(b"\x08" + _sub_blocks(_lzw(idx[i].reshape(-1))))
    out.append(b"\x3b")
    return b"".join(out)


def save_gif(frames: Sequence[np.ndarray], path: str,
             duration: float = 0.1) -> None:
    """Write an animated GIF (the reference's imageio.mimsave fallback)."""
    with open(path, "wb") as f:
        f.write(encode_gif(frames, duration))
