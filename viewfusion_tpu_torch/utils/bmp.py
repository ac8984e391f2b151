"""A BMP decoder of the port's own (numpy; no PIL), equal to Pillow's.

:func:`decode_bmp` reads what Pillow's ``BmpImagePlugin`` opens and
returns (H, W, 3) uint8 equal to ``Image.open(...).convert("RGB")``:

* info headers of 12 (OS/2 1.x), 40, 52, 56, 64, 108 and 124 bytes, rows
  bottom-up, or top-down where the height's top byte is 0xFF (Pillow's
  test, not the sign);
* palette images at 1, 4 and 8 bits, the table sized by ``biClrUsed``
  (else ``1 << bits``) and read from the end of the header; an index past
  the table is black.  A table that is a gray ramp (0 and 255 for two
  colours) makes Pillow read the rows as mode "1" (two colours) or "L" at
  their bit widths, whatever the file's depth, and so does this;
* 16 bits as 5-5-5, or under ``BI_BITFIELDS`` 5-6-5 or 5-5-5, each field
  widened as Pillow's unpackers do (``v * 255 // 31`` and
  ``v * 255 // 63``); 24 bits; 32 bits as BGRX, or under bitfields one of
  the eight byte layouts Pillow knows (alpha dropped, not applied);
* RLE8 and RLE4 as Pillow's ``BmpRleDecoder`` reads them: pixels that
  end-of-line and delta codes skip are index 0, runs are clipped at the
  row's end, absolute runs are padded to even file offsets, and a delta
  code takes the two bytes after the two it names (Pillow reads four).
  No code adds pixels past the image's end, however far it skips.

Other depths, compressions and bitfield layouts, malformed or truncated
files, and images of more than :data:`MAX_PIXELS` pixels (checked before
anything is allocated) raise a ``ValueError`` naming the cause.
"""

from __future__ import annotations

import struct

import numpy as np

from viewfusion_tpu_torch.utils.png import MAX_PIXELS, check_side

__all__ = ["decode_bmp"]

_HEADERS = (12, 40, 52, 56, 64, 108, 124)
# 32-bit bitfield masks (r, g, b, a) -> the bytes of R, G and B in a pixel
_MASKS32 = {
    (0xFF0000, 0xFF00, 0xFF, 0): (2, 1, 0),  # BGRX
    (0xFF000000, 0xFF0000, 0xFF00, 0): (3, 2, 1),  # XBGR
    (0xFF000000, 0xFF00, 0xFF, 0): (3, 1, 0),  # BGXR
    (0xFF000000, 0xFF0000, 0xFF00, 0xFF): (3, 2, 1),  # ABGR
    (0xFF, 0xFF00, 0xFF0000, 0xFF000000): (0, 1, 2),  # RGBA
    (0xFF0000, 0xFF00, 0xFF, 0xFF000000): (2, 1, 0),  # BGRA
    (0xFF000000, 0xFF00, 0xFF, 0xFF0000): (3, 1, 0),  # BGAR
    (0, 0, 0, 0): (2, 1, 0),  # BGRA
}
_MASKS16 = {(0xF800, 0x7E0, 0x1F): 6, (0x7C00, 0x3E0, 0x1F): 5}  # green bits


def _rle(data: bytes, pos: int, w: int, h: int, rle4: bool) -> np.ndarray:
    """Pillow's ``BmpRleDecoder`` from file offset ``pos``: (h, w) uint8
    indices in file row order."""
    out = bytearray()
    need, x, n = w * h, 0, len(data)
    while len(out) < need:
        if pos + 2 > n:
            break
        count, byte = data[pos], data[pos + 1]
        pos += 2
        if count:  # a run, clipped at the row's end
            count = min(count, max(0, w - x))
            if rle4:
                pair = bytes((byte >> 4, byte & 15))
                out += (pair * (count // 2 + 1))[:count]
            else:
                out += bytes((byte,)) * count
            x += count
        elif byte == 0:  # end of line: the rest of the row is index 0
            out += bytes(min(-len(out) % w, need - len(out)))
            x = 0
        elif byte == 1:  # end of bitmap
            break
        elif byte == 2:  # delta: Pillow skips two bytes and reads two more
            if pos + 2 > n:
                break
            if pos + 4 > n:
                raise ValueError("truncated BMP file: an RLE delta is cut "
                                 "short")
            right, up = data[pos + 2], data[pos + 3]
            pos += 4
            out += bytes(min(right + up * w, need - len(out)))
            x = len(out) % w
        else:  # an absolute run of ``byte`` pixels
            size = byte // 2 if rle4 else byte
            chunk = data[pos:pos + size]
            pos += len(chunk)
            if rle4:
                out += bytes(v for b in chunk for v in (b >> 4, b & 15))
            else:
                out += chunk
            if len(chunk) < size:
                break
            x += byte
            pos += pos % 2
    if len(out) < need:
        raise ValueError("truncated BMP file: the RLE data ends before the "
                         "image is full")
    return np.frombuffer(bytes(out[:need]), np.uint8).reshape(h, w)


def _rows(data: bytes, offset: int, h: int, stride: int,
          row_bytes: int) -> np.ndarray:
    """(h, row_bytes) uint8 of rows ``stride`` bytes apart from
    ``offset`` (the last row needs no padding)."""
    if row_bytes > stride:
        raise ValueError("corrupt BMP file: its rows are narrower than its "
                         "pixels")
    if offset + (h - 1) * stride + row_bytes > len(data):
        raise ValueError("truncated BMP file: the pixel data is cut short")
    return np.lib.stride_tricks.as_strided(
        np.frombuffer(data, np.uint8, offset=offset), (h, row_bytes),
        (stride, 1))


def _unpack_bits(rows: np.ndarray, w: int, bits: int) -> np.ndarray:
    """MSB-first packed 1- or 4-bit samples -> (h, w) uint8."""
    if bits == 8:
        return rows[:, :w]
    if bits == 4:
        return np.stack([rows >> 4, rows & 15], 2).reshape(len(rows), -1)[
            :, :w]
    return np.unpackbits(rows, axis=1)[:, :w]


def decode_bmp(data: bytes, max_side=None) -> np.ndarray:
    """BMP bytes -> (H, W, 3) uint8 RGB (see the module docstring)."""
    data = bytes(data)
    if data[:2] != b"BM":
        raise ValueError("not a BMP file")
    if len(data) < 18:
        raise ValueError("truncated BMP file: the header is cut short")
    offset, size = struct.unpack("<I", data[10:14])[0], struct.unpack(
        "<I", data[14:18])[0]
    if size not in _HEADERS:
        raise ValueError(f"BMP info header of {size} bytes is not supported "
                         f"({', '.join(map(str, _HEADERS))})")
    if len(data) < 14 + size:
        raise ValueError("truncated BMP file: the info header is cut short")
    pos = 14 + size
    top_down, masks = False, None
    if size == 12:
        w, h, _, bits = struct.unpack("<HHHH", data[18:26])
        compression, colors, pad = 0, 0, 3
    else:
        w, h, _, bits, compression, _, _, _, colors = struct.unpack(
            "<IIHHIIIII", data[18:50])
        if data[25] == 0xFF:  # Pillow's top-down test: the top byte
            top_down, h = True, 2 ** 32 - h
        pad = 4
        if compression == 3:  # BI_BITFIELDS
            if size >= 52:
                n = 4 if size >= 56 else 3
                masks = struct.unpack(f"<{n}I", data[54:54 + 4 * n])
            else:
                if len(data) < pos + 12:
                    raise ValueError("truncated BMP file: the bitfield "
                                     "masks are cut short")
                masks = struct.unpack("<3I", data[pos:pos + 12])
                pos += 12
            masks = tuple(masks) + (0,) * (4 - len(masks))
    if w * h > MAX_PIXELS:
        raise ValueError(f"BMP image of {w}x{h} = {w * h} pixels is over "
                         f"the limit of {MAX_PIXELS}")
    check_side(w, h, max_side)
    if w == 0 or h == 0:
        raise ValueError(f"BMP image of {w}x{h} has no pixels")
    if bits not in (1, 4, 8, 16, 24, 32):
        raise ValueError(f"BMP pixel depth {bits} is not supported")
    colors = colors or 1 << bits
    if offset == 14 + size and bits <= 8:
        offset += 4 * colors  # Pillow: pixels after the table, not at it
    if compression == 3:
        if not (masks in _MASKS32 if bits == 32 else
                masks[:3] in _MASKS16 if bits == 16 else
                bits == 24 and masks[:3] == (0xFF0000, 0xFF00, 0xFF)):
            raise ValueError(f"BMP bitfields layout {masks} at {bits} bits "
                             "is not supported")
    elif compression in (1, 2):
        if bits > 8:
            raise ValueError(f"BMP RLE at {bits} bits is not supported")
    elif compression:
        name = {4: "JPEG", 5: "PNG"}.get(compression, compression)
        raise ValueError(f"BMP compression {name} is not supported")
    stride = ((w * bits + 31) >> 3) & ~3
    if bits <= 8:
        if not 0 < colors <= 65536:
            raise ValueError(f"BMP palette of {colors} colours is not "
                             "supported")
        table = np.frombuffer(data[pos:pos + pad * colors], np.uint8)
        table = table[:len(table) // pad * pad].reshape(-1, pad)[:, 2::-1]
        ramp = np.array([0, 255]) if colors == 2 else np.arange(colors)
        gray = len(table) == colors and (table == ramp[:, None]).all()
        if not gray and len(table) > 256:
            raise ValueError(f"BMP palette of {len(table)} colours is over "
                             "256")
        if compression in (1, 2):
            if gray and colors == 2:
                raise ValueError("an RLE BMP of a black and white palette "
                                 "(Pillow's mode \"1\") is not supported")
            idx = _rle(data, offset, w, h, compression == 2)
        else:  # a gray ramp: Pillow reads the rows as "1" or "L" pixels
            depth = (1 if colors == 2 else 8) if gray else bits
            idx = _unpack_bits(_rows(data, offset, h, stride,
                                     (w * depth + 7) // 8), w, depth)
            if gray and colors == 2:
                idx = idx * np.uint8(255)
        if gray:
            rgb = np.repeat(idx[..., None], 3, axis=2)
        else:
            full = np.zeros((256, 3), np.uint8)
            full[:len(table)] = table
            rgb = full[idx]
    else:
        px = _rows(data, offset, h, stride, w * bits // 8).reshape(
            h, w, bits // 8)
        if bits == 16:
            v = px[..., 0].astype(np.uint32) | px[..., 1].astype(
                np.uint32) << 8
            green = _MASKS16[masks[:3]] if masks else 5
            r = (v >> (5 + green)) & 31
            g = (v >> 5) & ((1 << green) - 1)
            b = v & 31
            rgb = np.stack([r * 255 // 31, g * 255 // ((1 << green) - 1),
                            b * 255 // 31], 2).astype(np.uint8)
        elif bits == 24:
            rgb = px[..., ::-1]
        else:
            rgb = px[..., list(_MASKS32[masks] if masks else (2, 1, 0))]
    if not top_down:
        rgb = rgb[::-1]
    return np.ascontiguousarray(rgb)
