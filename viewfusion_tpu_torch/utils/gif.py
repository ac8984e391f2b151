"""A GIF decoder of the port's own (numpy; no PIL), equal to Pillow's.

:func:`decode_gif` reads the first frame of a GIF87a or GIF89a file and
returns (H, W, 3) uint8 equal to ``Image.open(...).convert("RGB")``:

* the canvas is the logical screen, grown to hold the first frame if the
  frame reaches past it (Pillow grows it too);
* the frame's colours come from its local colour table, else the global
  one (also where the local table is the gray ramp 0, 1, 2, ..., which
  Pillow drops); with neither, or a global gray ramp, an index is its own
  gray level (mode "L");
* outside the first frame's rectangle the canvas holds index 0, or the
  transparency index of the frame's graphic control extension; the
  transparency index is otherwise an ordinary colour (``convert("RGB")``
  ignores it);
* an index past the end of the colour table is black;
* interlaced frames are written in the four passes' row order.

LZW codes of 2 to 8 bits (Pillow takes 1 as well), clear and end codes,
and a full 4096-entry table (no more entries until the next clear) are
read.  A file that ends, or whose end code comes, before the frame is
full, a code past the table, and any other malformed file raise a
``ValueError``, as does a canvas of more than :data:`MAX_PIXELS` pixels
(before anything is allocated).
"""

from __future__ import annotations

import struct

import numpy as np

from viewfusion_tpu_torch.utils.png import MAX_PIXELS, check_side

__all__ = ["decode_gif"]

# interlaced rows: (first row, step) of the four passes
_PASSES = ((0, 8), (4, 8), (2, 4), (1, 2))


def _table(data: bytes, pos: int, flags: int):
    """A colour table after a header or image descriptor: (palette
    (n, 3) uint8, None if there is none or False if it is a gray ramp,
    position after it)."""
    if not flags & 0x80:
        return None, pos
    n = 2 << (flags & 7)
    if pos + 3 * n > len(data):
        raise ValueError("truncated GIF file: a colour table is cut short")
    table = np.frombuffer(data, np.uint8, 3 * n, pos).reshape(n, 3)
    if (table == np.arange(n)[:, None]).all():
        table = False  # a gray ramp: Pillow drops it and reads mode "L"
    return table, pos + 3 * n


def _lzw(data: bytes, pos: int, min_bits: int, count: int):
    """The frame's sub-blocks from ``pos`` -> ``count`` indices (bytes);
    decoding stops once the frame is full."""
    blocks = []
    while True:
        if pos >= len(data):
            raise ValueError("truncated GIF file: the image data is cut "
                             "short")
        n = data[pos]
        if n == 0:
            break
        blocks.append(data[pos + 1:pos + 1 + n])
        pos += 1 + n
    stream = b"".join(blocks)
    clear, end = 1 << min_bits, (1 << min_bits) + 1
    # each code's string; clear and end hold places in the table
    literals = [bytes((i & 0xFF,)) for i in range(clear)] + [b"", b""]
    table = list(literals)
    out = bytearray()
    width, prev = min_bits + 1, None
    acc = nbits = at = 0
    nstream = len(stream)
    while len(out) < count:
        while nbits < width:
            if at >= nstream:
                raise ValueError("truncated GIF file: the image data ends "
                                 "before the frame is full")
            acc |= stream[at] << nbits
            at += 1
            nbits += 8
        code = acc & ((1 << width) - 1)
        acc >>= width
        nbits -= width
        if code == clear:
            table, width, prev = list(literals), min_bits + 1, None
            continue
        if code == end:
            raise ValueError("truncated GIF file: the end code comes before "
                             "the frame is full")
        if prev is None:
            if code >= clear:
                raise ValueError(f"corrupt GIF data: code {code} past the "
                                 "table")
            prev = table[code]
            out += prev
            continue
        nxt = len(table)
        if code < nxt:
            string = table[code]
        elif code == nxt < 4096:  # the string about to be added
            string = prev + prev[:1]
        else:
            raise ValueError(f"corrupt GIF data: code {code} past the "
                             f"table of {nxt}")
        if nxt < 4096:  # a full table takes no more entries
            table.append(prev + string[:1])
            if nxt + 1 == 1 << width and width < 12:
                width += 1
        out += string
        prev = string
    return bytes(out[:count])


def decode_gif(data: bytes, max_side=None) -> np.ndarray:
    """GIF bytes -> (H, W, 3) uint8 RGB of the first frame (see the module
    docstring)."""
    data = bytes(data)
    if data[:6] not in (b"GIF87a", b"GIF89a"):
        raise ValueError("not a GIF file")
    if len(data) < 13:
        raise ValueError("truncated GIF file: the header is cut short")
    width, height, flags = struct.unpack("<HHB", data[6:11])
    glob, pos = _table(data, 13, flags)
    transparency = None
    while True:
        if pos >= len(data) or data[pos] == 0x3B:
            raise ValueError("GIF file holds no image")
        kind = data[pos]
        pos += 1
        if kind == 0x21:  # extension: a label, then sub-blocks
            if pos >= len(data):
                raise ValueError("truncated GIF file: an extension is cut "
                                 "short")
            label = data[pos]
            pos += 1
            first = True
            while True:
                if pos >= len(data):
                    raise ValueError("truncated GIF file: an extension is "
                                     "cut short")
                n = data[pos]
                if n == 0:
                    pos += 1
                    break
                block = data[pos + 1:pos + 1 + n]
                if len(block) < n:
                    raise ValueError("truncated GIF file: an extension is "
                                     "cut short")
                if first and label == 0xF9 and len(block) >= 4 \
                        and block[0] & 1:
                    transparency = block[3]
                first = False
                pos += 1 + n
        elif kind == 0x2C:  # image descriptor
            if pos + 10 > len(data):
                raise ValueError("truncated GIF file: an image descriptor "
                                 "is cut short")
            x0, y0, fw, fh, fflags = struct.unpack("<HHHHB",
                                                   data[pos:pos + 9])
            local, pos = _table(data, pos + 9, fflags)
            break
        # any other byte is skipped, as Pillow skips it
    width, height = max(width, x0 + fw), max(height, y0 + fh)
    if width * height > MAX_PIXELS:
        raise ValueError(f"GIF image of {width}x{height} = "
                         f"{width * height} pixels is over the limit of "
                         f"{MAX_PIXELS}")
    check_side(width, height, max_side)
    if width == 0 or height == 0:
        raise ValueError(f"GIF image of {width}x{height} has no pixels")
    if pos >= len(data):
        raise ValueError("truncated GIF file: the image data is cut short")
    min_bits = data[pos]
    if not 1 <= min_bits <= 8:
        raise ValueError(f"GIF LZW code size {min_bits} is not supported "
                         "(1 to 8 bits)")
    idx = np.frombuffer(_lzw(data, pos + 1, min_bits, fw * fh),
                        np.uint8).reshape(fh, fw)
    if fflags & 0x40:  # interlaced: the file's rows in pass order
        order = np.concatenate([np.arange(r, fh, s) for r, s in _PASSES])
        frame = np.empty_like(idx)
        frame[order] = idx
        idx = frame
    canvas = np.full((height, width), transparency or 0, np.uint8)
    canvas[y0:y0 + fh, x0:x0 + fw] = idx
    # a local gray ramp still gives way to a global table (Pillow keeps the
    # global one as the image's palette)
    palette = glob if local is None or local is False else local
    if palette is None or palette is False:  # mode "L": index = gray
        return np.repeat(canvas[..., None], 3, axis=2)
    full = np.zeros((256, 3), np.uint8)  # past the table: black
    full[:len(palette)] = palette
    return full[canvas]
