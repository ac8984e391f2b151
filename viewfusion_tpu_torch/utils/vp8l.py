"""A WebP lossless (VP8L) decoder of the port's own (numpy; no PIL), equal
to libwebp's, which Pillow decodes WebP through.

:func:`decode_vp8l` reads a ``VP8L`` chunk's payload and returns its
(H, W) uint32 ARGB pixels; :func:`decode_vp8l_stream` reads a header-less
image stream of a given size (the coded alpha of ``ALPH``).  The format is
RFC 9649's:

* the 5-byte header (signature 0x2f, 14-bit width and height less one,
  the alpha hint and a 3-bit version, which must be 0);
* the four transforms, each at most once, undone in reverse order: the
  predictor (14 modes over blocks of ``1 << bits``; 14 and 15 predict
  black, as libwebp's sentinels do), the colour transform, subtract-green
  and colour indexing (a delta-coded table of up to 256 colours, pixels
  bundled 2, 4 or 8 to a byte below 17, 5 and 3 colours; an index past the
  table is transparent black);
* the colour cache (1 to 11 bits, key ``0x1e35a7bd * argb >> (32 - bits)``),
  meta prefix codes from an entropy image, and per group five canonical
  Huffman codes (green + length + cache, red, blue, alpha, distance), each
  simple (one or two symbols) or sent through code-length codes with
  repeat codes 16 to 18, and complete: a code that is not, or has no
  symbol, raises;
* LZ77 backward references: prefix-coded lengths and distances, the first
  120 distance codes through the 2-D neighbourhood map.

The entropy decoder is plain Python (each code a lookup table indexed by
the next bits, LSB first); the transforms run in numpy, the predictor a
row at a time (its modes that read the left pixel a pixel at a time).
Output is bounded by the header's size, which is checked against
:data:`MAX_PIXELS` before anything is allocated; a malformed or truncated
stream raises a ``ValueError``.
"""

from __future__ import annotations

import array

import numpy as np

from viewfusion_tpu_torch.utils.png import MAX_PIXELS

__all__ = ["decode_vp8l", "decode_vp8l_stream", "vp8l_size"]

_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
# distance codes 1..120 -> (dx, dy) of the 2-D neighbourhood
_PLANE = (
    (0, 1), (1, 0), (1, 1), (-1, 1), (0, 2), (2, 0), (1, 2), (-1, 2),
    (2, 1), (-2, 1), (2, 2), (-2, 2), (0, 3), (3, 0), (1, 3), (-1, 3),
    (3, 1), (-3, 1), (2, 3), (-2, 3), (3, 2), (-3, 2), (0, 4), (4, 0),
    (1, 4), (-1, 4), (4, 1), (-4, 1), (3, 3), (-3, 3), (2, 4), (-2, 4),
    (4, 2), (-4, 2), (0, 5), (3, 4), (-3, 4), (4, 3), (-4, 3), (5, 0),
    (1, 5), (-1, 5), (5, 1), (-5, 1), (2, 5), (-2, 5), (5, 2), (-5, 2),
    (4, 4), (-4, 4), (3, 5), (-3, 5), (5, 3), (-5, 3), (0, 6), (6, 0),
    (1, 6), (-1, 6), (6, 1), (-6, 1), (2, 6), (-2, 6), (6, 2), (-6, 2),
    (4, 5), (-4, 5), (5, 4), (-5, 4), (3, 6), (-3, 6), (6, 3), (-6, 3),
    (0, 7), (7, 0), (1, 7), (-1, 7), (5, 5), (-5, 5), (7, 1), (-7, 1),
    (4, 6), (-4, 6), (6, 4), (-6, 4), (2, 7), (-2, 7), (7, 2), (-7, 2),
    (3, 7), (-3, 7), (7, 3), (-7, 3), (5, 6), (-5, 6), (6, 5), (-6, 5),
    (8, 0), (4, 7), (-4, 7), (7, 4), (-7, 4), (8, 1), (8, 2), (6, 6),
    (-6, 6), (8, 3), (5, 7), (-5, 7), (7, 5), (-7, 5), (8, 4), (6, 7),
    (-6, 7), (7, 6), (-7, 6), (8, 5), (7, 7), (-7, 7), (8, 6), (8, 7))


class _Bits:
    """LSB-first bits of a byte string.  Reading past the end raises."""

    __slots__ = ("data", "pos", "acc", "n")

    def __init__(self, data: bytes, pos: int = 0):
        self.data, self.pos, self.acc, self.n = data, pos, 0, 0

    def fill(self, need: int) -> None:
        """At least ``need`` bits in ``acc`` (zeros past the end)."""
        data, pos = self.data, self.pos
        while self.n < need:
            if pos < len(data):
                self.acc |= data[pos] << self.n
            pos += 1
            self.n += 8
        self.pos = pos

    def read(self, k: int) -> int:
        if self.n < k:
            self.fill(k)
        v = self.acc & ((1 << k) - 1)
        self.acc >>= k
        self.n -= k
        return v

    def check(self) -> None:
        """Raise if more bits were read than the data holds."""
        if 8 * self.pos - self.n > 8 * len(self.data):
            raise ValueError("truncated WebP lossless data")


class _Code:
    """A canonical prefix code, read LSB first through a table indexed by
    the next ``bits`` bits: ``length << 16 | symbol``."""

    __slots__ = ("table", "bits", "single")

    def __init__(self, lengths):
        used = [(n, s) for s, n in enumerate(lengths) if n]
        if not used:
            raise ValueError("corrupt WebP lossless data: a prefix code with "
                             "no symbols")
        if len(used) == 1:  # one symbol: zero bits
            self.single, self.bits, self.table = used[0][1], 0, None
            return
        self.single = -1
        used.sort()
        self.bits = bits = used[-1][0]
        table = [0] * (1 << bits)
        code = prev = 0
        for n, s in used:
            code <<= n - prev
            prev = n
            if code >= 1 << n:
                raise ValueError("corrupt WebP lossless data: a prefix code "
                                 "is over-subscribed")
            rev = int(format(code, f"0{n}b")[::-1], 2)
            table[rev::1 << n] = [n << 16 | s] * (1 << (bits - n))
            code += 1
        if code != 1 << prev:
            raise ValueError("corrupt WebP lossless data: a prefix code is "
                             "not complete")
        self.table = table

    def read(self, br: _Bits) -> int:
        if self.single >= 0:
            return self.single
        if br.n < self.bits:
            br.fill(self.bits)
        e = self.table[br.acc & ((1 << self.bits) - 1)]
        n = e >> 16
        br.acc >>= n
        br.n -= n
        return e & 0xFFFF


def _read_code(br: _Bits, size: int) -> _Code:
    lengths = [0] * size
    if br.read(1):  # simple code: one or two symbols
        count = br.read(1) + 1
        first = br.read(8 if br.read(1) else 1)
        symbols = [first] + ([br.read(8)] if count == 2 else [])
        for s in symbols:
            if s < size:  # libwebp drops a symbol past the alphabet
                lengths[s] = 1
        return _Code(lengths)
    meta = [0] * 19
    for i in range(br.read(4) + 4):
        meta[_ORDER[i]] = br.read(3)
    meta_code = _Code(meta)
    if br.read(1):
        limit = 2 + br.read(2 + 2 * br.read(3))
        if limit > size:
            raise ValueError("corrupt WebP lossless data: more code lengths "
                             "than symbols")
    else:
        limit = size
    sym, prev = 0, 8
    while sym < size:
        if limit == 0:
            break
        limit -= 1
        n = meta_code.read(br)
        if n < 16:
            lengths[sym] = n
            sym += 1
            if n:
                prev = n
            continue
        extra, offset = ((2, 3), (3, 3), (7, 11))[n - 16]
        repeat = br.read(extra) + offset
        if sym + repeat > size:
            raise ValueError("corrupt WebP lossless data: a repeat past the "
                             "alphabet")
        value = prev if n == 16 else 0
        lengths[sym:sym + repeat] = [value] * repeat
        sym += repeat
    br.check()
    return _Code(lengths)


def _prefix_value(br: _Bits, symbol: int) -> int:
    if symbol < 4:
        return symbol + 1
    extra = (symbol - 2) >> 1
    return ((2 + (symbol & 1)) << extra) + br.read(extra) + 1


def _entropy_image(br: _Bits, w: int, h: int, level0: bool) -> np.ndarray:
    """An entropy-coded image of ``w`` x ``h`` (colour cache, meta codes
    where ``level0``, then the pixels): (h * w,) uint32."""
    cache_bits = 0
    if br.read(1):
        cache_bits = br.read(4)
        if not 1 <= cache_bits <= 11:
            raise ValueError(f"corrupt WebP lossless data: colour cache of "
                             f"{cache_bits} bits")
    meta_bits, meta = 0, None
    if level0 and br.read(1):
        meta_bits = br.read(3) + 2
        mw = -(-w // (1 << meta_bits))
        sub = _entropy_image(br, mw, -(-h // (1 << meta_bits)), False)
        meta = ((sub >> 8) & 0xFFFF).astype(np.int64).reshape(-1, mw)
        groups = int(meta.max()) + 1
    else:
        groups = 1
    sizes = (256 + 24 + ((1 << cache_bits) if cache_bits else 0), 256, 256,
             256, 40)
    codes = [[_read_code(br, s) for s in sizes] for _ in range(groups)]
    total = w * h
    out = array.array("I", [0]) * total  # 4 bytes a pixel, as libwebp
    cache = [0] * (1 << cache_bits) if cache_bits else None
    shift = 32 - cache_bits
    mask = (1 << meta_bits) - 1 if meta is not None else -1
    group = codes[0]
    pos = col = row = cached = 0
    while pos < total:
        if col & mask == 0 and meta is not None:
            group = codes[meta[row >> meta_bits, col >> meta_bits]]
        one = group[0].single
        if one >= 0 and (one >= 280 and cache is not None or one < 256 and min(
                c.single for c in group[1:4]) >= 0):
            # codes of one symbol read no bits: the same pixel up to where
            # the group may change (libwebp fills such runs too)
            if one < 256:
                v = (group[3].single << 24 | group[1].single << 16 | one << 8
                     | group[2].single)
            else:
                v = cache[one - 280]
            span = total - pos if meta is None else min(
                w - col, mask + 1 - (col & mask))
            out[pos:pos + span] = array.array("I", [v]) * span
            if cache is not None:
                cache[(0x1E35A7BD * v & 0xFFFFFFFF) >> shift] = v
                cached = pos + span
            pos += span
            row, col = row + (col + span) // w, (col + span) % w
            continue
        green = group[0].read(br)
        if green < 256:  # a literal
            red = group[1].read(br)
            blue = group[2].read(br)
            alpha = group[3].read(br)
            out[pos] = alpha << 24 | red << 16 | green << 8 | blue
            pos += 1
            col += 1
            if col >= w:
                col = 0
                row += 1
                if row & 15 == 0:
                    br.check()
        elif green < 280:  # a backward reference
            length = _prefix_value(br, green - 256)
            code = _prefix_value(br, group[4].read(br))
            if code > 120:
                dist = code - 120
            else:
                dx, dy = _PLANE[code - 1]
                dist = max(dy * w + dx, 1)
            if dist > pos or length > total - pos:
                br.check()
                raise ValueError("corrupt WebP lossless data: a backward "
                                 "reference out of the image")
            if dist >= length:
                out[pos:pos + length] = out[pos - dist:pos - dist + length]
            else:  # overlapping: the last ``dist`` pixels, repeated
                out[pos:pos + length] = (out[pos - dist:pos]
                                         * -(-length // dist))[:length]
            pos += length
            col += length
            while col >= w:
                col -= w
                row += 1
            br.check()
            if meta is not None and col & mask and pos < total:
                group = codes[meta[row >> meta_bits, col >> meta_bits]]
        else:  # a colour cache hit
            if cache is None:
                raise ValueError("corrupt WebP lossless data: a cache code "
                                 "without a cache")
            while cached < pos:
                v = out[cached]
                cache[(0x1E35A7BD * v & 0xFFFFFFFF) >> shift] = v
                cached += 1
            out[pos] = cache[green - 280]
            pos += 1
            col += 1
            if col >= w:
                col = 0
                row += 1
        if cache is not None:
            while cached < pos:
                v = out[cached]
                cache[(0x1E35A7BD * v & 0xFFFFFFFF) >> shift] = v
                cached += 1
    br.check()
    return np.frombuffer(out, np.uint32)


def _add(a, b):
    """Per-channel sum mod 256 of packed ARGB words (ints or uint32
    arrays), libwebp's ``VP8LAddPixels``."""
    return ((((a & 0xFF00FF00) + (b & 0xFF00FF00)) & 0xFF00FF00)
            | (((a & 0x00FF00FF) + (b & 0x00FF00FF)) & 0x00FF00FF))


def _avg(a, b):
    """Per-channel floor average of packed ARGB words (``Average2``)."""
    return (((a ^ b) & 0xFEFEFEFE) >> 1) + (a & b)


def _per_channel(fn, *words) -> int:
    """Apply ``fn`` to each channel of packed ARGB ints; pack the result."""
    out = 0
    for shift in (24, 16, 8, 0):
        out |= fn(*((w >> shift) & 255 for w in words)) << shift
    return out


def _clamp_full(left, top, tl):
    return min(max(left + top - tl, 0), 255)


def _clamp_half(avg, tl):
    diff = avg - tl  # C's division truncates toward zero
    return min(max(avg + (diff // 2 if diff >= 0 else -(-diff // 2)), 0),
               255)


def _predict(mode: int, left: int, top: int, tr: int, tl: int) -> int:
    """Predictors 1, 5-7 and 10-13 (those that read the left pixel) of
    packed ARGB ints."""
    if mode == 1:
        return left
    if mode == 5:
        return _avg(_avg(left, tr), top)
    if mode == 6:
        return _avg(left, tl)
    if mode == 7:
        return _avg(left, top)
    if mode == 10:
        return _avg(_avg(left, tl), _avg(top, tr))
    if mode == 11:  # the one of left and top nearer left + top - tl
        dist = 0
        for shift in (24, 16, 8, 0):
            c = (tl >> shift) & 255
            dist += (abs(((top >> shift) & 255) - c)
                     - abs(((left >> shift) & 255) - c))
        return left if dist < 0 else top
    if mode == 12:
        return _per_channel(_clamp_full, left, top, tl)
    return _per_channel(_clamp_half, _avg(left, top), tl)


def _unpredict(res: np.ndarray, w: int, h: int, bits: int,
               modes: np.ndarray) -> np.ndarray:
    """Undo the predictor transform on packed ARGB residuals (h, w)
    uint32, a row at a time: the modes that read only the row above in
    numpy, those that read the left pixel one pixel at a time."""
    out = np.empty_like(res)
    modes = modes.reshape(-1, -(-w // (1 << bits)))
    row = _add(res[0], np.uint32(0xFF000000))
    for x in range(1, w):  # the first row: black, then left
        row[x] = _add(int(res[0, x]), int(row[x - 1]))
    out[0] = row
    cols = np.arange(w) >> bits
    for y in range(1, h):
        top = out[y - 1]
        first = _add(res[y, :1], top[:1])  # the first column: top
        tr = np.concatenate([top[1:], first])  # the last column: the row's
        tl = np.concatenate([top[:1], top[:-1]])  # first pixel; TL
        mode = modes[y >> bits][cols]
        mode[0] = 2
        pred = np.full(w, 0xFF000000, np.uint32)  # 0, 14, 15: black
        for m, value in ((2, top), (3, tr), (4, tl), (8, _avg(tl, top)),
                         (9, _avg(top, tr))):
            sel = mode == m
            pred[sel] = value[sel]
        line = _add(res[y], pred)
        todo = np.flatnonzero(np.isin(mode, (1, 5, 6, 7, 10, 11, 12, 13)))
        if todo.size:
            lst, rl, ml = line.tolist(), res[y].tolist(), mode.tolist()
            tp, trl, tll = top.tolist(), tr.tolist(), tl.tolist()
            for x in todo.tolist():
                lst[x] = _add(rl[x], _predict(ml[x], lst[x - 1], tp[x],
                                              trl[x], tll[x]))
            line = np.array(lst, np.uint32)
        out[y] = line
    return out


def _signed8(v: np.ndarray) -> np.ndarray:
    return ((v & 255).astype(np.int32) ^ 128) - 128


def _uncolor(px: np.ndarray, w: int, bits: int, sub: np.ndarray):
    """Undo the colour transform on packed ARGB (h, w) uint32."""
    h = px.shape[0]
    m = sub.reshape(-1, -(-w // (1 << bits)))[
        np.arange(h)[:, None] >> bits, np.arange(w)[None, :] >> bits]
    green = _signed8(px >> 8)
    red = ((px >> 16).astype(np.int32) + ((_signed8(m) * green) >> 5)) & 255
    blue = ((px & 255).astype(np.int32) + ((_signed8(m >> 8) * green) >> 5)
            + ((_signed8(m >> 16) * _signed8(red)) >> 5)) & 255
    return (px & 0xFF00FF00) | (red.astype(np.uint32) << 16) | \
        blue.astype(np.uint32)


def _stream(br: _Bits, w: int, h: int) -> np.ndarray:
    """A transformed image stream of ``w`` x ``h`` -> (h, w) uint32 ARGB."""
    transforms = []
    xsize = w
    while br.read(1):
        kind = br.read(2)
        if any(t[0] == kind for t in transforms):
            raise ValueError(f"corrupt WebP lossless data: transform {kind} "
                             "twice")
        if kind in (0, 1):  # predictor, colour: a sub-image of blocks
            bits = br.read(3) + 2
            sub = _entropy_image(br, -(-xsize // (1 << bits)),
                                 -(-h // (1 << bits)), False)
            transforms.append((kind, xsize, bits, sub))
        elif kind == 2:
            transforms.append((kind, xsize, 0, None))
        else:  # colour indexing
            n = br.read(8) + 1
            bits = 0 if n > 16 else 1 if n > 4 else 2 if n > 2 else 3
            table = _entropy_image(br, n, 1, False)
            for i in range(1, n):  # delta-coded, channel by channel
                table[i] = _add(int(table[i]), int(table[i - 1]))
            full = np.zeros(256, np.uint32)  # past the table: 0
            full[:n] = table
            transforms.append((kind, xsize, bits, full))
            xsize = -(-xsize // (1 << bits))
    px = _entropy_image(br, xsize, h, True).reshape(h, xsize)
    for kind, tw, bits, arg in reversed(transforms):
        if kind == 0:
            px = _unpredict(px, tw, h, bits, (arg >> 8) & 15)
        elif kind == 1:
            px = _uncolor(px, tw, bits, arg)
        elif kind == 2:  # add green to red and blue
            green = (px >> 8) & 255
            px = _add(px, green << 16 | green)
        else:
            idx = (px >> 8) & 255
            if bits:
                width = 8 >> bits
                shifts = (np.arange(1 << bits) * width).astype(np.uint32)
                idx = ((idx[..., None] >> shifts) & ((1 << width) - 1))
                idx = idx.reshape(h, -1)[:, :tw]
            px = arg[idx]
    return px


def vp8l_size(data: bytes):
    """(width, height) of a VP8L payload's header."""
    if len(data) < 5 or data[0] != 0x2F:
        raise ValueError("not a WebP lossless (VP8L) stream")
    bits = int.from_bytes(data[1:5], "little")
    if bits >> 29:
        raise ValueError(f"WebP lossless version {bits >> 29} is not "
                         "supported")
    return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1


def decode_vp8l(data: bytes) -> np.ndarray:
    """A VP8L payload -> (H, W) uint32 ARGB."""
    w, h = vp8l_size(data)
    if w * h > MAX_PIXELS:
        raise ValueError(f"WebP image of {w}x{h} = {w * h} pixels is over "
                         f"the limit of {MAX_PIXELS}")
    br = _Bits(bytes(data), 5)
    return _stream(br, w, h)


def decode_vp8l_stream(data: bytes, w: int, h: int) -> np.ndarray:
    """A header-less VP8L image stream of ``w`` x ``h`` -> (H, W) uint32
    ARGB."""
    return _stream(_Bits(bytes(data)), w, h)
