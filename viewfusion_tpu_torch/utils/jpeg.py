"""A JPEG decoder of the port's own (numpy; no PIL), equal to Pillow's.

:func:`decode_jpeg` reads baseline, extended-sequential and progressive
Huffman-coded JPEGs with 8-bit samples and one (gray) or three (YCbCr, or
RGB under an Adobe marker with transform 0) components, any integral
sampling (4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1 ...), restart intervals and
any size, and returns (H, W, 3) uint8 equal, bit for bit, to
``Image.open(...).convert("RGB")``.

Pillow decodes through libjpeg-turbo with its defaults, so this module
copies libjpeg-turbo's arithmetic (not its structure):

* ``jidctint.c``'s islow inverse DCT: ``CONST_BITS`` 13, ``PASS1_BITS``
  2, 64-bit intermediates, and the post-IDCT ``range_limit`` table indexed
  with ``& RANGE_MASK`` (a wrap-around, not a plain clamp, for values far
  out of range);
* ``jdsample.c``'s fancy upsampling: h2v1 is the triangle filter with the
  biases 1 and 2 alternating, h2v2 the same over context rows with the
  biases 8 and 7, h1v2 its vertical form with 1 and 2, edge columns and
  rows replicated (rows through ``jdmainct.c``'s context pointers); h2v1
  and h2v2 fall back to box replication when the subsampled width is 2 or
  less, and other integral ratios always take ``int_upsample``'s box;
* ``jdcolor.c``'s fixed-point YCbCr -> RGB tables (``SCALEBITS`` 16).

A progressive file is held to the end of its last scan before output, as
libjpeg does.  libjpeg then block-smooths only a file whose scans leave
some of the first nine AC coefficients incomplete (every encoder's
standard script completes them, Pillow's too); such a file raises here.  The entropy decoder is plain Python
(a 9-bit lookup table per Huffman table for the short codes); the IDCT, upsampling and colour
conversion run vectorised over all blocks in int64.

Arithmetic coding, lossless and hierarchical JPEGs, samples other than 8
bits, and CMYK or YCCK (four components) raise a ``ValueError`` naming
the variant.  So does any malformed or truncated file, and a frame of more
than :data:`MAX_PIXELS` pixels, which PIL refuses too
(``DecompressionBombError``); the frame header is checked before anything
is allocated, and the coefficients take 4 bytes each in a zeroed numpy
array whose pages are touched only as the scans fill them.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional

import numpy as np

from viewfusion_tpu_torch.utils.png import MAX_PIXELS, check_side

__all__ = ["decode_jpeg", "is_jpeg"]

# zigzag index -> natural (row-major) index
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
_NATURAL = _ZIGZAG.tolist()

_SOF_VARIANTS = {
    0xC3: "lossless", 0xC5: "hierarchical (differential sequential)",
    0xC6: "hierarchical (differential progressive)",
    0xC7: "hierarchical (differential lossless)",
    0xC9: "arithmetic-coded (extended sequential)",
    0xCA: "arithmetic-coded (progressive)",
    0xCB: "arithmetic-coded (lossless)",
    0xCD: "arithmetic-coded (differential sequential)",
    0xCE: "arithmetic-coded (differential progressive)",
    0xCF: "arithmetic-coded (differential lossless)",
}


def is_jpeg(data: bytes) -> bool:
    return bytes(data[:3]) == b"\xff\xd8\xff"


# ----------------------------------------------------------------------
# entropy decoding
# ----------------------------------------------------------------------
_FAST = 9  # codes up to this length decode with one table lookup


class _Huffman:
    """A canonical Huffman table: ``look`` maps the next ``_FAST`` bits to
    ``length << 8 | symbol`` for the short codes (0 elsewhere); longer
    codes go through libjpeg's ``maxcode``/``valptr`` per length."""

    __slots__ = ("look", "maxcode", "mincode", "valptr", "vals")

    def __init__(self, counts: List[int], symbols: bytes):
        self.look = [0] * (1 << _FAST)
        self.maxcode = [-1] * 17
        self.mincode = [0] * 17
        self.valptr = [0] * 17
        self.vals = list(symbols)
        code = k = 0
        for length in range(1, 17):
            self.valptr[length], self.mincode[length] = k, code
            for _ in range(counts[length - 1]):
                if code >= 1 << length:
                    raise ValueError("corrupt JPEG data: bad Huffman table")
                if length <= _FAST:
                    start = code << (_FAST - length)
                    self.look[start:start + (1 << (_FAST - length))] = \
                        [length << 8 | symbols[k]] * (1 << (_FAST - length))
                code += 1
                k += 1
            if counts[length - 1]:
                self.maxcode[length] = code - 1
            code <<= 1


class _Bits:
    """MSB-first bits of one restart interval's entropy-coded data, byte
    stuffing removed.  Eight zero bytes follow the data so that a lookup
    may read ahead; ``_decode_scan`` treats a read that consumes bits past
    ``end`` as truncated data."""

    __slots__ = ("d", "pos", "end")

    def __init__(self, data: bytes):
        self.d = data + b"\0" * 8
        self.pos = 0
        self.end = 8 * len(data)

    def huff(self, t: _Huffman) -> int:
        p, d = self.pos, self.d
        i = p >> 3
        # 24 bits from the current position, at least 17 of them valid
        w = ((d[i] << 16 | d[i + 1] << 8 | d[i + 2]) << (p & 7)) & 0xFFFFFF
        e = t.look[w >> (24 - _FAST)]
        if e:
            self.pos = p + (e >> 8)
            return e & 0xFF
        for length in range(_FAST + 1, 17):
            code = w >> (24 - length)
            if code <= t.maxcode[length]:
                self.pos = p + length
                return t.vals[t.valptr[length] + code - t.mincode[length]]
        raise ValueError("corrupt JPEG data: bad Huffman code")

    def bits(self, n: int) -> int:
        if not n:
            return 0
        p, d = self.pos, self.d
        i = p >> 3
        self.pos = p + n
        return ((d[i] << 16 | d[i + 1] << 8 | d[i + 2])
                >> (24 - n - (p & 7))) & ((1 << n) - 1)

    def extend(self, s: int) -> int:
        """RECEIVE and EXTEND of ``s`` bits (T.81 F.2.2.1)."""
        v = self.bits(s)
        return v - (1 << s) + 1 if s and v < 1 << (s - 1) else v


class _Component:
    def __init__(self, cid: int, h: int, v: int, tq: int):
        self.id, self.h, self.v, self.tq = cid, h, v, tq
        self.quant: Optional[np.ndarray] = None
        self.dc_pred = 0
        # libjpeg's coef_bits: the Al each coefficient was last coded at
        # in a progressive file (-1: never)
        self.coef_bits = [-1] * 64


def _decode_block_baseline(bits, comp, dc, ac, coef, base):
    s = bits.huff(dc)
    comp.dc_pred += bits.extend(s)
    coef[base] = comp.dc_pred
    k = 1
    while k < 64:
        rs = bits.huff(ac)
        r, s = rs >> 4, rs & 15
        if s:
            k += r
            if k > 63:
                raise ValueError("corrupt JPEG data: AC run past the block")
            coef[base + _NATURAL[k]] = bits.extend(s)
            k += 1
        elif r == 15:
            k += 16
        else:
            break


class _Scan:
    """One SOS: its components, tables and spectral/approximation
    parameters."""

    def __init__(self, comps, tables, ss, se, ah, al):
        self.comps, self.tables = comps, tables
        self.ss, self.se, self.ah, self.al = ss, se, ah, al
        self.eobrun = 0


def _units(scan: _Scan, frame, first: int, stop: int):
    """The coded units ``first`` .. ``stop - 1`` of a scan, each a list of
    (component, offset of its block's coefficients): one block of a
    non-interleaved scan, or the blocks of one MCU of an interleaved
    one."""
    comps = scan.comps
    if len(comps) == 1:
        c = comps[0]
        bw = -(-c.dw // 8)
        for u in range(first, stop):
            y, x = divmod(u, bw)
            yield [(c, (y * c.nbx + x) * 64)]
        return
    # each component's blocks in an MCU, as offsets from the MCU's first
    layout = [(c, [(j * c.nbx + i) * 64 for j in range(c.v)
                   for i in range(c.h)]) for c in comps]
    for u in range(first, stop):
        my, mx = divmod(u, frame["mcux"])
        yield [(c, (my * c.v * c.nbx + mx * c.h) * 64 + o)
               for c, offsets in layout for o in offsets]


def _decode_scan(scan: _Scan, frame, segments: List[bytes],
                 restart: int) -> None:
    comps = scan.comps
    progressive = frame["progressive"]
    if len(comps) == 1:
        c = comps[0]
        total = -(-c.dw // 8) * -(-c.dh // 8)
    else:
        total = frame["mcux"] * frame["mcuy"]
    per = restart or total
    expected = -(-total // per)
    if len(segments) < expected:
        raise ValueError(f"corrupt JPEG data: {len(segments)} restart "
                         f"intervals where {expected} are needed")
    for seg_index in range(expected):
        bits = _Bits(segments[seg_index])
        for c in comps:
            c.dc_pred = 0
        scan.eobrun = 0
        first = seg_index * per
        try:
            for mcu in _units(scan, frame, first, min(first + per, total)):
                for c, base in mcu:
                    dc, ac = scan.tables[c.id]
                    coef = c.coef
                    if not progressive:
                        _decode_block_baseline(bits, c, dc, ac, coef, base)
                    elif scan.ss == 0:
                        if scan.ah == 0:
                            s = bits.huff(dc)
                            c.dc_pred += bits.extend(s)
                            coef[base] = c.dc_pred << scan.al
                        elif bits.bits(1):
                            coef[base] |= 1 << scan.al
                    elif scan.ah == 0:
                        _ac_first(bits, scan, ac, coef, base)
                    else:
                        _ac_refine(bits, scan, ac, coef, base)
                if bits.pos > bits.end:
                    break
        except IndexError:  # read past the look-ahead zeros
            bits.pos = bits.end + 1
        if bits.pos > bits.end:
            raise ValueError("truncated JPEG data: a scan's entropy-coded "
                             "data ends before its last block")


def _ac_first(bits, scan, ac, coef, base) -> None:
    """libjpeg's decode_mcu_AC_first."""
    if scan.eobrun > 0:
        scan.eobrun -= 1
        return
    k, se, al = scan.ss, scan.se, scan.al
    while k <= se:
        rs = bits.huff(ac)
        r, s = rs >> 4, rs & 15
        if s:
            k += r
            if k > 63:
                raise ValueError("corrupt JPEG data: AC run past the block")
            coef[base + _NATURAL[k]] = bits.extend(s) << al
        elif r == 15:
            k += 15
        else:
            scan.eobrun = (1 << r) + bits.bits(r) - 1
            break
        k += 1


def _ac_refine(bits, scan, ac, coef, base) -> None:
    """libjpeg's decode_mcu_AC_refine: a correction bit for every
    coefficient already nonzero, newly nonzero ones of +-1 << Al."""
    k, se = scan.ss, scan.se
    p1 = 1 << scan.al
    m1 = -p1
    if scan.eobrun == 0:
        while k <= se:
            rs = bits.huff(ac)
            r, s = rs >> 4, rs & 15
            if s:
                if s != 1:
                    raise ValueError("corrupt JPEG data: a refinement "
                                     "coefficient of size other than 1")
                s = p1 if bits.bits(1) else m1
            elif r != 15:
                scan.eobrun = (1 << r) + bits.bits(r)
                break
            while k <= se:
                pos = base + _NATURAL[k]
                if coef[pos]:
                    if bits.bits(1) and not coef[pos] & p1:
                        coef[pos] += p1 if coef[pos] >= 0 else m1
                else:
                    r -= 1
                    if r < 0:
                        break
                k += 1
            if s:
                if k > 63:
                    raise ValueError("corrupt JPEG data: AC run past the "
                                     "block")
                coef[base + _NATURAL[k]] = s
            k += 1
    if scan.eobrun > 0:
        while k <= se:
            pos = base + _NATURAL[k]
            if coef[pos] and bits.bits(1) and not coef[pos] & p1:
                coef[pos] += p1 if coef[pos] >= 0 else m1
            k += 1
        scan.eobrun -= 1


# ----------------------------------------------------------------------
# islow IDCT (jidctint.c)
# ----------------------------------------------------------------------
_CONST_BITS, _PASS1_BITS = 13, 2
_F0298, _F0390, _F0541, _F0765 = 2446, 3196, 4433, 6270
_F0899, _F1175, _F1501, _F1847 = 7373, 9633, 12299, 15137
_F1961, _F2053, _F2562, _F3072 = 16069, 16819, 20995, 25172


def _idct_1d(x):
    """One 1-D islow pass over index 0..7 of ``x`` (a list of int64
    arrays): the eight sums before descaling, in output order."""
    z1 = (x[2] + x[6]) * _F0541
    tmp2 = z1 - x[6] * _F1847
    tmp3 = z1 + x[2] * _F0765
    tmp0 = (x[0] + x[4]) << _CONST_BITS
    tmp1 = (x[0] - x[4]) << _CONST_BITS
    t10, t13 = tmp0 + tmp3, tmp0 - tmp3
    t11, t12 = tmp1 + tmp2, tmp1 - tmp2
    o0, o1, o2, o3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = o0 + o3, o1 + o2, o0 + o2, o1 + o3
    z5 = (z3 + z4) * _F1175
    o0 = o0 * _F0298
    o1 = o1 * _F2053
    o2 = o2 * _F3072
    o3 = o3 * _F1501
    z1 = z1 * -_F0899
    z2 = z2 * -_F2562
    z3 = z3 * -_F1961 + z5
    z4 = z4 * -_F0390 + z5
    o0 += z1 + z3
    o1 += z2 + z4
    o2 += z2 + z3
    o3 += z1 + z4
    return [t10 + o3, t11 + o2, t12 + o1, t13 + o0,
            t13 - o0, t12 - o1, t11 - o2, t10 - o3]


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


# jdmaster.c's prepare_range_limit_table, as the IDCT indexes it:
# (x & 1023) -> sample, for x the IDCT output before the +128 centring
_IDCT_LIMIT = np.concatenate([
    np.arange(128, 256), np.full(384, 255), np.zeros(384),
    np.arange(0, 128)]).astype(np.uint8)


_CHUNK = 1 << 14  # blocks per IDCT step, which bounds its int64 temporaries


def _idct_plane(coef: np.ndarray, quant: np.ndarray, nby: int,
                nbx: int) -> np.ndarray:
    """(nby * nbx * 64,) coefficients -> (nby * 8, nbx * 8) uint8."""
    pix = np.empty((nby * nbx, 8, 8), np.uint8)
    blocks = coef.reshape(-1, 8, 8)
    for at in range(0, nby * nbx, _CHUNK):
        x = blocks[at:at + _CHUNK].astype(np.int64) * quant.reshape(1, 8, 8)
        # pass 1: columns (the rows of x index the 1-D input)
        cols = _idct_1d([x[:, k, :] for k in range(8)])
        ws = np.stack([_descale(v, _CONST_BITS - _PASS1_BITS)
                       for v in cols], 1)
        # pass 2: rows
        rows = _idct_1d([ws[:, :, k] for k in range(8)])
        out = np.stack([_descale(v, _CONST_BITS + _PASS1_BITS + 3)
                        for v in rows], 2)
        pix[at:at + _CHUNK] = _IDCT_LIMIT[out & 1023]
    return pix.reshape(nby, nbx, 8, 8).transpose(0, 2, 1, 3).reshape(
        nby * 8, nbx * 8)


# ----------------------------------------------------------------------
# upsampling (jdsample.c) and colour conversion (jdcolor.c)
# ----------------------------------------------------------------------
def _upsample(plane: np.ndarray, hx: int, vx: int) -> np.ndarray:
    """One component's (dh, dw) samples -> (dh * vx, dw * hx), as
    libjpeg-turbo's jinit_upsampler picks the method."""
    if hx == vx == 1:
        return plane
    x = plane.astype(np.int32)
    dw = x.shape[1]
    if (hx, vx) == (2, 1) and dw > 2:  # h2v1_fancy_upsample
        left = np.concatenate([x[:, :1], x[:, :-1]], 1)
        right = np.concatenate([x[:, 1:], x[:, -1:]], 1)
        out = np.empty((x.shape[0], dw * 2), np.int32)
        out[:, 0::2] = (3 * x + left + 1) >> 2
        out[:, 1::2] = (3 * x + right + 2) >> 2
        return out.astype(np.uint8)
    if (hx, vx) == (1, 2):  # h1v2_fancy_upsample
        above = np.concatenate([x[:1], x[:-1]], 0)
        below = np.concatenate([x[1:], x[-1:]], 0)
        out = np.empty((x.shape[0] * 2, dw), np.int32)
        out[0::2] = (3 * x + above + 1) >> 2
        out[1::2] = (3 * x + below + 2) >> 2
        return out.astype(np.uint8)
    if (hx, vx) == (2, 2) and dw > 2:  # h2v2_fancy_upsample
        above = np.concatenate([x[:1], x[:-1]], 0)
        below = np.concatenate([x[1:], x[-1:]], 0)
        out = np.empty((x.shape[0] * 2, dw * 2), np.int32)
        for r, far in ((0, above), (1, below)):
            cs = 3 * x + far  # the column sums of this output row
            left = np.concatenate([cs[:, :1], cs[:, :-1]], 1)
            right = np.concatenate([cs[:, 1:], cs[:, -1:]], 1)
            out[r::2, 0::2] = (3 * cs + left + 8) >> 4
            out[r::2, 1::2] = (3 * cs + right + 7) >> 4
        return out.astype(np.uint8)
    # h2v1/h2v2 at a width of 2 or less, and int_upsample
    return np.repeat(np.repeat(plane, vx, 0), hx, 1)


def _fix(x: float) -> int:
    return int(x * (1 << 16) + 0.5)


_CX = np.arange(256, dtype=np.int64) - 128
_CR_R = (_fix(1.40200) * _CX + (1 << 15)) >> 16
_CB_B = (_fix(1.77200) * _CX + (1 << 15)) >> 16
_CR_G = -_fix(0.71414) * _CX
_CB_G = -_fix(0.34414) * _CX + (1 << 15)


def _ycc_to_rgb(y, cb, cr) -> np.ndarray:
    out = np.empty(y.shape + (3,), np.uint8)
    step = max(1, (1 << 20) // max(1, y.shape[1]))  # rows per step
    for at in range(0, y.shape[0], step):
        rows = slice(at, at + step)
        yy, b_, r_ = y[rows].astype(np.int64), cb[rows], cr[rows]
        out[rows] = np.clip(np.stack([
            yy + _CR_R[r_], yy + ((_CB_G[b_] + _CR_G[r_]) >> 16),
            yy + _CB_B[b_]], -1), 0, 255)
    return out


def _smoothing_ok(comps: List[_Component]) -> bool:
    """jdcoefct.c's smoothing_ok (libjpeg-turbo 2.1 and later) after the
    last scan: libjpeg block-smooths a progressive image whose DC is known
    but some of the first nine AC coefficients (zigzag order) are not
    complete (``coef_bits`` other than 0), if their quantisers are
    nonzero."""
    useful = False
    for c in comps:
        q = c.quant
        if q is None or not all(q[[0, 1, 8, 16, 9, 2, 3, 10, 17, 24]]) or \
                c.coef_bits[0] < 0:
            return False
        useful = useful or any(c.coef_bits[1:10])
    return useful


# ----------------------------------------------------------------------
# markers
# ----------------------------------------------------------------------
def _entropy_segments(data: bytes, pos: int):
    """The entropy-coded data from ``pos``: its restart intervals (byte
    stuffing undone) and the position of the marker that ends it."""
    segments, out = [], bytearray()
    n = len(data)
    while True:
        j = data.find(b"\xff", pos)
        if j < 0 or j + 1 >= n:
            raise ValueError("truncated JPEG file: the scan has no end "
                             "marker")
        out += data[pos:j]
        nxt = data[j + 1]
        if nxt == 0x00:
            out.append(0xFF)
            pos = j + 2
        elif nxt == 0xFF:  # fill byte before a marker
            pos = j + 1
        elif 0xD0 <= nxt <= 0xD7:  # RSTn
            segments.append(bytes(out))
            out = bytearray()
            pos = j + 2
        else:
            segments.append(bytes(out))
            return segments, j


def decode_jpeg(data: bytes, max_side=None) -> np.ndarray:
    """JPEG bytes -> (H, W, 3) uint8 RGB (see the module docstring)."""
    data = bytes(data)
    if not is_jpeg(data):
        raise ValueError("not a JPEG file")
    pos = 2
    quant: Dict[int, np.ndarray] = {}
    huff: Dict[tuple, _Huffman] = {}
    frame = None
    comps: List[_Component] = []
    restart = 0
    jfif = adobe = False
    adobe_transform = None
    done = False
    while not done:
        while data[pos:pos + 2] == b"\xff\xff":  # fill bytes
            pos += 1
        if pos + 2 > len(data) or data[pos] != 0xFF:
            raise ValueError("truncated or corrupt JPEG file: no marker "
                             f"at byte {pos}")
        marker = data[pos + 1]
        if marker == 0xD9:  # EOI
            break
        if marker == 0xD8 or 0xD0 <= marker <= 0xD7:
            pos += 2
            continue
        if pos + 4 > len(data):
            raise ValueError("truncated JPEG file")
        (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
        body = data[pos + 4:pos + 2 + length]
        if length < 2 or len(body) != length - 2:
            raise ValueError("truncated JPEG file")
        pos += 2 + length
        if marker in _SOF_VARIANTS:
            raise ValueError(f"{_SOF_VARIANTS[marker]} JPEG files are not "
                             "supported")
        if marker == 0xCC:
            raise ValueError("arithmetic-coded JPEG files are not "
                             "supported")
        if marker in (0xC0, 0xC1, 0xC2):
            if len(body) < 6:
                raise ValueError("corrupt JPEG file: a short frame header")
            precision, h, w, nc = struct.unpack(">BHHB", body[:6])
            if precision != 8:
                raise ValueError(f"{precision}-bit JPEG files are not "
                                 "supported (8-bit samples only)")
            if h == 0:
                raise ValueError("JPEG files with a DNL-defined height are "
                                 "not supported")
            if nc == 4:
                what = "YCCK" if adobe and adobe_transform == 2 else "CMYK"
                raise ValueError(f"{what} JPEG files are not supported")
            if nc not in (1, 3):
                raise ValueError(f"{nc}-component JPEG files are not "
                                 "supported")
            if frame is not None or len(body) < 6 + 3 * nc:
                raise ValueError("corrupt JPEG file: a second or short "
                                 "frame header")
            if w == 0:
                raise ValueError("corrupt JPEG file: a frame of width 0")
            if w * h > MAX_PIXELS:
                raise ValueError(f"JPEG frame of {w}x{h} = {w * h} pixels "
                                 f"is over the limit of {MAX_PIXELS}")
            check_side(w, h, max_side)
            comps = [_Component(body[6 + 3 * i], body[7 + 3 * i] >> 4,
                                body[7 + 3 * i] & 15, body[8 + 3 * i])
                     for i in range(nc)]
            for c in comps:
                if c.h not in (1, 2, 3, 4) or c.v not in (1, 2, 3, 4):
                    raise ValueError(f"JPEG sampling factors {c.h}x{c.v} "
                                     "are not valid (1 to 4 each)")
            hmax = max(c.h for c in comps)
            vmax = max(c.v for c in comps)
            frame = {"w": w, "h": h, "progressive": marker == 0xC2,
                     "mcux": -(-w // (8 * hmax)), "mcuy": -(-h // (8 * vmax)),
                     "hmax": hmax, "vmax": vmax}
            for c in comps:
                if hmax % c.h or vmax % c.v:
                    raise ValueError("JPEG sampling factors "
                                     f"{c.h}x{c.v} of {hmax}x{vmax} are "
                                     "not supported")
                c.dw = -(-w * c.h // hmax)
                c.dh = -(-h * c.v // vmax)
                c.nbx, c.nby = frame["mcux"] * c.h, frame["mcuy"] * c.v
                # zeroed pages are mapped only when a scan writes them;
                # the entropy decoder indexes them through a memoryview
                c.array = np.zeros(c.nbx * c.nby * 64, np.int32)
                c.coef = memoryview(c.array)
        elif marker == 0xC4:  # DHT
            i = 0
            while i < len(body):
                tc, th = body[i] >> 4, body[i] & 15
                counts = list(body[i + 1:i + 17])
                n = sum(counts)
                if len(counts) < 16 or i + 17 + n > len(body):
                    raise ValueError("corrupt JPEG file: a short Huffman "
                                     "table")
                huff[(tc, th)] = _Huffman(counts, body[i + 17:i + 17 + n])
                i += 17 + n
        elif marker == 0xDB:  # DQT
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                if i + (129 if pq else 65) > len(body):
                    raise ValueError("corrupt JPEG file: a short "
                                     "quantisation table")
                if pq:
                    vals = np.frombuffer(body[i + 1:i + 129], ">u2")
                    i += 129
                else:
                    vals = np.frombuffer(body[i + 1:i + 65], np.uint8)
                    i += 65
                table = np.zeros(64, np.int64)
                table[_ZIGZAG] = vals
                quant[tq] = table
        elif marker == 0xDD:  # DRI
            if len(body) < 2:
                raise ValueError("corrupt JPEG file: a short restart "
                                 "interval")
            (restart,) = struct.unpack(">H", body[:2])
        elif marker == 0xE0 and body[:5] == b"JFIF\0":
            jfif = True
        elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe, adobe_transform = True, body[11]
        elif marker == 0xDA:  # SOS
            if frame is None:
                raise ValueError("corrupt JPEG file: a scan before the "
                                 "frame header")
            ns = body[0] if body else 0
            if not 1 <= ns <= 4 or len(body) < 4 + 2 * ns:
                raise ValueError("corrupt JPEG file: a bad scan header")
            by_id = {c.id: c for c in comps}
            scan_comps, tables = [], {}
            for i in range(ns):
                cid, t = body[1 + 2 * i], body[2 + 2 * i]
                if cid not in by_id:
                    raise ValueError("corrupt JPEG file: a scan names an "
                                     "unknown component")
                c = by_id[cid]
                scan_comps.append(c)
                if c.quant is None:  # latched at the component's first scan
                    if c.tq not in quant:
                        raise ValueError("corrupt JPEG file: a missing "
                                         "quantisation table")
                    c.quant = quant[c.tq]
                tables[cid] = (huff.get((0, t >> 4)), huff.get((1, t & 15)))
            ss, se, a = body[1 + 2 * ns:4 + 2 * ns]
            scan = _Scan(scan_comps, tables, ss, se, a >> 4, a & 15)
            if not frame["progressive"]:
                if ss != 0 or se != 63 or a:
                    raise ValueError("corrupt JPEG file: bad sequential "
                                     "scan parameters")
            elif (ss == 0 and se != 0) or (ss and (se < ss or se > 63
                                                   or ns != 1)):
                raise ValueError("corrupt JPEG file: bad progressive scan "
                                 "parameters")
            for c in scan_comps:
                dc, ac = tables[c.id]
                needs_dc = ss == 0 and (not frame["progressive"]
                                        or scan.ah == 0)
                needs_ac = se > 0
                if (needs_dc and dc is None) or (needs_ac and ac is None):
                    raise ValueError("corrupt JPEG file: a missing Huffman "
                                     "table")
            for c in scan_comps:
                c.coef_bits[ss:se + 1] = [scan.al] * (se + 1 - ss)
            segments, pos = _entropy_segments(data, pos)
            _decode_scan(scan, frame, segments, restart)
        # APPn, COM and the rest: skipped
    if frame is None:
        raise ValueError("JPEG file has no frame header")
    if frame["progressive"] and _smoothing_ok(comps):
        raise ValueError("progressive JPEG files whose scans leave the first "
                         "AC coefficients incomplete are not supported "
                         "(libjpeg's block smoothing of them is not ported)")

    planes = []
    for c in comps:
        if c.quant is None:
            raise ValueError("corrupt JPEG file: a component with no scan")
        plane = _idct_plane(c.array, c.quant, c.nby, c.nbx)[:c.dh, :c.dw]
        up = _upsample(plane, frame["hmax"] // c.h, frame["vmax"] // c.v)
        planes.append(up[:frame["h"], :frame["w"]])
    if len(planes) == 1:
        return np.repeat(planes[0][..., None], 3, axis=2)
    if jfif:
        rgb = False
    elif adobe:
        rgb = adobe_transform == 0
    else:
        rgb = [c.id for c in comps] == [82, 71, 66]  # 'R', 'G', 'B'
    if rgb:
        return np.stack(planes, -1)
    return _ycc_to_rgb(*planes)
