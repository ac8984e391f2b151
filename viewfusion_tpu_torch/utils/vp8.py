"""A WebP lossy (VP8 key frame) decoder of the port's own (numpy; no PIL),
equal to libwebp's, which Pillow decodes WebP through.

:func:`decode_vp8` reads a ``VP8 `` chunk's payload (one key frame) and
returns (H, W, 3) uint8 RGB equal, bit for bit, to what libwebp gives
Pillow's ``Image.open(...).convert("RGB")``.  It follows RFC 6386 and, where
libwebp chooses among exact forms, libwebp's arithmetic:

* the boolean decoder (``range - 1`` kept, as libwebp keeps it), the frame
  header: segmentation (quantizer and filter-level updates, the segment
  map tree), the filter type, level and sharpness and their deltas, 1 to
  8 token partitions (sizes past the data are cut to it, as libwebp does;
  a last partition left empty raises), the quantizer indices and deltas,
  the coefficient-probability updates and the skip flag;
* the intra modes: 16 x 16 (DC, V, H, TM; DC without top or left as
  libwebp's ``CheckMode`` picks), the ten 4 x 4 B-modes in context of the
  blocks above and left, and chroma; the frame's top edge reads 127, its
  left edge 129, the top-left corner 127 on the top row and 129 below it,
  and the 4 x 4 blocks of the right column read the macroblock's top-right
  pixels on every row;
* tokens through the band and context probabilities, dequantised (the Y2
  AC factor ``* 155 // 100`` with a floor of 8, values wrapped to int16 as
  libwebp stores them), the inverse WHT and DCT in libwebp's integer form
  (``20091`` and ``35468``, ``>> 16``);
* the simple and normal loop filters over every macroblock edge and, for
  4 x 4 or coded macroblocks, the inner edges, with libwebp's strength
  tables (no filter at all when the frame level is 0, whatever the
  segments say), in raster order after the whole frame is predicted from
  unfiltered pixels;
* the crop to the frame size, then libwebp's fancy upsampling of the 4:2:0
  chroma (its 9-3-3-1 filter, edges mirrored) and its 14-bit fixed-point
  YUV -> RGB (``VP8YUVToR/G/B``).

The entropy decoding and the 4 x 4 predictions are plain Python; the
16 x 16 and chroma predictions (a macroblock at a time), the IDCT (a
macroblock row at a time), the loop filter (a wavefront of macroblocks
and one of its eight edge stages at a time) and the upsampling and colour
conversion (the frame at once) run in numpy.  The frame size is checked against :data:`MAX_PIXELS` before
anything is allocated; a malformed or truncated frame raises a
``ValueError`` (libwebp's end-of-partition test: a partition read past its
end fails).
"""

from __future__ import annotations

import numpy as np

from viewfusion_tpu_torch.utils.png import MAX_PIXELS

__all__ = ["decode_vp8", "vp8_size"]

# RFC 6386's tables, in libwebp's layout: the default coefficient
# probabilities and their update probabilities [4 types][8 bands][3
# contexts][11 nodes], the key-frame B-mode probabilities [above][left][9]
# (modes in libwebp's order: DC, TM, VE, HE, RD, VR, LD, VL, HD, HU), and
# the DC and AC quantizer steps by index.
_COEFF_PROBS = bytes.fromhex(
    "808080808080808080808080808080808080808080808080808080808080808080fd88fe"
    "ffe4db8080808080bd81f2ffe3d5ffdb8080806a7ee3fcd6d1ffff8080800162f8ffece2"
    "ffff808080b585eefeddeaff9a8080804e86caf7c6b4ffdb80808001b9f9fff3ff808080"
    "8080b896f7ffece080808080804d6ed8ffece680808080800165fbfff1ff8080808080aa"
    "8bf1fcecd1ffff8080802574c4f3e4ffffff80808001ccfefff5ff8080808080cfa0faff"
    "ee8080808080806667e7ffd3ab80808080800198fcfff0ff8080808080b187f3ffeae180"
    "808080805081d3ffc2e080808080800101ff8080808080808080f601ff80808080808080"
    "80ff80808080808080808080c623eddfc1bba2a0919b3e832dc6ddacb0dc9dfcdd01442f"
    "92d095a7dda2ffdf800195f1ffdde0ffff808080b88deafddedcffc78080805163b5f2b0"
    "bef9caffff800181e8fdd6c5f2c4ffff806379d2fac9c6ffca808080175ba3f2aabbf7d2"
    "ffff8001c8f6ffeaff80808080806db2f1ffe7f5ffff8080802c82c9fdcdc0ffff808080"
    "0184effbdbd1ffa58080805e88e1fbdabeffff8080801664aef5baa1ffc780808001b6f9"
    "ffe8eb80808080807c8ff1ffe3ea8080808080234db5fbc1d3ffcd808080019df7ffece7"
    "ffff808080798debffe1e3ffff8080802d63bcfbc3d9ffe08080800101fbffd5ff808080"
    "8080cb01f8ffff8080808080808901b1ffe0ff8080808080fd09f8fbcfd0ffc0808080af"
    "0de0f3c1b9f9c6ffff804911abdda1b3eca7ffea80015ff7fdd4b7ffff808080ef5af4fa"
    "d3d1ffff8080809b4dc3f8bcc3ffff8080800118effbdadbffcd808080c933dbffc4ba80"
    "80808080452ebeefc9daffe480808001bffbffff808080808080dfa5f9ffd5ff80808080"
    "808d7cf8ffff8080808080800110f8ffff808080808080be24e6ffecff80808080809501"
    "ff808080808080808001e2ff8080808080808080f7c0ff8080808080808080f080ff8080"
    "8080808080800186fcffff808080808080d53efaffff808080808080375dff8080808080"
    "808080808080808080808080808080808080808080808080808080808080808080808080"
    "ca18d5ebbabfdca0f0afff7e26b6e8a9b8e4aeffbb803d2e8adb97b2f0aaffd8800170e6"
    "fac7bff79fffff80a66de4fcd3d7ffae808080274da2e8acb4f5b2ffff800134dcf6c6c7"
    "f9dcffff807c4abff3b7c1faddffff80184782db9aaaf3b6ffff8001b6e1f9dbf0ffe080"
    "80809596e2fcd8cdffab8080801c6caaf2b7c2fedfffff800151e6fccccbffc08080807b"
    "66d1f7bcc4ffe9808080145f99f3a4adffcb80808001def8ffd8d58080808080a8aff6fc"
    "ebcdffff8080802f74d7ffd3d4ffff8080800179ecfdd4d6ffff8080808d54d5fcc9caff"
    "db8080802a50a0f0a2b9ffcd8080800101ff8080808080808080f401ff80808080808080"
    "80ee01ff8080808080808080")
_COEFF_UPDATE_PROBS = bytes.fromhex(
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffb0f6ff"
    "ffffffffffffffffdff1fcfffffffffffffffff9fdfdfffffffffffffffffff4fcffffff"
    "ffffffffffeafefefffffffffffffffffdfffffffffffffffffffffff6feffffffffffff"
    "ffffeffdfefffffffffffffffffefffefffffffffffffffffff8fefffffffffffffffffb"
    "fffefffffffffffffffffffffffffffffffffffffffffdfefffffffffffffffffbfefeff"
    "fffffffffffffffefffefffffffffffffffffffefdfffefffffffffffffafffefffeffff"
    "fffffffffeffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffd9ffffffffffffffffffffe1fcf1fdfffffeffffffffeafa"
    "f1fafdfffdfefffffffffeffffffffffffffffffdffefeffffffffffffffffeefdfefeff"
    "fffffffffffffff8fefffffffffffffffff9feffffffffffffffffffffffffffffffffff"
    "fffffffffdfffffffffffffffffff7feffffffffffffffffffffffffffffffffffffffff"
    "fffdfefffffffffffffffffcfffffffffffffffffffffffffffffffffffffffffffffefe"
    "fffffffffffffffffdfffffffffffffffffffffffffffffffffffffffffffffefdffffff"
    "fffffffffffafffffffffffffffffffffeffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffbafbfaffffffffffffffffea"
    "fbf4fefffffffffffffffbfbf3fdfefffefffffffffffdfeffffffffffffffffecfdfeff"
    "fffffffffffffffbfdfdfefefffffffffffffffefefffffffffffffffffefefeffffffff"
    "fffffffffffffffffffffffffffffffffefffffffffffffffffffefeffffffffffffffff"
    "fffefffffffffffffffffffffffffffffffffffffffffffeffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "f8fffffffffffffffffffffafefcfefffffffffffffff8fef9fdfffffffffffffffffdfd"
    "fffffffffffffffff6fdfdfffffffffffffffffcfefbfefefffffffffffffffefcffffff"
    "fffffffffff8fefdfffffffffffffffffdfffefefffffffffffffffffbfeffffffffffff"
    "fffff5fbfefffffffffffffffffdfdfefffffffffffffffffffbfdfffffffffffffffffc"
    "fdfefffffffffffffffffffefffffffffffffffffffffcfffffffffffffffffff9fffeff"
    "fffffffffffffffffffefffffffffffffffffffffdfffffffffffffffffaffffffffffff"
    "fffffffffffffffffffffffffffffffffffffffffffffffffffffeffffffffffffffffff"
    "ffffffffffffffffffffffff")
_BMODE_PROBS = bytes.fromhex(
    "e7783059737178987098b3407eaa762e465faf458f505552489b67383a0aabdabd110d98"
    "721a11a32cc3150aad791850c31a3e2c405590470a26abd590221aaa2e371388a021ce47"
    "3f14087272d00c09e251280b60b6541d102486b7598962656aa59448bb64829d6f204b50"
    "4266a7634a3e28ea80293509b2f18d1a086b4a2b1a9249a631179d412669a033341f7380"
    "684f0c1bd9ff5711075744472c72330fba172f290e6eb6b71511c2422d1966c5bd171216"
    "585893962a2e2dc4cd2b61b775552623b33d2735c8571a152be8ab3822336872661d5d4d"
    "271c55ab3aa55a6240221674ce17222ba6496b36201a3301512b1f44196a1640ab24e172"
    "2213156684bc104c7c3e124e5f5539323033c165239fd76f592e6f3c941facdbe415126f"
    "70714d55b3ff267872282a01c4f5d10a196d582b1d8ca6d5252b9a3d3f1e9b432d4401d1"
    "6450082b9a01331a478e4e4e10ff8022c5ab29280566d3b70401dd333211a8d1c0171952"
    "8a1f24ab1ba6262ce543573aa952731a3bb33f3b5ab43ba65d499a282815748fd12227af"
    "2f0f10b722df312db72e1121b706620f20b7392e16188001361125412049731c801780cd"
    "2803097333c01206df572509733b4d40152f68372cda09363582e2405a46cd2829171a39"
    "363970b8052926a6d51e221a8598740a2086271335dd1a722049ff1f0941ea020f017649"
    "4b200c33c0ffa02b33581f2343665537ba553815176f3bcd2d25c03726467c4966012262"
    "7d622a58685575af525f543559806471652d4b4f7b2f338051ab01391105476639352931"
    "26210d7939491a0155290a438a4d6e5a2f727315020a66ffa61706651d100a558065c41a"
    "39120a6666d522142b75140f24a38044011a663d472522351ff3c0453c472649771cde25"
    "442d8022012f0bf5ab3e1113469255373e46252b259a64a355a0013f095c881c4020c955"
    "4b0f090940ffb8771056061c0540ff19f8013808118489ff3774803a0f145287391a7928"
    "a4321f899a851923da33672c83837b1f069e5628408794e02db780161a1183f09a0e01d1"
    "2d10155b40de0701c53815279b3c8a1766d5530c0d36c0ff442f1c551a555580802092ab"
    "120b073f90ab0404f6231b0a92aeab0c1a80be502363b4507e362d557e2f57b033291420"
    "654b808b769274805538290fb0ec5525093e471e117776ff11128a65263c8a37462b1a8e"
    "9224131eabff611b148a2d3d3edb0151bc4020291475978e1415a370130c3dc380300418")
_DC_TABLE = (
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17, 18, 19, 20,
    20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28, 29, 30, 31, 32, 33,
    34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 46, 47, 48, 49,
    50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 64, 65, 66, 67,
    68, 69, 70, 71, 72, 73, 74, 75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84,
    85, 86, 87, 88, 89, 91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108,
    110, 112, 114, 116, 118, 122, 124, 126, 128, 130, 132, 134, 136, 138,
    140, 143, 145, 148, 151, 154, 157)
_AC_TABLE = (
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22,
    23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40,
    41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    60, 62, 64, 66, 68, 70, 72, 74, 76, 78, 80, 82, 84, 86, 88, 90, 92, 94,
    96, 98, 100, 102, 104, 106, 108, 110, 112, 114, 116, 119, 122, 125, 128,
    131, 134, 137, 140, 143, 146, 149, 152, 155, 158, 161, 164, 167, 170,
    173, 177, 181, 185, 189, 193, 197, 201, 205, 209, 213, 217, 221, 225,
    229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284)
_ZIGZAG = (0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15)
_BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)
_CAT = ((173, 148, 140), (176, 155, 140, 135), (180, 157, 141, 134, 130),
        (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))
# the boolean decoder's renormalising shift for a range of 1..255
_NORM = [0] + [7 ^ (r.bit_length() - 1) for r in range(1, 256)]
# 16 x 16 and chroma modes (libwebp's numbering)
_DC, _TM, _V, _H = 0, 1, 2, 3


class _Bool:
    """libwebp's boolean decoder over ``data[start:end]``; ``eof`` is set
    once a read needs a byte past the end."""

    __slots__ = ("data", "pos", "end", "value", "range", "bits", "eof")

    def __init__(self, data: bytes, start: int, end: int):
        self.data, self.pos, self.end = data, start, end
        self.value, self.range, self.bits, self.eof = 0, 254, -8, False
        self.load()

    def load(self) -> None:
        if self.pos < self.end:
            self.value = (self.value << 8) | self.data[self.pos]
            self.pos += 1
            self.bits += 8
        elif not self.eof:
            self.value <<= 8
            self.bits += 8
            self.eof = True
        else:
            self.bits = 0

    def bit(self, prob: int) -> int:
        rng = self.range
        if self.bits < 0:
            self.load()
        pos = self.bits
        split = (rng * prob) >> 8
        if (self.value >> pos) > split:
            rng -= split
            self.value -= (split + 1) << pos
            bit = 1
        else:
            rng = split + 1
            bit = 0
        shift = _NORM[rng]
        self.range = (rng << shift) - 1
        self.bits = pos - shift
        return bit

    def value_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit(0x80)
        return v

    def signed(self, n: int) -> int:
        v = self.value_bits(n)
        return -v if self.bit(0x80) else v


def _coeffs(br: _Bool, probs, ctx: int, dq0: int, dq1: int, n: int,
            out: list) -> int:
    """One block's tokens from position ``n`` into ``out`` (16 ints, natural
    order, dequantised); returns the position after the last non-zero."""
    p = probs[n][ctx]
    bit = br.bit
    while n < 16:
        if not bit(p[0]):
            return n
        while not bit(p[1]):
            n += 1
            if n == 16:
                return 16
            p = probs[n][0]
        if not bit(p[2]):
            v = 1
            p = probs[n + 1][1]
        else:
            if not bit(p[3]):
                v = 2 if not bit(p[4]) else 3 + bit(p[5])
            elif not bit(p[6]):
                if not bit(p[7]):
                    v = 5 + bit(159)
                else:
                    v = 7 + 2 * bit(165)
                    v += bit(145)
            else:
                b1 = bit(p[8])
                cat = 2 * b1 + bit(p[9 + b1])
                v = 0
                for q in _CAT[cat]:
                    v += v + bit(q)
                v += 3 + (8 << cat)
            p = probs[n + 1][2]
        if bit(0x80):
            v = -v
        v *= dq1 if n else dq0
        out[_ZIGZAG[n]] = ((v + 32768) & 0xFFFF) - 32768  # int16, as stored
        n += 1
    return 16


def _mul1(a):
    return ((a * 20091) >> 16) + a


def _mul2(a):
    return (a * 35468) >> 16


def _idct(c: np.ndarray) -> np.ndarray:
    """libwebp's ``TransformOne`` residuals: (N, 16) int64 coefficients
    (natural order) -> (N, 4, 4) values to add to the prediction."""
    r = c.reshape(-1, 4, 4)
    a = r[:, 0] + r[:, 2]
    b = r[:, 0] - r[:, 2]
    cc = _mul2(r[:, 1]) - _mul1(r[:, 3])
    d = _mul1(r[:, 1]) + _mul2(r[:, 3])
    v = np.stack([a + d, b + cc, b - cc, a - d], 1)  # (N, row, column)
    dc = v[..., 0] + 4
    a = dc + v[..., 2]
    b = dc - v[..., 2]
    cc = _mul2(v[..., 1]) - _mul1(v[..., 3])
    d = _mul1(v[..., 1]) + _mul2(v[..., 3])
    return np.stack([a + d, b + cc, b - cc, a - d], -1) >> 3


def _wht(c: list) -> list:
    """libwebp's ``TransformWHT``: 16 Y2 coefficients -> the 16 blocks' DC
    (raster order), wrapped to int16."""
    tmp = [0] * 16
    for i in range(4):
        a0 = c[i] + c[12 + i]
        a1 = c[4 + i] + c[8 + i]
        a2 = c[4 + i] - c[8 + i]
        a3 = c[i] - c[12 + i]
        tmp[i], tmp[8 + i] = a0 + a1, a0 - a1
        tmp[4 + i], tmp[12 + i] = a3 + a2, a3 - a2
    out = [0] * 16
    for i in range(4):
        dc = tmp[i * 4] + 3
        a0 = dc + tmp[3 + i * 4]
        a1 = tmp[1 + i * 4] + tmp[2 + i * 4]
        a2 = tmp[1 + i * 4] - tmp[2 + i * 4]
        a3 = dc - tmp[3 + i * 4]
        out[4 * i:4 * i + 4] = [(a0 + a1) >> 3, (a3 + a2) >> 3,
                                (a0 - a1) >> 3, (a3 - a2) >> 3]
    return [((v + 32768) & 0xFFFF) - 32768 for v in out]


def _avg3(a, b, c):
    return (a + 2 * b + c + 2) >> 2


def _avg2(a, b):
    return (a + b + 1) >> 1


def _bpred(mode: int, t: list, left: list, x: int) -> list:
    """A 4 x 4 B-mode prediction (16 values, raster order) from the 8
    pixels above ``t`` (4 above-right included), the 4 to the left and the
    corner ``x``."""
    A, B, C, D, E, F, G, H = t
    I, J, K, L = left
    if mode == 0:  # DC
        return [(sum(t[:4]) + sum(left) + 4) >> 3] * 16
    if mode == 1:  # TM
        return [min(max(left[r] + t[c] - x, 0), 255)
                for r in range(4) for c in range(4)]
    if mode == 2:  # VE
        return [_avg3(x, A, B), _avg3(A, B, C), _avg3(B, C, D),
                _avg3(C, D, E)] * 4
    if mode == 3:  # HE
        rows = (_avg3(x, I, J), _avg3(I, J, K), _avg3(J, K, L),
                _avg3(K, L, L))
        return [v for v in rows for _ in range(4)]
    o = [0] * 16

    def put(value, *cells):
        for cx, cy in cells:
            o[cy * 4 + cx] = value

    if mode == 4:  # RD
        put(_avg3(J, K, L), (0, 3))
        put(_avg3(I, J, K), (1, 3), (0, 2))
        put(_avg3(x, I, J), (2, 3), (1, 2), (0, 1))
        put(_avg3(A, x, I), (3, 3), (2, 2), (1, 1), (0, 0))
        put(_avg3(B, A, x), (3, 2), (2, 1), (1, 0))
        put(_avg3(C, B, A), (3, 1), (2, 0))
        put(_avg3(D, C, B), (3, 0))
    elif mode == 5:  # VR
        put(_avg2(x, A), (0, 0), (1, 2))
        put(_avg2(A, B), (1, 0), (2, 2))
        put(_avg2(B, C), (2, 0), (3, 2))
        put(_avg2(C, D), (3, 0))
        put(_avg3(K, J, I), (0, 3))
        put(_avg3(J, I, x), (0, 2))
        put(_avg3(I, x, A), (0, 1), (1, 3))
        put(_avg3(x, A, B), (1, 1), (2, 3))
        put(_avg3(A, B, C), (2, 1), (3, 3))
        put(_avg3(B, C, D), (3, 1))
    elif mode == 6:  # LD
        put(_avg3(A, B, C), (0, 0))
        put(_avg3(B, C, D), (1, 0), (0, 1))
        put(_avg3(C, D, E), (2, 0), (1, 1), (0, 2))
        put(_avg3(D, E, F), (3, 0), (2, 1), (1, 2), (0, 3))
        put(_avg3(E, F, G), (3, 1), (2, 2), (1, 3))
        put(_avg3(F, G, H), (3, 2), (2, 3))
        put(_avg3(G, H, H), (3, 3))
    elif mode == 7:  # VL
        put(_avg2(A, B), (0, 0))
        put(_avg2(B, C), (1, 0), (0, 2))
        put(_avg2(C, D), (2, 0), (1, 2))
        put(_avg2(D, E), (3, 0), (2, 2))
        put(_avg3(A, B, C), (0, 1))
        put(_avg3(B, C, D), (1, 1), (0, 3))
        put(_avg3(C, D, E), (2, 1), (1, 3))
        put(_avg3(D, E, F), (3, 1), (2, 3))
        put(_avg3(E, F, G), (3, 2))
        put(_avg3(F, G, H), (3, 3))
    elif mode == 8:  # HD
        put(_avg2(I, x), (0, 0), (2, 1))
        put(_avg2(J, I), (0, 1), (2, 2))
        put(_avg2(K, J), (0, 2), (2, 3))
        put(_avg2(L, K), (0, 3))
        put(_avg3(A, B, C), (3, 0))
        put(_avg3(x, A, B), (2, 0))
        put(_avg3(I, x, A), (1, 0), (3, 1))
        put(_avg3(J, I, x), (1, 1), (3, 2))
        put(_avg3(K, J, I), (1, 2), (3, 3))
        put(_avg3(L, K, J), (1, 3))
    else:  # HU
        put(_avg2(I, J), (0, 0))
        put(_avg2(J, K), (2, 0), (0, 1))
        put(_avg2(K, L), (2, 1), (0, 2))
        put(_avg3(I, J, K), (1, 0))
        put(_avg3(J, K, L), (3, 0), (1, 1))
        put(_avg3(K, L, L), (3, 1), (1, 2))
        put(L, (3, 2), (2, 2), (0, 3), (1, 3), (2, 3), (3, 3))
    return o


def _predict(mode: int, top: np.ndarray, left: np.ndarray, corner: int,
             size: int, has_top: bool, has_left: bool) -> np.ndarray:
    """A 16 x 16 or 8 x 8 prediction (libwebp's ``CheckMode`` for DC)."""
    if mode == _DC:
        shift = 4 if size == 16 else 3
        if has_top and has_left:
            v = (int(top.sum()) + int(left.sum()) + size) >> (shift + 1)
        elif has_left:
            v = (int(left.sum()) + size // 2) >> shift
        elif has_top:
            v = (int(top.sum()) + size // 2) >> shift
        else:
            v = 0x80
        return np.full((size, size), v, np.int64)
    if mode == _V:
        return np.broadcast_to(top, (size, size)).astype(np.int64)
    if mode == _H:
        return np.broadcast_to(left[:, None], (size, size)).astype(np.int64)
    return np.clip(left[:, None].astype(np.int64) + top[None, :] - corner,
                   0, 255)


def vp8_size(data: bytes):
    """(width, height) of a VP8 key frame's header."""
    data = bytes(data[:10])
    if len(data) < 10:
        raise ValueError("truncated WebP lossy (VP8) frame header")
    bits = data[0] | data[1] << 8 | data[2] << 16
    if bits & 1:
        raise ValueError("WebP lossy frame is not a key frame")
    if (bits >> 1) & 7 > 3:
        raise ValueError(f"WebP lossy frame of profile {(bits >> 1) & 7}")
    if not (bits >> 4) & 1:
        raise ValueError("WebP lossy frame is not displayable")
    if data[3:6] != b"\x9d\x01\x2a":
        raise ValueError("WebP lossy frame lacks its start code")
    w = (data[6] | data[7] << 8) & 0x3FFF
    h = (data[8] | data[9] << 8) & 0x3FFF
    if w == 0 or h == 0:
        raise ValueError(f"WebP lossy frame of {w}x{h} has no pixels")
    return w, h


def _clamp(v, lo: int, hi: int):
    return np.minimum(np.maximum(v, lo), hi)


def _filter_lines(a: np.ndarray, limit, ilevel, hev, kind: str):
    """libwebp's edge filters on lines (L, 8) int64 of the pixels p3 p2 p1
    p0 | q0 q1 q2 q3 across an edge, each line with its own thresholds
    (arrays of L): ``kind`` "simple" (``DoFilter2`` where
    ``NeedsFilter``), "mb" (the macroblock edge: ``DoFilter2`` where the
    edge variance is high, else ``DoFilter6``) or "inner" (``DoFilter4``
    in place of ``DoFilter6``).  Returns the filtered lines."""
    p3, p2, p1, p0, q0, q1, q2, q3 = a.T
    mask = 4 * np.abs(p0 - q0) + np.abs(p1 - q1) <= 2 * limit + 1
    if kind != "simple":
        mask &= np.maximum.reduce([np.abs(p3 - p2), np.abs(p2 - p1),
                                   np.abs(p1 - p0), np.abs(q3 - q2),
                                   np.abs(q2 - q1), np.abs(q1 - q0)]) <= ilevel
    out = a.copy()
    if not mask.any():
        return out
    if kind == "simple":
        hv = mask
    else:
        hv = mask & ((np.abs(p1 - p0) > hev) | (np.abs(q1 - q0) > hev))
    outer = _clamp(p1 - q1, -128, 127)
    f = 3 * (q0 - p0) + outer
    out[:, 3] = np.where(hv, _clamp(p0 + _clamp((f + 3) >> 3, -16, 15), 0,
                                    255), p0)
    out[:, 4] = np.where(hv, _clamp(q0 - _clamp((f + 4) >> 3, -16, 15), 0,
                                    255), q0)
    rest = mask & ~hv
    if kind == "mb" and rest.any():  # DoFilter6
        f = _clamp(3 * (q0 - p0) + outer, -128, 127)
        b1, b2, b3 = (27 * f + 63) >> 7, (18 * f + 63) >> 7, (9 * f + 63) >> 7
        for col, v in ((1, p2 + b3), (2, p1 + b2), (3, p0 + b1),
                       (4, q0 - b1), (5, q1 - b2), (6, q2 - b3)):
            out[:, col] = np.where(rest, _clamp(v, 0, 255), out[:, col])
    elif kind == "inner" and rest.any():  # DoFilter4
        f = 3 * (q0 - p0)
        b1 = _clamp((f + 4) >> 3, -16, 15)
        b2 = _clamp((f + 3) >> 3, -16, 15)
        b3 = (b1 + 1) >> 1
        for col, v in ((2, p1 + b3), (3, p0 + b2), (4, q0 - b1),
                       (5, q1 - b3)):
            out[:, col] = np.where(rest, _clamp(v, 0, 255), out[:, col])
    return out


def _edge_lines(width: int, n: int, offset: int, vertical: bool):
    """Flat offsets (n, 8) from a block's top-left pixel, in a plane
    ``width`` wide, of the n lines across the edge ``offset`` pixels into
    the block: left of column ``offset`` when ``vertical``, else above
    row ``offset``."""
    along, across = np.arange(n)[:, None], np.arange(-4, 4)[None, :]
    if vertical:
        return along * width + offset + across
    return (offset + across) * width + along


def _loop_filter(Y, UV, filter_type: int, finfo: list, mbw: int,
                 mbh: int) -> None:
    """libwebp's ``DoFilter`` on every macroblock: the left edge, the
    inner vertical edges, the top edge, the inner horizontal edges (and
    chroma's, both planes, under the normal filter).  libwebp runs the
    macroblocks in raster order; a macroblock's filters touch only pixels
    within 4 of it, and need those of its left, upper and upper-right
    neighbours done first, so the macroblocks of one wavefront ``x + 2y``
    are disjoint and run together, each of the eight stages as one
    gather, filter and scatter of all their lines."""
    wy, wc = Y.shape[1], UV.shape[2]
    flat = np.concatenate([Y.reshape(-1), UV.reshape(-1)])
    uv0 = Y.size  # U's first pixel in ``flat``; V's is uv0 + UV[0].size
    chroma = filter_type == 2
    edge, inner = ("simple", "simple") if not chroma else ("mb", "inner")
    # stage -> (vertical, luma offset, chroma offset or None, edge or inner)
    stages = [(True, 0, 0, True), (True, 4, 4, False), (True, 8, None, False),
              (True, 12, None, False), (False, 0, 0, True),
              (False, 4, 4, False), (False, 8, None, False),
              (False, 12, None, False)]
    lines = [(_edge_lines(wy, 16, yo, v),
              None if co is None or not chroma else np.concatenate(
                  [_edge_lines(wc, 8, co, v), UV[0].size
                   + _edge_lines(wc, 8, co, v)]))
             for v, yo, co, _ in stages]
    info = np.array(finfo, np.int64).reshape(mbh, mbw, 4)
    for t in range(mbw + 2 * (mbh - 1)):
        mys = np.arange(max(0, (t - mbw + 2) // 2), min(mbh, t // 2 + 1))
        mxs = t - 2 * mys
        keep = (mxs >= 0) & (mxs < mbw)
        mys, mxs = mys[keep], mxs[keep]
        lim, il, hev, has_inner = info[mys, mxs].T
        for (vertical, _, _, is_edge), (ly, lc) in zip(stages, lines):
            on = lim > 0
            if is_edge:
                on &= (mxs > 0) if vertical else (mys > 0)
            else:
                on &= has_inner > 0
            if not on.any():
                continue
            by, bx = mys[on], mxs[on]
            idx = [(16 * by * wy + 16 * bx)[:, None, None] + ly]
            per = [np.repeat(v[on], 16) for v in (lim, il, hev)]
            if lc is not None:
                idx.append(uv0 + (8 * by * wc + 8 * bx)[:, None, None] + lc)
                per = [np.concatenate([p, np.repeat(v[on], 16)])
                       for p, v in zip(per, (lim, il, hev))]
            idx = np.concatenate([i.reshape(-1, 8) for i in idx])
            limit = per[0] + (4 if is_edge else 0)
            flat[idx] = _filter_lines(flat[idx], limit, per[1], per[2],
                                      edge if is_edge else inner)
    Y[...] = flat[:uv0].reshape(Y.shape)
    UV[...] = flat[uv0:].reshape(UV.shape)


def _upsample(y: np.ndarray, u: np.ndarray) -> np.ndarray:
    """libwebp's fancy upsampling of one chroma plane ((h+1)//2, (w+1)//2)
    to the luma's (h, w), as int64."""
    h, w = y.shape
    u = u.astype(np.int64)
    rows = np.arange(h)
    k = (rows + 1) // 2
    near = np.where(rows % 2 == 1, k - 1, k)
    far = np.where(rows % 2 == 1, k, k - 1)
    near, far = np.minimum(near, len(u) - 1), np.clip(far, 0, len(u) - 1)
    far = np.where(rows == 0, 0, far)
    if h % 2 == 0:
        far[-1] = near[-1]
    n, f = u[near], u[far]
    out = np.empty((h, w), np.int64)
    out[:, 0] = (3 * n[:, 0] + f[:, 0] + 2) >> 2
    pairs = (w - 1) >> 1
    if pairs:
        n0, n1, f0, f1 = n[:, :pairs], n[:, 1:pairs + 1], f[:, :pairs], \
            f[:, 1:pairs + 1]
        out[:, 1:2 * pairs:2] = (((n0 + 3 * n1 + 3 * f0 + f1 + 8) >> 3)
                                 + n0) >> 1
        out[:, 2:2 * pairs + 1:2] = (((n1 + 3 * n0 + 3 * f1 + f0 + 8) >> 3)
                                     + n1) >> 1
    if w % 2 == 0:
        out[:, w - 1] = (3 * n[:, -1] + f[:, -1] + 2) >> 2
    return out


def _clip8(v: np.ndarray) -> np.ndarray:
    return np.where((v & ~16383) == 0, v >> 6, np.where(v < 0, 0, 255))


def _yuv_to_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """libwebp's ``VP8YuvToRgb`` (14-bit fixed point) on int64 planes."""
    yy = (y * 19077) >> 8
    r = _clip8(yy + ((v * 26149) >> 8) - 14234)
    g = _clip8(yy - ((u * 6419) >> 8) - ((v * 13320) >> 8) + 8708)
    b = _clip8(yy + ((u * 33050) >> 8) - 17685)
    return np.stack([r, g, b], -1).astype(np.uint8)


class _Header:
    """The frame header's fields, as RFC 6386 section 19.2 names them."""

    def __init__(self, **fields):
        self.__dict__.update(fields)


def _parse_header(br: _Bool) -> _Header:
    """The first partition's frame header, from the colour space to the
    skip probability."""
    bit, value, signed = br.bit, br.value_bits, br.signed
    colorspace, clamp = bit(0x80), bit(0x80)
    use_segment = bit(0x80)
    update_map = update_data = absolute = 0
    seg_q, seg_f, seg_probs = [0] * 4, [0] * 4, [255] * 3
    if use_segment:
        update_map = bit(0x80)
        update_data = bit(0x80)
        if update_data:
            absolute = bit(0x80)
            seg_q = [signed(7) if bit(0x80) else 0 for _ in range(4)]
            seg_f = [signed(6) if bit(0x80) else 0 for _ in range(4)]
        if update_map:
            seg_probs = [value(8) if bit(0x80) else 255 for _ in range(3)]
    simple, level, sharpness = bit(0x80), value(6), value(3)
    ref_delta, mode_delta = [0] * 4, [0] * 4
    use_delta = bit(0x80)
    if use_delta and bit(0x80):
        ref_delta = [signed(6) if bit(0x80) else 0 for _ in range(4)]
        mode_delta = [signed(6) if bit(0x80) else 0 for _ in range(4)]
    if br.eof:
        raise ValueError("truncated WebP lossy frame: the frame header is "
                         "cut short")
    nparts = 1 << value(2)
    base_q = value(7)
    dq = [signed(4) if bit(0x80) else 0 for _ in range(5)]
    refresh = bit(0x80)  # ignored, as libwebp ignores it
    probs = np.frombuffer(_COEFF_PROBS, np.uint8).reshape(4, 8, 3, 11).copy()
    update = np.frombuffer(_COEFF_UPDATE_PROBS, np.uint8).reshape(
        4, 8, 3, 11).tolist()
    for t in range(4):
        for b in range(8):
            for c in range(3):
                for i in range(11):
                    if bit(update[t][b][c][i]):
                        probs[t, b, c, i] = value(8)
    skip_prob = value(8) if bit(0x80) else None
    return _Header(
        colorspace=colorspace, clamp=clamp, use_segment=use_segment,
        update_map=update_map, update_data=update_data, absolute=absolute,
        seg_q=seg_q, seg_f=seg_f, seg_probs=seg_probs, simple=simple,
        level=level, sharpness=sharpness, use_delta=use_delta,
        ref_delta=ref_delta, mode_delta=mode_delta, nparts=nparts,
        base_q=base_q, dq=dq, refresh=refresh, probs=probs,
        skip_prob=skip_prob)


def _clip(v: int, m: int) -> int:
    return 0 if v < 0 else m if v > m else v


def _quantizers(hdr: _Header) -> list:
    """Per segment: (Y1 DC, Y1 AC, Y2 DC, Y2 AC, UV DC, UV AC) steps."""
    dq, out = hdr.dq, []
    for s in range(4):
        q = hdr.base_q
        if hdr.use_segment:
            q = hdr.seg_q[s] + (0 if hdr.absolute else hdr.base_q)
        y2ac = (_AC_TABLE[_clip(q + dq[2], 127)] * 101581) >> 16
        out.append((_DC_TABLE[_clip(q + dq[0], 127)], _AC_TABLE[_clip(q, 127)],
                    _DC_TABLE[_clip(q + dq[1], 127)] * 2, max(y2ac, 8),
                    _DC_TABLE[_clip(q + dq[3], 117)],
                    _AC_TABLE[_clip(q + dq[4], 127)]))
    return out


def _strengths(hdr: _Header) -> list:
    """Per segment and (16 x 16, 4 x 4): (limit, interior limit, high
    edge variance threshold); limit 0 filters nothing."""
    out = []
    for s in range(4):
        base = hdr.level
        if hdr.use_segment:
            base = hdr.seg_f[s] + (0 if hdr.absolute else hdr.level)
        row = []
        for i4 in (0, 1):
            lv = base
            if hdr.use_delta:
                lv += hdr.ref_delta[0] + (hdr.mode_delta[0] if i4 else 0)
            lv = _clip(lv, 63)
            if lv == 0:
                row.append((0, 0, 0))
                continue
            il = lv
            if hdr.sharpness > 0:
                il >>= 2 if hdr.sharpness > 4 else 1
                il = min(il, 9 - hdr.sharpness)
            il = max(il, 1)
            row.append((2 * lv + il, il,
                        2 if lv >= 40 else 1 if lv >= 15 else 0))
        out.append(row)
    return out


class _Contexts:
    """What parsing carries from macroblock to macroblock: the B-modes
    above and to the left, and the non-zero flags of libwebp's ``nz_`` and
    ``nz_dc_`` above and to the left."""

    def __init__(self, mbw: int):
        self.intra_t, self.intra_l = [0] * (4 * mbw), [0] * 4
        self.nz_t, self.nz_dc_t = [0] * mbw, [0] * mbw
        self.nz_l = self.nz_dc_l = 0

    def new_row(self) -> None:
        self.intra_l = [0] * 4
        self.nz_l = self.nz_dc_l = 0


def _parse_mb(br: _Bool, tbr: _Bool, hdr: _Header, bands, quant,
              bmode_probs, ctx: _Contexts, mx: int):
    """One macroblock: its modes from the first partition, its tokens
    from ``tbr``.  Returns (segment, is 4x4, 16x16 mode or the 16 B-modes,
    chroma mode, 24 blocks of 16 dequantised coefficients, whether any
    coefficient is coded as libwebp's ``non_zero_y | non_zero_uv`` counts
    it)."""
    bit = br.bit
    seg = 0
    if hdr.update_map:
        p = hdr.seg_probs
        seg = bit(p[1]) if not bit(p[0]) else bit(p[2]) + 2
    skip = bit(hdr.skip_prob) if hdr.skip_prob is not None else 0
    is4 = not bit(145)
    top = ctx.intra_t
    if not is4:
        ymode = ((_TM if bit(128) else _H) if bit(156)
                 else (_V if bit(163) else _DC))
        top[4 * mx:4 * mx + 4] = [ymode] * 4
        ctx.intra_l = [ymode] * 4
        modes = ymode
    else:
        modes = [0] * 16
        for r in range(4):
            ym = ctx.intra_l[r]
            for c in range(4):
                pr = bmode_probs[top[4 * mx + c]][ym]
                if not bit(pr[0]):
                    ym = 0
                elif not bit(pr[1]):
                    ym = 1
                elif not bit(pr[2]):
                    ym = 2
                elif not bit(pr[3]):
                    ym = 3 if not bit(pr[4]) else 4 if not bit(pr[5]) else 5
                elif not bit(pr[6]):
                    ym = 6
                elif not bit(pr[7]):
                    ym = 7
                else:
                    ym = 8 if not bit(pr[8]) else 9
                top[4 * mx + c] = ym
                modes[4 * r + c] = ym
            ctx.intra_l[r] = ym
    uvmode = (_DC if not bit(142) else _V if not bit(114)
              else _TM if bit(183) else _H)
    coeffs = [[0] * 16 for _ in range(24)]
    coded = False
    if skip:
        ctx.nz_t[mx] = ctx.nz_l = 0
        if not is4:
            ctx.nz_dc_t[mx] = ctx.nz_dc_l = 0
        return seg, is4, modes, uvmode, coeffs, coded
    q = quant[seg]
    first = 0
    if not is4:
        dc = [0] * 16
        nz = _coeffs(tbr, bands[1], ctx.nz_dc_t[mx] + ctx.nz_dc_l, q[2], q[3],
                     0, dc)
        ctx.nz_dc_t[mx] = ctx.nz_dc_l = int(nz > 0)
        dcs = _wht(dc) if nz > 1 else [(dc[0] + 3) >> 3] * 16
        for i in range(16):
            coeffs[i][0] = dcs[i]
        first, ac = 1, bands[0]
    else:
        ac = bands[3]
    tnz, lnz = ctx.nz_t[mx] & 15, ctx.nz_l & 15
    out_l = 0
    for r in range(4):
        left = (lnz >> r) & 1
        for c in range(4):
            blk = coeffs[4 * r + c]
            nz = _coeffs(tbr, ac, left + ((tnz >> c) & 1), q[0], q[1], first,
                         blk)
            left = int(nz > first)
            tnz = (tnz & ~(1 << c)) | (left << c)
            coded |= nz > 1 or blk[0] != 0
        out_l |= left << r
    out_t = tnz
    for ch in (0, 2):  # U, then V
        tnz = (ctx.nz_t[mx] >> (4 + ch)) & 3
        lnz = (ctx.nz_l >> (4 + ch)) & 3
        for r in range(2):
            left = (lnz >> r) & 1
            for c in range(2):
                blk = coeffs[16 + 2 * ch + 2 * r + c]
                nz = _coeffs(tbr, bands[2], left + ((tnz >> c) & 1), q[4],
                             q[5], 0, blk)
                left = int(nz > 0)
                tnz = (tnz & ~(1 << c)) | (left << c)
                coded |= nz > 1 or blk[0] != 0
            lnz = (lnz & ~(1 << r)) | (left << r)
        out_t |= tnz << (4 + ch)
        out_l |= lnz << (4 + ch)
    ctx.nz_t[mx], ctx.nz_l = out_t, out_l
    return seg, is4, modes, uvmode, coeffs, coded


def decode_vp8(data: bytes) -> np.ndarray:
    """A VP8 key frame -> (H, W, 3) uint8 RGB (see the module docstring)."""
    data = bytes(data)
    w, h = vp8_size(data)
    if w * h > MAX_PIXELS:
        raise ValueError(f"WebP image of {w}x{h} = {w * h} pixels is over "
                         f"the limit of {MAX_PIXELS}")
    first = (data[0] | data[1] << 8 | data[2] << 16) >> 5
    if 10 + first > len(data):
        raise ValueError("truncated WebP lossy frame: the first partition "
                         "is past the data")
    br = _Bool(data, 10, 10 + first)
    hdr = _parse_header(br)
    # token partitions: sizes past the data are cut to it, as in libwebp
    start = 10 + first
    at = start + 3 * (hdr.nparts - 1)
    if at > len(data):
        raise ValueError("truncated WebP lossy frame: the partition sizes "
                         "are past the data")
    parts = []
    for p in range(hdr.nparts - 1):
        size = min(int.from_bytes(data[start + 3 * p:start + 3 * p + 3],
                                  "little"), len(data) - at)
        parts.append(_Bool(data, at, at + size))
        at += size
    if at >= len(data):
        raise ValueError("truncated WebP lossy frame: the last token "
                         "partition is empty")
    parts.append(_Bool(data, at, len(data)))
    filter_type = 0 if hdr.level == 0 else 1 if hdr.simple else 2
    quant, strengths = _quantizers(hdr), _strengths(hdr)
    plist = hdr.probs.tolist()
    bands = [[plist[t][_BANDS[i]] for i in range(17)] for t in range(4)]
    bmode_probs = np.frombuffer(_BMODE_PROBS, np.uint8).reshape(
        10, 10, 9).tolist()
    mbw, mbh = (w + 15) >> 4, (h + 15) >> 4
    Y = np.zeros((16 * mbh, 16 * mbw), np.int32)
    UV = np.zeros((2, 8 * mbh, 8 * mbw), np.int32)
    ctx, finfo = _Contexts(mbw), []
    for my in range(mbh):
        ctx.new_row()
        tbr = parts[my & (hdr.nparts - 1)]
        row = []
        for mx in range(mbw):
            seg, is4, modes, uvmode, coeffs, coded = _parse_mb(
                br, tbr, hdr, bands, quant, bmode_probs, ctx, mx)
            if tbr.eof or br.eof:
                raise ValueError("truncated WebP lossy frame: a partition "
                                 "ends before its macroblocks")
            lim, il, hev = strengths[seg][int(is4)]
            finfo.append((lim, il, hev, is4 or coded))
            row.append((is4, modes, uvmode, coeffs))
        # the residuals of the row's blocks at once, then each prediction
        res = _idct(np.asarray([mb[3] for mb in row], np.int64).reshape(
            -1, 16)).reshape(mbw, 24, 4, 4)
        for mx, (is4, modes, uvmode, _) in enumerate(row):
            _reconstruct(Y, UV, mx, my, mbw, is4, modes, uvmode, res[mx])
    if filter_type:
        _loop_filter(Y, UV, filter_type, finfo, mbw, mbh)
    y = Y[:h, :w]
    cu, cv = UV[:, :(h + 1) // 2, :(w + 1) // 2]
    return _yuv_to_rgb(y, _upsample(y, cu), _upsample(y, cv))


def _reconstruct(Y, UV, mx, my, mbw, is4, modes, uvmode, res):
    """Predict one macroblock from the unfiltered planes and add its
    residuals ``res`` (24 blocks of 4 x 4)."""
    y0, x0 = 16 * my, 16 * mx
    corner = (127 if my == 0 else 129) if mx == 0 else (
        127 if my == 0 else int(Y[y0 - 1, x0 - 1]))
    top = Y[y0 - 1, x0:x0 + 16] if my > 0 else np.full(16, 127, np.int64)
    left = Y[y0:y0 + 16, x0 - 1] if mx > 0 else np.full(16, 129, np.int64)
    if not is4:
        pred = _predict(modes, top, left, corner, 16, my > 0, mx > 0)
        Y[y0:y0 + 16, x0:x0 + 16] = np.clip(
            pred + res[:16].reshape(4, 4, 4, 4).transpose(0, 2, 1, 3)
            .reshape(16, 16), 0, 255)
    else:
        if my == 0:
            tr = [127] * 4
        elif mx == mbw - 1:
            tr = [int(Y[y0 - 1, x0 + 15])] * 4
        else:
            tr = Y[y0 - 1, x0 + 16:x0 + 20].tolist()
        # a local block with the edges: row 0 above, column 0 to the left
        buf = [[0] * 21 for _ in range(17)]
        buf[0][0] = corner
        buf[0][1:17] = top.tolist()
        buf[0][17:21] = tr
        for r in range(16):
            buf[r + 1][0] = int(left[r])
        for r in (4, 8, 12):  # the right column reads the MB's top-right
            buf[r][17:21] = tr
        rl = res[:16].tolist()
        for n in range(16):
            r, c = divmod(n, 4)
            ty, tx = 4 * r, 4 * c + 1
            t = buf[ty][tx:tx + 8]
            lf = [buf[ty + 1 + i][tx - 1] for i in range(4)]
            p = _bpred(modes[n], t, lf, buf[ty][tx - 1])
            blk = rl[n]
            for i in range(4):
                row = buf[ty + 1 + i]
                for j in range(4):
                    v = p[4 * i + j] + blk[i][j]
                    row[tx + j] = 0 if v < 0 else 255 if v > 255 else v
        Y[y0:y0 + 16, x0:x0 + 16] = np.array(buf, np.int64)[1:, 1:17]
    c0, cx = 8 * my, 8 * mx
    for k, P in enumerate(UV):
        ccorner = (127 if my == 0 else 129) if mx == 0 else (
            127 if my == 0 else int(P[c0 - 1, cx - 1]))
        ctop = P[c0 - 1, cx:cx + 8] if my > 0 else np.full(8, 127, np.int64)
        cleft = P[c0:c0 + 8, cx - 1] if mx > 0 else np.full(8, 129, np.int64)
        pred = _predict(uvmode, ctop, cleft, ccorner, 8, my > 0, mx > 0)
        r = res[16 + 4 * k:20 + 4 * k].reshape(2, 2, 4, 4).transpose(
            0, 2, 1, 3).reshape(8, 8)
        P[c0:c0 + 8, cx:cx + 8] = np.clip(pred + r, 0, 255)
