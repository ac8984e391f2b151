"""A TIFF decoder of the port's own (``zlib`` and numpy; no PIL), equal to
Pillow's.

:func:`decode_tiff` reads the first image (IFD) of a little- (``II``) or
big-endian (``MM``) TIFF and returns (H, W, 3) uint8 equal to
``Image.open(...).convert("RGB")``.  Pillow hands compressed files to
libtiff and reads uncompressed ones itself; this reads both:

* compression: none, PackBits, LZW (libtiff's MSB-first codes with the
  early change of code width) and Deflate (8 and 32946), each strip or
  tile decoded no further than its rows need, and of a tile only the
  rows and columns inside the image kept; predictor 2 (horizontal
  differences) under LZW and Deflate, as libtiff applies it;
* strips and tiles, chunky or planar;
* MinIsWhite and MinIsBlack at 1, 2, 4 and 8 bits (2 and 4 bits scaled
  by 0x55 and 0x11; MinIsWhite inverted), and 16 bits, which Pillow opens
  as "I;16" and converts by clipping at 255 (little-endian MinIsWhite is
  not inverted there, as in Pillow; big-endian MinIsWhite is refused, as
  Pillow refuses it); gray with an alpha sample;
* RGB at 8 and 16 bits (the high byte of each 16-bit sample), with extra
  samples: unassociated alpha and unspecified samples are dropped,
  associated alpha is divided out as Pillow's "RGBa" unpacker does
  (``v * 255 // a``, clipped; 0 where ``a`` is 0);
* palette at 1, 2, 4 and 8 bits, each 16-bit colormap entry mapped to
  ``v // 256``.

Refused with a ``ValueError`` naming the variant: JPEG-in-TIFF (old and
new), CCITT, other compressions (LZMA, ZSTD, WebP, ...), YCbCr, CMYK,
CIELab and other photometric interpretations, float or signed samples,
12- and 32-bit gray, FillOrder 2, an orientation other than 1, predictor
3, old-style LZW, and planar files with unspecified extra samples, or
uncompressed with extra or 16-bit samples (Pillow fails on these or
reads the planes as 8-bit).  So are malformed and truncated files, an IFD
chain that loops, and images, or grids of tiles, of more than
:data:`MAX_PIXELS` pixels (checked before anything is allocated; Pillow's
check is on the image alone).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from viewfusion_tpu_torch.utils.png import MAX_PIXELS, check_side

__all__ = ["decode_tiff"]

# tag type -> (struct code, size)
_TYPES = {1: ("B", 1), 2: ("B", 1), 3: ("H", 2), 4: ("I", 4), 6: ("b", 1),
          7: ("B", 1), 8: ("h", 2), 9: ("i", 4), 13: ("I", 4), 16: ("Q", 8)}
_COMPRESSIONS = {2: "CCITT RLE", 3: "CCITT Group 3", 4: "CCITT Group 4",
                 6: "JPEG-in-TIFF (old style)", 7: "JPEG-in-TIFF",
                 32809: "ThunderScan", 34676: "SGILog", 34677: "SGILog24",
                 34925: "LZMA", 50000: "ZSTD", 50001: "WebP",
                 32771: "raw 16"}
_PHOTOMETRIC = {4: "transparency mask", 5: "CMYK (separated)", 6: "YCbCr",
                8: "CIELab", 9: "ICCLab", 10: "ITULab", 32844: "LogL",
                32845: "LogLuv"}
_MAX_IFDS = 65536
_LZW_TABLE = 4095 + 1024  # libtiff's CSIZE


def _ifd(data: bytes, pos: int, end: str):
    """The tags of the IFD at ``pos``: {tag: tuple of ints}, and the next
    IFD's offset."""
    if pos + 2 > len(data):
        raise ValueError(f"corrupt TIFF file: an IFD offset {pos} past the "
                         "end")
    (count,) = struct.unpack(end + "H", data[pos:pos + 2])
    if pos + 2 + 12 * count + 4 > len(data):
        raise ValueError("truncated TIFF file: an IFD is cut short")
    tags = {}
    for i in range(count):
        at = pos + 2 + 12 * i
        tag, kind, n = struct.unpack(end + "HHI", data[at:at + 8])
        if kind not in _TYPES:
            continue  # rationals, floats, ...: no tag read here is one
        code, size = _TYPES[kind]
        if size * n <= 4:
            where = at + 8
        else:
            (where,) = struct.unpack(end + "I", data[at + 8:at + 12])
            if where + size * n > len(data):
                continue  # Pillow skips such a tag too
        tags[tag] = struct.unpack(f"{end}{n}{code}",
                                  data[where:where + size * n])
    (nxt,) = struct.unpack(end + "I", data[pos + 2 + 12 * count:
                                           pos + 6 + 12 * count])
    return tags, nxt


def _packbits(src: bytes, size: int):
    """PackBits runs, as byte strings, until ``size`` bytes are out."""
    i, n, done = 0, len(src), 0
    while done < size and i < n:
        c = src[i]
        i += 1
        if c < 128:
            run = src[i:i + c + 1]
            i += c + 1
        elif c > 128:
            if i >= n:
                break
            run = src[i:i + 1] * (257 - c)
            i += 1
        else:
            continue
        done += len(run)
        yield run


def _lzw(src: bytes, size: int):
    """libtiff's LZW: MSB-first codes of 9-12 bits, the width growing one
    code early, 256 clear and 257 end of information; each code's string
    until ``size`` bytes are out.  As in libtiff, entries past 4095 go on
    being added (no 12-bit code reaches them) until its table of 5119 is
    full."""
    if len(src) >= 2 and src[0] == 0 and src[1] & 1:
        raise ValueError("old-style (LSB-first) TIFF LZW is not supported")
    literals = [bytes((i,)) for i in range(256)] + [b"", b""]
    table = list(literals)  # each code's string; 256, 257 hold places
    width, prev = 9, None
    acc = nbits = at = done = 0
    n = len(src)
    while done < size:
        while nbits < width:
            if at >= n:
                raise ValueError("truncated TIFF LZW data: a strip ends "
                                 "before its rows")
            acc = (acc << 8) | src[at]
            at += 1
            nbits += 8
        nbits -= width
        code = (acc >> nbits) & ((1 << width) - 1)
        acc &= (1 << nbits) - 1
        if code == 256:
            table, width, prev = list(literals), 9, None
            continue
        if code == 257:
            break
        if prev is None:
            if code > 255:
                raise ValueError(f"corrupt TIFF LZW data: code {code} past "
                                 "the table")
            prev = table[code]
            done += 1
            yield prev
            continue
        nxt = len(table)
        if code < nxt:
            string = table[code]
        elif code == nxt:  # the string about to be added
            string = prev + prev[:1]
        else:
            raise ValueError(f"corrupt TIFF LZW data: code {code} past the "
                             f"table of {nxt}")
        if nxt >= _LZW_TABLE:
            raise ValueError("corrupt TIFF LZW data: the table overflows")
        table.append(prev + string[:1])
        if nxt + 1 == (1 << width) - 1 and width < 12:
            width += 1
        done += len(string)
        yield string
        prev = string


def _inflate(src: bytes, size: int):
    """A zlib stream in pieces of at most 1 MiB until ``size`` bytes are
    out; its checksum is checked where the stream ends with them (zlib
    does, under libtiff)."""
    try:
        d, tail, left = zlib.decompressobj(), src, size
        while left > 0:
            piece = d.decompress(tail, min(left, 1 << 20))
            tail = d.unconsumed_tail
            if not piece:
                break
            left -= len(piece)
            if left <= 0 and not d.eof and tail:
                d.decompress(tail, 1)
            yield piece
    except zlib.error as e:
        raise ValueError(f"corrupt TIFF Deflate data: {e}") from e


def _gather(pieces, size: int, rows: int, stride: int,
            row_bytes: int) -> bytes:
    """The first ``row_bytes`` of each of the first ``rows`` rows,
    ``stride`` bytes apart, of a decoded strip or tile that must hold
    ``size`` bytes (libtiff fails on a shorter one).  The rest is decoded
    and dropped, so that a tile's padding past the image takes no memory."""
    keep = rows * row_bytes
    out, buf, seen = bytearray(), bytearray(), 0
    for piece in pieces:
        seen += len(piece)
        if len(out) < keep:
            buf += piece
            while len(buf) >= stride and len(out) < keep:
                out += buf[:row_bytes]
                del buf[:stride]
        if seen >= size:
            return bytes(out)
    raise ValueError("truncated TIFF file: a strip or tile is shorter "
                     "than its rows")


def _chunk_samples(raw: bytes, rows: int, cols: int, spp: int, bps: int,
                   end: str, predictor: int) -> np.ndarray:
    """A decoded strip or tile -> (rows, cols, spp) samples (uint16 at 16
    bits, uint8 else; sub-byte samples unpacked)."""
    stride = (cols * spp * bps + 7) // 8
    buf = np.frombuffer(raw, np.uint8, rows * stride).reshape(rows, stride)
    if bps == 16:
        px = buf.view(end + "u2").astype(np.uint16).reshape(rows, cols, spp)
    elif bps == 8:
        px = buf.reshape(rows, cols, spp)
    else:
        bits = np.unpackbits(buf, axis=1).reshape(rows, -1, bps)
        weights = (1 << np.arange(bps - 1, -1, -1)).astype(np.uint8)
        px = (bits * weights).sum(axis=2, dtype=np.uint8)[
            :, :cols * spp].reshape(rows, cols, spp)
    if predictor == 2:
        px = np.cumsum(px, axis=1, dtype=px.dtype)
    return px


def decode_tiff(data: bytes, max_side=None) -> np.ndarray:
    """TIFF bytes -> (H, W, 3) uint8 RGB of the first image (see the
    module docstring)."""
    data = bytes(data)
    if data[:4] == b"II*\x00":
        end = "<"
    elif data[:4] == b"MM\x00*":
        end = ">"
    else:
        raise ValueError("not a TIFF file")
    if len(data) < 8:
        raise ValueError("truncated TIFF file")
    (pos,) = struct.unpack(end + "I", data[4:8])
    tags, nxt = _ifd(data, pos, end)
    seen = {pos}
    while nxt:  # the chain is walked (not read) so that a loop is caught
        if nxt in seen or len(seen) > _MAX_IFDS:
            raise ValueError("corrupt TIFF file: its IFD chain loops")
        seen.add(nxt)
        at = nxt + 2 + 12 * struct.unpack(end + "H", data[nxt:nxt + 2])[0] \
            if nxt + 2 <= len(data) else len(data)
        if at + 4 > len(data):
            break  # a chain cut short: the first image is still read
        (nxt,) = struct.unpack(end + "I", data[at:at + 4])

    def tag(number, default=None):
        value = tags.get(number)
        if value is None or len(value) == 0:
            if default is None:
                raise ValueError(f"TIFF file lacks tag {number}")
            return default
        return value

    w, h = tag(256)[0], tag(257)[0]
    if w * h > MAX_PIXELS:
        raise ValueError(f"TIFF image of {w}x{h} = {w * h} pixels is over "
                         f"the limit of {MAX_PIXELS}")
    check_side(w, h, max_side)
    if w == 0 or h == 0:
        raise ValueError(f"TIFF image of {w}x{h} has no pixels")
    compression = tag(259, (1,))[0]
    if compression in _COMPRESSIONS:
        raise ValueError(f"TIFF compression {_COMPRESSIONS[compression]} is "
                         "not supported")
    if compression not in (1, 5, 8, 32773, 32946):
        raise ValueError(f"TIFF compression {compression} is not supported")
    photo = tag(262, (0,))[0]
    if photo in _PHOTOMETRIC:
        raise ValueError(f"TIFF photometric interpretation "
                         f"{_PHOTOMETRIC[photo]} is not supported")
    if photo not in (0, 1, 2, 3):
        raise ValueError(f"TIFF photometric interpretation {photo} is not "
                         "supported")
    if tag(266, (1,))[0] != 1:
        raise ValueError("TIFF FillOrder 2 (least significant bit first) is "
                         "not supported")
    if tag(274, (1,))[0] != 1:
        raise ValueError(f"TIFF orientation {tag(274)[0]} is not supported "
                         "(1 only)")
    formats = set(tag(339, (1,)))
    if formats != {1}:
        names = {2: "signed", 3: "float", 4: "untyped", 5: "complex signed",
                 6: "complex float"}
        raise ValueError("TIFF " + ", ".join(names.get(f, str(f)) for f in
                                             sorted(formats - {1}))
                         + " samples are not supported (unsigned only)")
    extra = tuple(tags.get(338, ()))
    spp = tag(277, (1,))[0]
    bps_all = tag(258, (1,))
    if len(bps_all) == 1:
        bps_all = bps_all * spp
    bps_all = bps_all[:spp]
    if spp == 0 or len(bps_all) != spp or len(set(bps_all)) != 1:
        raise ValueError(f"TIFF samples of {bps_all} bits are not supported")
    bps = bps_all[0]
    base = 3 if photo == 2 else 1
    if spp != base + len(extra):
        raise ValueError(f"TIFF of {spp} samples and extra samples {extra} "
                         "is not supported")
    if photo == 2:
        ok = bps in (8, 16) and all(e in (0, 1, 2) for e in extra) and (
            bps == 8 and len(extra) <= 3 and 1 not in extra[1:]
            and 2 not in extra[1:] or bps == 16 and len(extra) <= 1)
    elif photo == 3:
        ok = bps in (1, 2, 4, 8) and not extra or bps == 8 and extra in (
            (0,), (2,))
    else:
        ok = (bps in (1, 2, 4, 8) or bps == 16 and (end == "<" or photo == 1)
              ) and not extra or photo == 1 and bps == 8 and extra == (2,)
    if not ok:
        raise ValueError(f"TIFF of photometric {photo}, {bps}-bit samples "
                         f"and extra samples {extra} is not supported")
    predictor = tag(317, (1,))[0]
    if compression in (1, 32773):
        predictor = 1  # neither Pillow nor libtiff applies it here
    if predictor not in (1, 2):
        raise ValueError(f"TIFF predictor {predictor} is not supported")
    if predictor == 2 and bps not in (8, 16):
        raise ValueError(f"TIFF predictor 2 at {bps} bits is not supported")
    planar = tag(284, (1,))[0]
    if planar not in (1, 2) and compression != 1:  # Pillow: not 2 is 1
        raise ValueError(f"TIFF planar configuration {planar} is not "
                         "supported")
    planes = spp if planar == 2 and spp > 1 else 1
    if planes > 1 and (0 in extra or compression == 1 and (
            extra or bps == 16)):
        raise ValueError("planar TIFF with unspecified extra samples, or "
                         "uncompressed with extra or 16-bit samples, is "
                         "not supported")

    if 324 in tags:
        cw, ch = tag(322)[0], tag(323)[0]
        offsets, counts = tag(324), tags.get(325)
    else:
        cw, ch = w, min(tag(278, (h,))[0], h)
        offsets, counts = tag(273), tags.get(279)
    if cw == 0 or ch == 0:
        raise ValueError("corrupt TIFF file: strips or tiles of no pixels")
    across, down = -(-w // cw), -(-h // ch)
    if len(offsets) < across * down * planes and compression != 1:
        raise ValueError(f"corrupt TIFF file: {len(offsets)} strips or "
                         f"tiles for {across * down * planes}")
    if compression != 1 and (counts is None or len(counts) < len(offsets)):
        raise ValueError("corrupt TIFF file: strip or tile byte counts are "
                         "missing")
    if 324 in tags and across * cw * down * ch > MAX_PIXELS:
        raise ValueError(f"TIFF tiles of {cw}x{ch} cover "
                         f"{across * cw}x{down * ch} pixels, over the limit "
                         f"of {MAX_PIXELS}")
    sub = spp // planes
    stride = (cw * sub * bps + 7) // 8
    pix = np.zeros((h, w, spp), np.uint16 if bps == 16 else np.uint8)
    for plane in range(planes):
        for j in range(down):
            for i in range(across):
                k = (plane * down + j) * across + i
                if k >= len(offsets):
                    continue  # uncompressed: Pillow leaves the rest 0
                y0, x0 = j * ch, i * cw
                y1, x1 = min(y0 + ch, h), min(x0 + cw, w)
                # a tile is decoded whole, a strip to the image's last row
                size = (ch if 324 in tags else y1 - y0) * stride
                off = offsets[k]
                if compression == 1:
                    if 324 not in tags and j == down - 1 and planes == 1 \
                            and (w, h) == (cw, ch):
                        off = offsets[-1]  # Pillow reads the last strip
                    pieces = (data[off:off + size],)
                else:
                    src = data[off:off + counts[k]]
                    if off + counts[k] > len(data):
                        raise ValueError("truncated TIFF file: a strip or "
                                         "tile lies past the end")
                    pieces = (_lzw if compression == 5 else _packbits
                              if compression == 32773 else _inflate)(
                                  src, size)
                raw = _gather(pieces, size, y1 - y0, stride,
                              ((x1 - x0) * sub * bps + 7) // 8)
                pix[y0:y1, x0:x1, plane * sub:(plane + 1) * sub] = \
                    _chunk_samples(raw, y1 - y0, x1 - x0, sub, bps, end,
                                   predictor)
    if photo == 3:
        cmap = np.asarray(tag(320), np.int64)
        n = 1 << bps
        if len(cmap) < 3 * n:
            raise ValueError("corrupt TIFF file: its colormap is short")
        table = (cmap[:3 * n].reshape(3, n).T // 256).astype(np.uint8)
        return table[pix[..., 0]]
    if photo == 2:
        if bps == 16:
            pix = (pix >> 8).astype(np.uint8)
        rgb = pix[..., :3]
        if extra[:1] == (1,):  # associated alpha: Pillow divides it out
            a = pix[..., 3:4].astype(np.int32)
            out = np.minimum(rgb.astype(np.int32) * 255 // np.maximum(a, 1),
                             255)
            rgb = np.where(a == 0, 0, np.where(a == 255, rgb, out))
        return np.ascontiguousarray(rgb, dtype=np.uint8)
    gray = pix[..., 0]
    if bps == 16:
        gray = np.minimum(gray, 255).astype(np.uint8)
    else:
        if bps < 8:
            gray = gray * np.uint8(255 // ((1 << bps) - 1))
        if photo == 0:
            gray = 255 - gray
    return np.repeat(gray[..., None], 3, axis=2)
