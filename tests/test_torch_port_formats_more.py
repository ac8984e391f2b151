"""The port's GIF, BMP, TIFF and WebP decoders against Pillow and the JAX
server.

Every case is a file that Pillow reads; the port's ``decode_image`` must
return what ``Image.open(...).convert("RGB")`` returns, bit for bit, and
the port's ``_decode_views`` what ``viewfusion_tpu.serving._decode_views``
returns for the same base64 payload.  The files are made here from seeded
arrays: by Pillow where it writes the variant, else by the small writers
below (BMP headers, depths and RLE streams, TIFF compressions, layouts and
photometrics, GIF frames and LZW streams, WebP containers and ALPH
chunks).  Lossy WebP variants that Pillow's encoder never writes (the
simple loop filter, sharpness, filter deltas, 2 to 8 token partitions,
absolute segment values) are made by re-encoding a Pillow file's boolean
decisions with new header fields (:func:`_vp8_rewrite`).  The forms the
port still refuses (:func:`_refused`) are held to raise a ``ValueError``
that names them by ``tests/test_torch_port_formats.py``.
"""

import base64
import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from viewfusion_tpu.serving import _decode_views as jax_decode_views
from viewfusion_tpu_torch.serving import _decode_views
from viewfusion_tpu_torch.utils import vp8 as vp8_module
from viewfusion_tpu_torch.utils.image import _lzw, _sub_blocks, decode_image
from viewfusion_tpu_torch.utils.webp import decode_webp_rgba


def _pil(data: bytes, mode: str = "RGB") -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert(mode))


def _same_as_pil(data: bytes) -> np.ndarray:
    """Assert the port decodes ``data`` as Pillow does, directly and
    through both servers' ``_decode_views``; returns the image."""
    want = _pil(data)
    got = decode_image(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    payload = {"views": [base64.b64encode(data).decode()], "angle": 1.0}
    np.testing.assert_array_equal(_decode_views(payload),
                                  jax_decode_views(payload))
    return got


def _smooth(h: int, w: int, seed: int, channels: int = 3) -> np.ndarray:
    """Shading with edges and some noise: every kind of block."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(xx / 6 + c) * np.cos(yy / 5 - c)
                     for c in range(channels)], -1)
    base[(xx // 8 + yy // 6) % 2 == 0] *= 0.7
    return np.clip(base + rng.normal(0, 12, base.shape), 0, 255).astype(
        np.uint8)


def _save(img, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    (img if isinstance(img, Image.Image) else Image.fromarray(img)).save(
        buf, fmt, **kw)
    return buf.getvalue()


# ----------------------------------------------------------------------
# GIF
# ----------------------------------------------------------------------
def _gif(idx, screen, offset=(0, 0), glob=None, local=None,
         transparency=None, min_bits=8, interlace=False, lzw=None,
         version=b"GIF89a") -> bytes:
    """A one-frame GIF of palette indices ``idx`` (h, w) at ``offset`` on
    a ``screen`` (w, h); tables are flat RGB bytes."""
    fh, fw = idx.shape
    out = [version, struct.pack("<HHBBB", *screen,
                                (0x80 | (len(glob) // 3).bit_length() - 2)
                                if glob else 0, 0, 0), glob or b""]
    if transparency is not None:
        out.append(b"\x21\xf9\x04\x01\x00\x00" + bytes([transparency])
                   + b"\x00")
    flags = (0x80 | (len(local) // 3).bit_length() - 2) if local else 0
    flags |= 0x40 if interlace else 0
    if interlace:
        order = np.concatenate([np.arange(r, fh, s) for r, s in
                                ((0, 8), (4, 8), (2, 4), (1, 2))])
        idx = idx[order]
    stream = lzw if lzw is not None else _lzw(idx.reshape(-1), min_bits)
    out += [b"\x2c" + struct.pack("<HHHHB", *offset, fw, fh, flags),
            local or b"", bytes([min_bits]) + _sub_blocks(stream), b";"]
    return b"".join(out)


def _lzw_deferred(data: bytes, min_bits: int = 8) -> bytes:
    """GIF LZW that, once its table is full, goes on with the full table
    (no clear code): the decoder must stop adding entries at 4096."""
    clear, end = 1 << min_bits, (1 << min_bits) + 1
    out, acc, nbits, width = bytearray(), 0, 0, min_bits + 1

    def emit(code):
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += width
        while nbits >= 8:
            out.append(acc & 255)
            acc >>= 8
            nbits -= 8

    table, nxt = {}, end + 1
    emit(clear)
    prefix = data[0]
    for k in data[1:]:
        code = table.get((prefix, k))
        if code is not None:
            prefix = code
            continue
        emit(prefix)
        if nxt < 4096:
            table[(prefix, k)] = nxt
            nxt += 1
            if nxt > (1 << width) and width < 12:
                width += 1
        prefix = k
    emit(prefix)
    emit(end)
    if nbits:
        out.append(acc & 255)
    return bytes(out)


def _gif_cases():
    rng = np.random.default_rng(1)
    img = _smooth(37, 29, 1)
    glob = bytes(rng.integers(0, 256, 48, dtype=np.uint8))
    local = bytes(rng.integers(0, 256, 768, dtype=np.uint8))
    idx = rng.integers(0, 16, (9, 7)).astype(np.uint8)
    ramp = bytes(np.repeat(np.arange(16, dtype=np.uint8), 3))
    cases = {}
    for colours in (2, 16, 256):
        for interlace in (False, True):
            cases[f"pillow {colours} colours interlace={interlace}"] = _save(
                Image.fromarray(img).quantize(colours), "GIF",
                interlace=interlace)
    cases["pillow gray"] = _save(Image.fromarray(img).convert("L"), "GIF")
    frames = [Image.fromarray(_smooth(30, 40, s)).quantize(64)
              for s in range(3)]
    cases["animation with transparency"] = _save(
        frames[0], "GIF", save_all=True, append_images=frames[1:],
        transparency=5)
    cases["sub-rectangle"] = _gif(idx, (20, 15), (3, 4), glob=glob)
    cases["sub-rectangle, transparency"] = _gif(idx, (20, 15), (3, 4),
                                                glob=glob, transparency=7)
    cases["local palette"] = _gif(idx, (20, 15), (3, 4), glob=glob,
                                  local=local, transparency=7)
    cases["frame past the screen"] = _gif(idx, (5, 5), (3, 4), glob=glob)
    cases["no colour table"] = _gif(idx, (20, 15), (3, 4))
    cases["gray ramp local table"] = _gif(idx, (7, 9), glob=glob,
                                          local=ramp)
    cases["gray ramp global table"] = _gif(idx, (7, 9), glob=ramp)
    cases["index past the table"] = _gif(
        rng.integers(0, 256, (9, 7)).astype(np.uint8), (7, 9), glob=glob)
    cases["interlaced"] = _gif(rng.integers(0, 16, (19, 7)).astype(np.uint8),
                               (7, 19), glob=glob, interlace=True)
    cases["GIF87a"] = _gif(idx, (7, 9), glob=glob, version=b"GIF87a")
    for bits in range(2, 9):
        cases[f"LZW code size {bits}"] = _gif(
            (idx.astype(int) % (1 << bits)).astype(np.uint8), (7, 9),
            glob=local, min_bits=bits)
    big = rng.integers(0, 4, (150, 100)).astype(np.uint8)
    cases["full table, no clear"] = _gif(
        big, (100, 150), glob=local, lzw=_lzw_deferred(big.tobytes()))
    cases["full table, no clear, 2 bits"] = _gif(
        big, (100, 150), glob=local, min_bits=2,
        lzw=_lzw_deferred(big.tobytes(), 2))
    return cases


GIF_CASES = _gif_cases()


@pytest.mark.parametrize("case", list(GIF_CASES))
def test_gif_decodes_as_pil(case):
    _same_as_pil(GIF_CASES[case])


# ----------------------------------------------------------------------
# BMP
# ----------------------------------------------------------------------
def _bmp(w, h, bits, pixels: bytes, header=40, compression=0,
         palette=None, colors=0, masks=None, top_down=False) -> bytes:
    """A BMP of ``pixels`` (the rows as stored) with the given info
    header size, depth, compression, palette (list of RGB) and masks."""
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        info = struct.pack("<IIIHHIIIIII", header, w,
                           2 ** 32 - h if top_down else h, 1, bits,
                           compression, 0, 2835, 2835, colors, 0)
        if masks is not None and header >= 52:
            info += struct.pack("<4I", *masks)
        info = (info + bytes(header))[:header]
    extra = struct.pack("<3I", *masks[:3]) if (
        masks is not None and header == 40) else b""
    table = b"".join(bytes([b, g, r]) + (b"" if header == 12 else b"\0")
                     for r, g, b in (palette or []))
    offset = 14 + header + len(extra) + len(table)
    return (b"BM" + struct.pack("<IHHI", offset + len(pixels), 0, 0, offset)
            + info + extra + table + pixels)


def _bmp_rows(rows: np.ndarray, bits: int) -> bytes:
    """(h, w) samples (or (h, w * bytes) for 16+ bits) -> stored rows,
    padded to 4 bytes."""
    out = []
    for r in rows:
        if bits == 1:
            b = np.packbits(r.astype(np.uint8)).tobytes()
        elif bits == 4:
            r = np.append(r, 0) if len(r) % 2 else r
            b = (r[0::2] << 4 | r[1::2]).astype(np.uint8).tobytes()
        else:
            b = r.astype(np.uint8).tobytes()
        out.append(b + bytes(-len(b) % 4))
    return b"".join(out)


def _rle_stream(rng, rle4: bool) -> bytes:
    """Random RLE8/RLE4 codes: runs, absolute runs, end-of-line, delta,
    end-of-bitmap."""
    out = bytearray()
    for _ in range(60):
        k = rng.integers(0, 10)
        if k < 5:
            out += bytes([rng.integers(1, 20), rng.integers(0, 256)])
        elif k < 7:
            n = int(rng.integers(3, 12))
            out += bytes([0, n]) + bytes(rng.integers(
                0, 256, n // 2 if rle4 else n, dtype=np.uint8))
            out += b"\0" * (len(out) % 2)
        elif k == 7:
            out += b"\0\0"
        elif k == 8:
            out += bytes([0, 2, rng.integers(0, 5), rng.integers(0, 2)])
        else:
            out += bytes([rng.integers(1, 5), rng.integers(0, 256)])
    return bytes(out + b"\0\1")


def _bmp_cases():
    rng = np.random.default_rng(2)
    cases = {}
    for header in (12, 40, 52, 56, 64, 108, 124):
        for bits in (1, 4, 8):
            n = 1 << bits
            colors = 0 if header == 12 or bits == 1 else n - 3
            count = colors or n
            palette = [tuple(rng.integers(0, 256, 3)) for _ in range(count)]
            idx = (rng.integers(0, count + 2, (7, 13)) % n).astype(np.uint8)
            for top_down in (False, True)[:1 if header == 12 else 2]:
                rows = _bmp_rows(idx if top_down else idx[::-1], bits)
                cases[f"{header}-byte header, {bits}-bit palette, "
                      f"top-down={top_down}"] = _bmp(
                    13, 7, bits, rows, header, palette=palette,
                    colors=colors, top_down=top_down)
        img = rng.integers(0, 256, (7, 13, 3)).astype(np.uint8)
        cases[f"{header}-byte header, 24-bit"] = _bmp(
            13, 7, 24, _bmp_rows(img[::-1, :, ::-1].reshape(7, -1), 24),
            header)
        if header == 12:
            continue
        bgrx = rng.integers(0, 256, (7, 13, 4)).astype(np.uint8)
        cases[f"{header}-byte header, 32-bit"] = _bmp(13, 7, 32,
                                                      bgrx.tobytes(), header)
        v = rng.integers(0, 65536, (7, 13)).astype("<u2")
        rows = b"".join(r.tobytes() + b"\0\0" for r in v)
        cases[f"{header}-byte header, 16-bit 5-5-5"] = _bmp(13, 7, 16, rows,
                                                            header)
        for masks in ((0xF800, 0x7E0, 0x1F, 0), (0x7C00, 0x3E0, 0x1F, 0)):
            cases[f"{header}-byte header, 16-bit bitfields {masks[:3]}"] = \
                _bmp(13, 7, 16, rows, header, compression=3, masks=masks)
        for masks in ((0xFF0000, 0xFF00, 0xFF, 0),
                      (0xFF000000, 0xFF0000, 0xFF00, 0),
                      (0xFF, 0xFF00, 0xFF0000, 0xFF000000),
                      (0xFF000000, 0xFF00, 0xFF, 0xFF0000)):
            if header < 56 and masks[3]:
                continue  # no alpha mask below a 56-byte header
            cases[f"{header}-byte header, 32-bit bitfields {masks}"] = _bmp(
                13, 7, 32, bgrx.tobytes(), header, compression=3,
                masks=masks)
    for k in range(8):
        rle4 = k % 2 == 1
        count = 16 if rle4 else 200
        palette = [tuple(rng.integers(0, 256, 3)) for _ in range(count)]
        w, h = int(rng.integers(3, 20)), int(rng.integers(2, 9))
        cases[f"RLE{4 if rle4 else 8} #{k}"] = _bmp(
            w, h, 4 if rle4 else 8, _rle_stream(rng, rle4), 40,
            compression=2 if rle4 else 1, palette=palette, colors=count,
            top_down=k % 4 == 0)
    gray = [(i, i, i) for i in range(16)]
    idx = rng.integers(0, 16, (5, 6))
    # 4 pixels fill a 4-byte row as 8-bit "L" pixels
    cases["4-bit gray ramp (Pillow reads mode L)"] = _bmp(
        4, 5, 4, _bmp_rows(idx[::-1, :4], 4), 40, palette=gray, colors=16)
    cases["8-bit black and white (Pillow reads mode 1)"] = _bmp(
        6, 5, 8, _bmp_rows(idx[::-1], 8), 40,
        palette=[(0, 0, 0), (255, 255, 255)], colors=2)
    img = _smooth(21, 17, 2)
    for mode in ("1", "L", "P", "RGB"):
        cases[f"Pillow mode {mode}"] = _save(Image.fromarray(img).convert(
            mode), "BMP")
    return cases


BMP_CASES = _bmp_cases()


@pytest.mark.parametrize("case", list(BMP_CASES))
def test_bmp_decodes_as_pil(case):
    _same_as_pil(BMP_CASES[case])


def test_bmp_widens_5_and_6_bit_fields_as_pillow():
    """Every 16-bit value, 5-5-5 and 5-6-5: each field to 8 bits as
    Pillow's unpackers do (v * 255 // 31, v * 255 // 63)."""
    v = np.arange(65536, dtype="<u2").reshape(256, 256)
    rows = v.tobytes()
    for masks in (None, (0xF800, 0x7E0, 0x1F, 0)):
        data = _bmp(256, 256, 16, rows, 40, compression=3 if masks else 0,
                    masks=masks)
        got = _same_as_pil(data)
        green = 6 if masks else 5
        top = v[::-1].astype(np.int64)
        g = (top >> 5) & ((1 << green) - 1)
        np.testing.assert_array_equal(
            got[..., 1], g * 255 // ((1 << green) - 1))


# ----------------------------------------------------------------------
# TIFF
# ----------------------------------------------------------------------
def _tiff_lzw(data: bytes) -> bytes:
    """libtiff's LZW encoder: MSB-first codes, 9 bits growing to 12 as the
    table fills, a clear code when it is full."""
    out, acc, nbits, width = bytearray(), 0, 0, 9

    def emit(code):
        nonlocal acc, nbits
        acc = (acc << width) | code
        nbits += width
        while nbits >= 8:
            nbits -= 8
            out.append((acc >> nbits) & 255)
        acc &= (1 << nbits) - 1

    def grow():
        nonlocal nxt, width, table
        nxt += 1
        if nxt == 4094:
            emit(256)
            table, nxt, width = {}, 258, 9
        elif nxt > (1 << width) - 1:
            width += 1

    table, nxt = {}, 258
    emit(256)
    prefix = data[0]
    for k in data[1:]:
        code = table.get((prefix, k))
        if code is not None:
            prefix = code
            continue
        emit(prefix)
        table[(prefix, k)] = nxt
        grow()
        prefix = k
    emit(prefix)
    grow()
    emit(257)
    if nbits:
        out.append((acc << (8 - nbits)) & 255)
    return bytes(out)


def _packbits(data: bytes) -> bytes:
    out, i = bytearray(), 0
    while i < len(data):
        j = i
        while j + 1 < len(data) and data[j + 1] == data[i] and j - i < 127:
            j += 1
        if j > i:
            out += bytes([257 - (j - i + 1), data[i]])
            i = j + 1
            continue
        j = i + 1
        while j < len(data) and j - i < 128 and not (
                j + 1 < len(data) and data[j + 1] == data[j]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def _tiff(px, bps=8, photo=2, extra=(), end="<", compression=1,
          predictor=1, planar=1, tile=None, rows_per_strip=None,
          colormap=None, tags=None, next_ifd=0) -> bytes:
    """A one-image TIFF of samples ``px`` (h, w, spp)."""
    h, w, spp = px.shape
    planes = spp if planar == 2 else 1
    sub = spp // planes
    cw, ch = tile if tile else (w, rows_per_strip or h)
    chunks = []
    for p in range(planes):
        for j in range(-(-h // ch)):
            for i in range(-(-w // cw)):
                part = px[j * ch:(j + 1) * ch, i * cw:(i + 1) * cw,
                          p * sub:(p + 1) * sub].astype(np.int64)
                if tile:
                    full = np.zeros((ch, cw, sub), np.int64)
                    full[:part.shape[0], :part.shape[1]] = part
                    part = full
                if predictor == 2:
                    part = part.copy()
                    part[:, 1:] = (part[:, 1:] - part[:, :-1]) % (1 << bps)
                raw = b""
                for row in part:
                    flat = row.reshape(-1)
                    if bps == 16:
                        raw += flat.astype(end + "u2").tobytes()
                    elif bps == 8:
                        raw += flat.astype(np.uint8).tobytes()
                    else:
                        bits = (flat[:, None] >> np.arange(bps - 1, -1, -1)
                                ) & 1
                        raw += np.packbits(bits.astype(np.uint8)).tobytes()
                if compression == 5:
                    raw = _tiff_lzw(raw)
                elif compression in (8, 32946):
                    raw = zlib.compress(raw)
                elif compression == 32773:
                    raw = _packbits(raw)
                chunks.append(raw)
    entries = {256: (4, [w]), 257: (4, [h]), 258: (3, [bps] * spp),
               259: (3, [compression]), 262: (3, [photo]), 277: (3, [spp]),
               284: (3, [planar])}
    if extra:
        entries[338] = (3, list(extra))
    if predictor != 1:
        entries[317] = (3, [predictor])
    if colormap is not None:
        entries[320] = (3, list(colormap))
    if tile:
        entries[322], entries[323] = (4, [cw]), (4, [ch])
    else:
        entries[278] = (4, [ch])
    entries.update(tags or {})
    body = bytearray((b"II*\0" if end == "<" else b"MM\0*") + bytes(4))
    offsets = []
    for c in chunks:
        offsets.append(len(body))
        body += c + bytes(len(c) % 2)
    entries[324 if tile else 273] = (4, offsets)
    entries[325 if tile else 279] = (4, [len(c) for c in chunks])
    ifd = len(body)
    values_at = ifd + 2 + 12 * len(entries) + 4
    table, values = b"", b""
    for tag in sorted(entries):
        kind, vals = entries[tag]
        code = {3: "H", 4: "I"}[kind]
        payload = struct.pack(f"{end}{len(vals)}{code}", *vals)
        if len(payload) <= 4:
            table += struct.pack(end + "HHI", tag, kind, len(vals)) + \
                payload + bytes(4 - len(payload))
        else:
            table += struct.pack(end + "HHII", tag, kind, len(vals),
                                 values_at + len(values))
            values += payload + bytes(len(payload) % 2)
    body += struct.pack(end + "H", len(entries)) + table + struct.pack(
        end + "I", ifd if next_ifd == "loop" else next_ifd) + values
    body[4:8] = struct.pack(end + "I", ifd)
    return bytes(body)


TIFF_FORMS = [  # (photometric, bits, extra samples)
    (2, 8, ()), (2, 16, ()), (2, 8, (2,)), (2, 8, (1,)), (2, 8, (0,)),
    (2, 16, (1,)), (1, 8, ()), (0, 8, ()), (1, 16, ()), (0, 16, ()),
    (1, 1, ()), (0, 1, ()), (1, 2, ()), (0, 4, ()), (1, 8, (2,)),
    (3, 8, ()), (3, 4, ()), (3, 1, ())]


def _tiff_cases():
    rng = np.random.default_rng(3)
    cases = {}
    for compression in (1, 32773, 5, 8, 32946):
        for photo, bps, extra in TIFF_FORMS:
            spp = (3 if photo == 2 else 1) + len(extra)
            px = rng.integers(0, 1 << bps, (11, 13, spp))
            if extra == (1,):  # associated alpha: 0, 255 and between
                px[0, :2, 3] = (0, (1 << bps) - 1)
            cmap = rng.integers(0, 65536, 3 << bps) if photo == 3 else None
            end = "<>"[len(cases) % 2] if (photo, bps) != (0, 16) else "<"
            cases[f"compression {compression}, photometric {photo}, "
                  f"{bps}-bit, extra {extra}"] = _tiff(
                px, bps, photo, extra, end, compression, colormap=cmap,
                rows_per_strip=4)
    for compression in (5, 8):
        for bps in (8, 16):
            px = rng.integers(0, 1 << bps, (11, 13, 3))
            for end in "<>":
                cases[f"compression {compression}, predictor 2, {bps}-bit, "
                      f"{end}"] = _tiff(px, bps, end=end,
                                        compression=compression,
                                        predictor=2)
    for compression in (1, 5, 8):
        px = rng.integers(0, 256, (11, 13, 3))
        cases[f"compression {compression}, tiles"] = _tiff(
            px, compression=compression, tile=(16, 16))
        cases[f"compression {compression}, planar"] = _tiff(
            px, compression=compression, planar=2, rows_per_strip=5)
        cases[f"compression {compression}, planar tiles"] = _tiff(
            px, compression=compression, planar=2, tile=(16, 16))
    # tiles past the image's right and bottom edges, whose padding the
    # port decodes and drops
    px = rng.integers(0, 256, (29, 37, 3))
    for compression in (1, 32773, 5, 8):
        cases[f"compression {compression}, edge tiles"] = _tiff(
            px, compression=compression, tile=(16, 16))
    cases["LZW, predictor 2, edge tiles"] = _tiff(
        px, compression=5, predictor=2, tile=(16, 32))
    cases["Deflate, a tile wider than the image"] = _tiff(
        px, compression=8, tile=(64, 16))
    cases["Deflate, 1-bit edge tiles"] = _tiff(
        rng.integers(0, 2, (29, 37, 1)), 1, 1, compression=8,
        tile=(16, 16))
    px = rng.integers(0, 65536, (11, 13, 3))
    cases["LZW planar 16-bit"] = _tiff(px, 16, compression=5, planar=2)
    px = rng.integers(0, 256, (11, 13, 4))
    cases["Deflate planar, unassociated alpha"] = _tiff(
        px, extra=(2,), compression=8, planar=2)
    img = _smooth(37, 29, 3)
    for mode in ("1", "L", "P", "RGB", "RGBA"):
        for compression in (None, "tiff_lzw", "tiff_deflate", "packbits",
                            "tiff_adobe_deflate"):
            kw = {"compression": compression} if compression else {}
            cases[f"Pillow mode {mode}, {compression}"] = _save(
                Image.fromarray(img).convert(mode), "TIFF", **kw)
    cases["Pillow I;16"] = _save(Image.fromarray(
        rng.integers(0, 65536, (9, 7)).astype(np.uint16)), "TIFF")
    return cases


TIFF_CASES = _tiff_cases()


@pytest.mark.parametrize("case", list(TIFF_CASES))
def test_tiff_decodes_as_pil(case):
    _same_as_pil(TIFF_CASES[case])


# ----------------------------------------------------------------------
# WebP
# ----------------------------------------------------------------------
def _riff(*chunks) -> bytes:
    body = b"".join(kind + struct.pack("<I", len(p)) + p + bytes(len(p) % 2)
                    for kind, p in chunks)
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


def _payload(data: bytes, kind: bytes) -> bytes:
    """The payload of the first ``kind`` chunk of a WebP file."""
    pos = 12
    while pos < len(data):
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        if data[pos:pos + 4] == kind:
            return data[pos + 8:pos + 8 + size]
        pos += 8 + size + size % 2
    raise KeyError(kind)


def _vp8x(w, h, flags) -> tuple:
    return b"VP8X", bytes([flags, 0, 0, 0]) + (w - 1).to_bytes(3, "little") \
        + (h - 1).to_bytes(3, "little")


def _alpha_filtered(a: np.ndarray, kind: int) -> np.ndarray:
    """The forward ALPH filter (1 horizontal, 2 vertical, 3 gradient)."""
    a = a.astype(np.int64)
    pred = np.zeros_like(a)
    pred[0, 1:] = a[0, :-1]
    pred[1:, 0] = a[:-1, 0]
    if kind == 1:
        pred[1:, 1:] = a[1:, :-1]
    elif kind == 2:
        pred[1:, 1:] = a[:-1, 1:]
    else:
        pred[1:, 1:] = np.clip(a[1:, :-1] + a[:-1, 1:] - a[:-1, :-1], 0, 255)
    return ((a - pred) % 256).astype(np.uint8)


def _alph(a: np.ndarray, method: int, kind: int) -> bytes:
    """An ALPH payload: raw (0) or VP8L-coded (1) alpha under filter
    ``kind``; the coded stream is Pillow's lossless encoding of the
    filtered plane in the green channel, less its 5-byte header."""
    f = _alpha_filtered(a, kind) if kind else a
    head = bytes([method | kind << 2])
    if method == 0:
        return head + f.tobytes()
    green = np.zeros(f.shape + (3,), np.uint8)
    green[..., 1] = f
    return head + _payload(_save(green, "WEBP", lossless=True, exact=True),
                           b"VP8L")[5:]


def _anmf(frame: bytes, x: int, y: int) -> tuple:
    """An ANMF chunk of a simple WebP file's image at (x, y) (even)."""
    image = frame[12:]
    kind = image[:4]
    w, h = _image_size(kind, _payload(frame, kind))
    head = ((x // 2).to_bytes(3, "little") + (y // 2).to_bytes(3, "little")
            + (w - 1).to_bytes(3, "little") + (h - 1).to_bytes(3, "little")
            + (100).to_bytes(3, "little") + b"\x00")
    return b"ANMF", head + image


def _image_size(kind: bytes, payload: bytes):
    if kind == b"VP8 ":
        return (int.from_bytes(payload[6:8], "little") & 0x3FFF,
                int.from_bytes(payload[8:10], "little") & 0x3FFF)
    bits = int.from_bytes(payload[1:5], "little")
    return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1


class _BoolWriter:
    """RFC 6386 section 7.3's boolean encoder."""

    def __init__(self):
        self.out, self.range, self.bottom, self.count = bytearray(), 255, 0, 24

    def _carry(self):
        i = len(self.out) - 1
        while self.out[i] == 255:
            self.out[i] = 0
            i -= 1
        self.out[i] += 1

    def bit(self, prob: int, value: int) -> None:
        split = 1 + (((self.range - 1) * prob) >> 8)
        if value:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):
                self._carry()
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.count -= 1
            if not self.count:
                self.out.append(self.bottom >> 24)
                self.bottom &= (1 << 24) - 1
                self.count = 8

    def value(self, v: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.bit(128, (v >> i) & 1)

    def optional_signed(self, v: int, n: int) -> None:
        self.bit(128, v != 0)
        if v:
            self.value(abs(v), n)
            self.bit(128, v < 0)

    def finish(self) -> bytes:
        c, v = self.count, self.bottom
        if v & (1 << (32 - c)):
            self._carry()
        v = (v << (c & 7)) & 0xFFFFFFFF
        for _ in range(c >> 3):
            v = (v << 8) & 0xFFFFFFFF
        for _ in range(4):
            self.out.append(v >> 24)
            v = (v << 8) & 0xFFFFFFFF
        return bytes(self.out)


def _vp8_decisions(payload: bytes, monkeypatch):
    """Decode a VP8 frame with every boolean decision logged: (its
    header, and per macroblock row, per macroblock, its decisions in the
    first partition and in its token partition)."""
    log, seen, rows = {}, {}, []
    bit, header, mb = (vp8_module._Bool.bit, vp8_module._parse_header,
                       vp8_module._parse_mb)

    def logged_bit(self, prob):
        b = bit(self, prob)
        log.setdefault(id(self), []).append((prob, b))
        return b

    def logged_header(br):
        seen["hdr"] = header(br)
        return seen["hdr"]

    def logged_mb(br, tbr, *args):
        starts = [len(log.get(id(r), [])) for r in (br, tbr)]
        out = mb(br, tbr, *args)
        if args[-1] == 0:
            rows.append([])
        rows[-1].append([log.get(id(r), [])[n:] for r, n in
                         zip((br, tbr), starts)])
        return out

    with monkeypatch.context() as m:
        m.setattr(vp8_module._Bool, "bit", logged_bit)
        m.setattr(vp8_module, "_parse_header", logged_header)
        m.setattr(vp8_module, "_parse_mb", logged_mb)
        vp8_module.decode_vp8(payload)
    return seen["hdr"], rows


def _vp8_rewrite(payload: bytes, monkeypatch, nparts=None, skip_prob=None,
                 **changes) -> bytes:
    """The frame again with header fields changed (any but those that
    change what the macroblocks code), its token rows dealt over
    ``nparts`` partitions, and, given ``skip_prob``, a skip flag on every
    macroblock whose tokens are end-of-block codes alone (those tokens
    then dropped): the same image, coded otherwise."""
    hdr, rows = _vp8_decisions(payload, monkeypatch)
    assert hdr.skip_prob is None
    for name, value in changes.items():
        setattr(hdr, name, value)
    nparts = nparts or hdr.nparts
    bw = _BoolWriter()
    flag = lambda v: bw.bit(128, v)  # noqa: E731
    flag(hdr.colorspace)
    flag(hdr.clamp)
    flag(hdr.use_segment)
    if hdr.use_segment:
        flag(hdr.update_map)
        flag(hdr.update_data)
        if hdr.update_data:
            flag(hdr.absolute)
            for v in hdr.seg_q:
                bw.optional_signed(v, 7)
            for v in hdr.seg_f:
                bw.optional_signed(v, 6)
        if hdr.update_map:
            for v in hdr.seg_probs:
                flag(v != 255)
                if v != 255:
                    bw.value(v, 8)
    flag(hdr.simple)
    bw.value(hdr.level, 6)
    bw.value(hdr.sharpness, 3)
    flag(hdr.use_delta)
    if hdr.use_delta:
        flag(1)
        for v in hdr.ref_delta + hdr.mode_delta:
            bw.optional_signed(v, 6)
    bw.value(nparts.bit_length() - 1, 2)
    bw.value(hdr.base_q, 7)
    for v in hdr.dq:
        bw.optional_signed(v, 4)
    flag(hdr.refresh)
    default = np.frombuffer(vp8_module._COEFF_PROBS, np.uint8).reshape(
        4, 8, 3, 11)
    update = np.frombuffer(vp8_module._COEFF_UPDATE_PROBS,
                           np.uint8).reshape(4, 8, 3, 11)
    for i in np.ndindex(4, 8, 3, 11):
        changed = hdr.probs[i] != default[i]
        bw.bit(int(update[i]), changed)
        if changed:
            bw.value(int(hdr.probs[i]), 8)
    flag(skip_prob is not None)
    if skip_prob is not None:
        bw.value(skip_prob, 8)
    tokens = [[] for _ in range(nparts)]
    for y, row in enumerate(rows):
        for modes, toks in row:
            at = 2 if hdr.update_map else 0  # the segment id's two bits
            skip = all(b == 0 for _, b in toks) and len(toks) in (24, 25)
            if skip_prob is not None:
                modes = modes[:at] + [(skip_prob, int(skip))] + modes[at:]
                toks = [] if skip else toks
            for prob, v in modes:
                bw.bit(prob, v)
            tokens[y % nparts] += toks
    first = bw.finish()
    parts = []
    for decisions in tokens:
        tw = _BoolWriter()
        for prob, v in decisions:
            tw.bit(prob, v)
        parts.append(tw.finish())
    tag = len(first) << 5 | 1 << 4 | (payload[0] & 0x0E)
    return (tag.to_bytes(3, "little") + payload[3:10] + first
            + b"".join(len(p).to_bytes(3, "little") for p in parts[:-1])
            + b"".join(parts))


def _webp_cases():
    rng = np.random.default_rng(4)
    cases = {}
    for h, w in ((64, 64), (31, 47), (1, 1), (17, 9)):
        img = _smooth(h, w, h)
        noise = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        for q in (10, 50, 90, 100):
            cases[f"lossy {w}x{h} quality {q}"] = _save(img, "WEBP",
                                                        quality=q)
        cases[f"lossy {w}x{h} noise"] = _save(noise, "WEBP", quality=70)
        rgba = np.concatenate([img, rng.integers(
            0, 256, (h, w, 1)).astype(np.uint8)], 2)
        rgba[..., 3][rng.random((h, w)) < 0.3] = 0
        for aq in (100, 40):
            cases[f"lossy {w}x{h} with alpha, alpha quality {aq}"] = _save(
                rgba, "WEBP", quality=80, alpha_quality=aq)
        cases[f"lossless {w}x{h}"] = _save(img, "WEBP", lossless=True)
        cases[f"lossless {w}x{h} with alpha"] = _save(rgba, "WEBP",
                                                      lossless=True)
    cases["lossy flat (skip flags)"] = _save(
        np.full((48, 48, 3), 90, np.uint8), "WEBP", quality=20)
    view = _smooth(64, 64, 5)
    for method in (0, 2, 4, 6):
        for q in (0, 100):
            cases[f"lossless method {method} quality {q}"] = _save(
                view, "WEBP", lossless=True, method=method, quality=q)
    for colours in (2, 3, 4, 5, 16, 17, 256):
        palette = rng.integers(0, 256, (colours, 4)).astype(np.uint8)
        idx = rng.integers(0, colours, (23, 31))
        cases[f"lossless {colours} colours"] = _save(palette[idx], "WEBP",
                                                     lossless=True)
    img = _smooth(30, 22, 6)
    a = (np.add.outer(np.arange(30) * 7, np.arange(22) * 5) % 256).astype(
        np.uint8)
    lossy = _payload(_save(img, "WEBP", quality=75), b"VP8 ")
    for method in (0, 1):
        for kind in range(4):
            cases[f"ALPH {('raw', 'coded')[method]}, filter {kind}"] = _riff(
                _vp8x(22, 30, 0x10), (b"ALPH", _alph(a, method, kind)),
                (b"VP8 ", lossy))
    cases["VP8X with ICCP, EXIF and XMP"] = _riff(
        _vp8x(22, 30, 0x2C), (b"ICCP", b"\0" * 7), (b"VP8 ", lossy),
        (b"EXIF", b"II*\0"), (b"XMP ", b"<x/>"))
    frames = [Image.fromarray(_smooth(24, 32, s)) for s in range(3)]
    for lossless in (False, True):
        cases[f"animation, lossless={lossless}"] = _save(
            frames[0], "WEBP", save_all=True, append_images=frames[1:],
            lossless=lossless)
    first = _save(_smooth(16, 20, 7), "WEBP", quality=80)
    second = _save(_smooth(16, 20, 8), "WEBP", lossless=True)
    cases["animation, first frame at an offset"] = _riff(
        _vp8x(40, 30, 0x12), (b"ANIM", bytes(6)), _anmf(first, 6, 8),
        _anmf(second, 0, 0))
    return cases


WEBP_CASES = _webp_cases()


@pytest.mark.parametrize("case", list(WEBP_CASES))
def test_webp_decodes_as_pil(case):
    """RGB as Pillow's ``convert("RGB")``, and the alpha the port decodes
    as Pillow's RGBA holds it."""
    data = WEBP_CASES[case]
    _same_as_pil(data)
    np.testing.assert_array_equal(decode_webp_rgba(data), _pil(data, "RGBA"))


REWRITES = {  # header fields Pillow's encoder never writes
    "2 partitions": dict(nparts=2),
    "8 partitions": dict(nparts=8),
    "simple filter": dict(simple=1, level=20),
    "simple filter, level 63, sharpness 3": dict(simple=1, level=63,
                                                 sharpness=3),
    "normal filter, level 40, sharpness 5": dict(level=40, sharpness=5),
    "normal filter, level 10, sharpness 1": dict(level=10, sharpness=1),
    "no filter": dict(level=0),
    "frame level 0, segment levels 30": dict(level=0, seg_f=[30] * 4),
    "filter deltas": dict(use_delta=1, ref_delta=[5, 0, 0, 0],
                          mode_delta=[-9, 0, 0, 0]),
    "absolute segment values": dict(absolute=1, seg_q=[10, 40, 70, 127],
                                    seg_f=[0, 20, 40, 63]),
    "quantizer deltas": dict(dq=[3, -4, 5, -2, 7]),
    "4 partitions, simple filter, deltas": dict(
        nparts=4, simple=1, level=30, use_delta=1, ref_delta=[-4, 0, 0, 0],
        mode_delta=[12, 0, 0, 0]),
    "skip flags": dict(skip_prob=200),
    "skip flags, simple filter, 2 partitions": dict(
        skip_prob=40, simple=1, level=25, nparts=2),
}


@pytest.mark.parametrize("size", [(64, 64), (31, 47)],
                         ids=lambda s: f"{s[1]}x{s[0]}")
@pytest.mark.parametrize("case", list(REWRITES))
def test_webp_lossy_header_variants_decode_as_pil(case, size, monkeypatch):
    h, w = size
    img = _smooth(h, w, 9)
    img[h // 2:] = 100  # flat macroblocks, which code no tokens
    base = _payload(_save(img, "WEBP", quality=60), b"VP8 ")
    data = _riff((b"VP8 ", _vp8_rewrite(base, monkeypatch,
                                        **REWRITES[case])))
    got = _same_as_pil(data)
    if case == "skip flags":  # the same image, coded otherwise
        np.testing.assert_array_equal(got, _pil(_riff((b"VP8 ", base))))


# ----------------------------------------------------------------------
# what is still refused, by name (held by test_torch_port_formats.py's
# test_decode_image_names_the_formats_it_does_not_read)
# ----------------------------------------------------------------------
def _refused():
    px = np.random.default_rng(5).integers(0, 256, (6, 5, 3))
    gray = px[..., :1]
    bgr = np.random.default_rng(5).integers(0, 256, (6, 5, 4)).astype(
        np.uint8).tobytes()
    return {  # name -> (file, the words its error names)
        "JPEG-in-TIFF": (_tiff(px, compression=7), "JPEG-in-TIFF"),
        "old-style JPEG-in-TIFF": (_tiff(px, compression=6), "JPEG-in-TIFF"),
        "CCITT Group 4 TIFF": (_tiff(gray % 2, 1, 0, compression=4),
                               "CCITT"),
        "YCbCr TIFF": (_tiff(px, photo=6), "YCbCr"),
        "CMYK TIFF": (_tiff(np.concatenate([px, gray], 2), photo=5), "CMYK"),
        "CIELab TIFF": (_tiff(px, photo=8), "CIELab"),
        "float TIFF": (_tiff(gray, 8, 1, tags={339: (3, [3])}), "float"),
        "FillOrder 2 TIFF": (_tiff(gray, 8, 1, tags={266: (3, [2])}),
                             "FillOrder"),
        "rotated TIFF": (_tiff(px, tags={274: (3, [6])}), "orientation"),
        "looping IFD chain": (_tiff(px, next_ifd="loop"), "loops"),
        "BMP in JPEG": (_bmp(5, 6, 24, bgr, 40, compression=4), "JPEG"),
        "BMP of 2-bit pixels": (_bmp(5, 6, 2, bgr, 40), "depth 2"),
        "BMP bitfields 10-10-10": (_bmp(5, 6, 32, bgr, 40, compression=3,
                                        masks=(0x3FF00000, 0xFFC00, 0x3FF,
                                               0)), "bitfields"),
        "GIF of 12-bit codes": (_gif(np.zeros((2, 2), np.uint8), (2, 2),
                                     min_bits=12, lzw=b"\0"), "code size"),
        "WebP lossless version 1": (_riff((b"VP8L", b"\x2f" + (
            (1 << 29) | 3 | 3 << 14).to_bytes(4, "little") + bytes(8))),
            "version 1"),
    }


class _LsbWriter:
    """Bits written LSB first (VP8L)."""

    def __init__(self):
        self.acc, self.n = 0, 0

    def put(self, value: int, width: int) -> None:
        self.acc |= value << self.n
        self.n += width

    def data(self) -> bytes:
        return self.acc.to_bytes(-(-self.n // 8), "little")


def _vp8l_entropy_image(bw: _LsbWriter, argb: np.ndarray,
                        level0: bool) -> None:
    """An entropy-coded image of literals only: no colour cache, no meta
    codes, each channel's code all 256 symbols at 8 bits (sent through a
    code-length code of two 1-bit symbols, 0 and 8), a one-symbol
    distance code."""
    bw.put(0, 1)  # no colour cache
    if level0:
        bw.put(0, 1)  # no meta prefix codes
    for size in (280, 256, 256, 256):
        bw.put(0, 1)  # a normal code
        bw.put(12 - 4, 4)  # code-length codes for 17, 18, 0, ..., 8
        for sym in (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8):
            bw.put(1 if sym in (0, 8) else 0, 3)
        bw.put(0, 1)  # every symbol's length follows
        for sym in range(size):
            bw.put(1 if sym < 256 else 0, 1)  # length 8 (code 1) or 0
    bw.put(1, 1)  # the distance code: simple, one symbol, 1-bit, 0
    bw.put(0, 1)
    bw.put(0, 1)
    bw.put(0, 1)
    reverse = [int(f"{v:08b}"[::-1], 2) for v in range(256)]
    for p in argb.reshape(-1).tolist():
        for shift in (8, 16, 0, 24):  # green, red, blue, alpha
            bw.put(reverse[(p >> shift) & 255], 8)


def _vp8l(argb: np.ndarray, bits: int = 2, modes=None, multipliers=None,
          subtract_green: bool = False) -> bytes:
    """A VP8L payload of ``argb`` (h, w) uint32 under a predictor
    transform with the block ``modes`` (0-15), a colour transform with
    the block ``multipliers`` (green-to-red, green-to-blue, red-to-blue)
    and subtract-green, as asked; the pixels are literals."""
    h, w = argb.shape
    ch = [((argb >> s) & 255).astype(np.int64) for s in (24, 16, 8, 0)]
    a, r, g, b = ch
    bw = _LsbWriter()
    bw.put(0x2F, 8)
    bw.put(w - 1, 14)
    bw.put(h - 1, 14)
    bw.put(1, 1)
    bw.put(0, 3)
    blocks = lambda m: m[np.arange(h)[:, None] >> bits,  # noqa: E731
                         np.arange(w)[None, :] >> bits]
    coded = [c.copy() for c in ch]
    if modes is not None:  # residuals against the predictions
        full = blocks(modes)
        for y in range(h):
            for x in range(w):
                pred = _vp8l_prediction(ch, y, x, int(full[y, x]))
                for c in range(4):
                    coded[c][y, x] = (ch[c][y, x] - pred[c]) % 256
    if multipliers is not None:  # forward colour transform
        m = blocks(multipliers).astype(np.int64)
        s8 = lambda v: (v ^ 128) - 128  # noqa: E731
        g8, r8 = s8(coded[2]), s8(coded[1])
        red = (coded[1] - ((s8(m[..., 0]) * g8) >> 5)) % 256
        blue = (coded[3] - ((s8(m[..., 1]) * g8) >> 5)
                - ((s8(m[..., 2]) * r8) >> 5)) % 256
        coded[1], coded[3] = red, blue
    if subtract_green:
        coded[1] = (coded[1] - coded[2]) % 256
        coded[3] = (coded[3] - coded[2]) % 256
    for kind, sub in ((0, modes), (1, multipliers)):
        if sub is None:
            continue
        bw.put(1, 1)
        bw.put(kind, 2)
        bw.put(bits - 2, 3)
        if kind == 0:
            words = (sub.astype(np.uint32) << 8) | 0xFF000000
        else:
            words = (0xFF000000 | sub[..., 2].astype(np.uint32) << 16
                     | sub[..., 1].astype(np.uint32) << 8 | sub[..., 0])
        _vp8l_entropy_image(bw, words, False)
    if subtract_green:
        bw.put(1, 1)
        bw.put(2, 2)
    bw.put(0, 1)
    packed = (coded[0].astype(np.uint32) << 24 | coded[1].astype(np.uint32)
              << 16 | coded[2].astype(np.uint32) << 8 | coded[3])
    _vp8l_entropy_image(bw, packed, True)
    return bw.data()


def _vp8l_prediction(ch, y: int, x: int, mode: int):
    """RFC 9649's predictor ``mode`` for pixel (y, x) of the channels
    (a, r, g, b), edges included."""
    def px(yy, xx):
        return [int(c[yy, xx]) for c in ch]

    if y == 0 and x == 0:
        return [255, 0, 0, 0]
    if y == 0:
        return px(0, x - 1)
    if x == 0:
        return px(y - 1, 0)
    w = ch[0].shape[1]
    left, top, tl = px(y, x - 1), px(y - 1, x), px(y - 1, x - 1)
    tr = px(y - 1, x + 1) if x + 1 < w else px(y, 0)
    avg = lambda p, q: [(i + j) >> 1 for i, j in zip(p, q)]  # noqa: E731
    if mode == 1:
        return left
    if mode == 2:
        return top
    if mode == 3:
        return tr
    if mode == 4:
        return tl
    if mode == 5:
        return avg(avg(left, tr), top)
    if mode == 6:
        return avg(left, tl)
    if mode == 7:
        return avg(left, top)
    if mode == 8:
        return avg(tl, top)
    if mode == 9:
        return avg(top, tr)
    if mode == 10:
        return avg(avg(left, tl), avg(top, tr))
    if mode == 11:
        p_left = sum(abs(t - c) for t, c in zip(top, tl))
        p_top = sum(abs(v - c) for v, c in zip(left, tl))
        return left if p_left < p_top else top
    if mode == 12:
        return [min(max(v + t - c, 0), 255) for v, t, c in zip(left, top, tl)]
    if mode == 13:
        out = []
        for v, c in zip(avg(left, top), tl):
            d = v - c
            out.append(min(max(v + int(d / 2), 0), 255))
        return out
    return [255, 0, 0, 0]  # 0, and libwebp's 14 and 15


VP8L_TRANSFORMS = {
    "every predictor mode": dict(modes=True),
    "colour transform": dict(multipliers=True),
    "subtract green": dict(subtract_green=True),
    "all three": dict(modes=True, multipliers=True, subtract_green=True),
}


@pytest.mark.parametrize("case", list(VP8L_TRANSFORMS))
def test_webp_lossless_transforms_decode_as_pil(case):
    """Each of the 16 predictor mode values (14 and 15 predict black, as
    libwebp's sentinels do) on 4 x 4 blocks, colour multipliers of
    every sign, subtract-green: written by :func:`_vp8l`."""
    rng = np.random.default_rng(6)
    h, w = 17, 23
    img = _smooth(h, w, 6, channels=4)
    argb = (img[..., 3].astype(np.uint32) << 24 | img[..., 0].astype(
        np.uint32) << 16 | img[..., 1].astype(np.uint32) << 8 | img[..., 2])
    kw = VP8L_TRANSFORMS[case]
    bh, bw = -(-h // 4), -(-w // 4)
    modes = (np.arange(bh * bw) % 16).reshape(bh, bw) if "modes" in kw \
        else None
    mult = rng.integers(0, 256, (bh, bw, 3)) if "multipliers" in kw \
        else None
    data = _riff((b"VP8L", _vp8l(argb, 2, modes, mult,
                                 kw.get("subtract_green", False))))
    _same_as_pil(data)
    np.testing.assert_array_equal(decode_webp_rgba(data), _pil(data, "RGBA"))
    np.testing.assert_array_equal(decode_webp_rgba(data), img)


def test_webp_lossless_runs_of_one_symbol_codes():
    """Codes of one symbol read no bits: a 1024 x 512 image of five such
    codes is a few bytes, and the port fills it a run at a time (in
    well under a second, as libwebp does), equal to Pillow's; a flat
    image's codes are such codes too."""
    bits = _LsbWriter()
    for value, width in ((0x2F, 8), (1023, 14), (511, 14), (0, 4), (0, 1),
                         (0, 1), (0, 1)):
        bits.put(value, width)
    for symbol in (200, 17, 99, 255, 0):  # green, red, blue, alpha, distance
        for value, width in ((1, 1), (0, 1), (1, 1), (symbol, 8)):
            bits.put(value, width)
    for data in (_riff((b"VP8L", bits.data() + bytes(4))),
                 _save(np.full((48, 64, 3), 77, np.uint8), "WEBP",
                       lossless=True)):
        got = _same_as_pil(data)
        assert (got == got[0, 0]).all()
        np.testing.assert_array_equal(decode_webp_rgba(data),
                                      _pil(data, "RGBA"))


class _BitList:
    """Bits written LSB first (VP8L), packed at the end: cheap for long
    streams, where :class:`_LsbWriter` grows one integer."""

    def __init__(self):
        self.fields = []

    def put(self, value: int, width: int) -> None:
        self.fields.append(format(value, f"0{width}b")[::-1] if width
                           else "")

    def data(self) -> bytes:
        bits = np.frombuffer("".join(self.fields).encode(), np.uint8) - 48
        return np.packbits(bits, bitorder="little").tobytes()


def _vp8l_prefix(value: int):
    """VP8L's prefix code of ``value`` >= 1: (symbol, extra bits, their
    value)."""
    v = value - 1
    if v < 4:
        return v, 0, 0
    top = v.bit_length() - 1
    return 2 * top + (v >> (top - 1) & 1), top - 1, v & ((1 << top - 1) - 1)


def _vp8l_runs(w: int, h: int, reds, length: int, dist: int,
               mode11: bool = False) -> bytes:
    """A VP8L payload of ``w`` x ``h``: literal pixels (green 200, blue 50,
    alpha 255, the given ``reds``), then backward references of
    ``length`` pixels at distance ``dist`` to the end (the pixels after
    the literals a multiple of ``length``), under a predictor transform of
    mode 11 on 512-pixel blocks where ``mode11`` asks for it."""
    assert (w * h - len(reds)) % length == 0
    bw = _BitList()
    for value, width in ((0x2F, 8), (w - 1, 14), (h - 1, 14), (1, 1),
                         (0, 3)):
        bw.put(value, width)
    if mode11:
        bw.put(1, 1)  # a predictor transform
        bw.put(0, 2)
        bw.put(9 - 2, 3)
        words = np.full((-(-h // 512), -(-w // 512)), 0xFF000000 | 11 << 8,
                        np.uint32)
        _vp8l_entropy_image(bw, words, False)
    bw.put(0, 1)  # no more transforms
    bw.put(0, 1)  # no colour cache
    bw.put(0, 1)  # no meta prefix codes
    length_symbol, length_bits, length_extra = _vp8l_prefix(length)
    # green: 200 (code 0) and the length symbol (code 1), both of length 1,
    # through a code-length code of 0 and 1, each of length 1
    bw.put(0, 1)
    bw.put(0, 4)  # four code-length codes: 17, 18, 0, 1
    for bits in (0, 0, 1, 1):
        bw.put(bits, 3)
    bw.put(0, 1)
    for sym in range(280):
        bw.put(int(sym in (200, 256 + length_symbol)), 1)
    distinct = sorted(set(reds))
    dist_symbol, dist_bits, dist_extra = _vp8l_prefix(dist + 120)
    for symbols in (distinct, [50], [255], [dist_symbol]):  # simple codes
        bw.put(1, 1)
        bw.put(len(symbols) - 1, 1)
        bw.put(1, 1)
        for sym in symbols:
            bw.put(sym, 8)
    for red in reds:
        bw.put(0, 1)
        if len(distinct) > 1:
            bw.put(distinct.index(red), 1)
    for _ in range((w * h - len(reds)) // length):
        bw.put(1, 1)
        bw.put(length_extra, length_bits)
        bw.put(dist_extra, dist_bits)
    return bw.data() + bytes(4)


@pytest.mark.parametrize("mode11", [False, True], ids=["plain", "mode 11"])
@pytest.mark.parametrize("size,reds,length,dist", [
    ((64, 64), [10], 4095, 1), ((64, 48), [10, 20, 20], 1023, 3)],
    ids=["distance 1", "distance 3"])
def test_webp_lossless_overlapping_references_decode_as_pil(
        size, reds, length, dist, mode11):
    """Backward references longer than their distance repeat the last
    ``dist`` pixels, with and without a predictor transform over them."""
    w, h = size
    _same_as_pil(_riff((b"VP8L", _vp8l_runs(w, h, reds, length, dist,
                                            mode11))))
