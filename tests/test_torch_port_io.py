"""The port's own codecs against the libraries the JAX package uses:
YAML (against PyYAML), msgpack (against flax's serialization), PNG and
GIF (against PIL), and the image and metric helpers against the JAX
package's.  The port imports none of those libraries; only this test
does, to hold the codecs to them.
"""

import io
import json
import pathlib
import struct
import zlib

import flax.serialization as flax_ser
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image, ImageSequence

from tests.conftest import TINY_CONFIG
from viewfusion_tpu.config import Config as JaxConfig
from viewfusion_tpu.ops import metrics as jax_metrics
from viewfusion_tpu.utils import image as jax_image
from viewfusion_tpu_torch.config import Config, dump_yaml, parse_yaml
from viewfusion_tpu_torch.ops import metrics
from viewfusion_tpu_torch.training import checkpoint as ckpt
from viewfusion_tpu_torch.utils import image
from viewfusion_tpu_torch.utils.png import decode_png, encode_png

REPO = pathlib.Path(__file__).resolve().parents[1]
CONFIGS = sorted((REPO / "configs").glob("*.yaml"))


# ----------------------------------------------------------------------
# YAML
# ----------------------------------------------------------------------
@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_yaml_reads_every_repo_config_like_pyyaml(path):
    text = path.read_text()
    want = yaml.safe_load(text)
    assert parse_yaml(text) == want
    out = dump_yaml(want)
    assert out == yaml.dump(want, default_flow_style=False)
    assert yaml.safe_load(out) == want and parse_yaml(out) == want


def test_yaml_both_directions_with_the_jax_config_dump():
    jax_text = JaxConfig.from_dict(TINY_CONFIG).to_yaml()
    assert parse_yaml(jax_text) == yaml.safe_load(jax_text) == TINY_CONFIG
    port_text = Config.from_dict(TINY_CONFIG).to_yaml()
    assert yaml.safe_load(port_text) == TINY_CONFIG
    assert port_text == jax_text


ODD = {"tiny": 1e-6, "sci": "1e-4", "empty": "", "ints": [0, -3, 10_000],
       "seq": [1, {"x": 2, "y": [3, "a b"]}], "emap": {}, "eseq": [],
       "yes": "yes", "none": None, "on": True, "off": False, "one": 1.0,
       "inf": float("inf"), "ninf": float("-inf"), "colon": "a: b",
       "dash": "-x", "lr": 5e-05, "tilde": "~", "big": 1e16,
       "apos": "it's", "octal": "0755", "hash": "x #y", "quoted": '"q"',
       "date": "2001-01-01", "null_word": "null", "path": "./data/x_1",
       "num_key": {1: "one", 2.5: "two"}}


def test_yaml_odd_scalars_round_trip_like_pyyaml():
    text = yaml.dump(ODD, default_flow_style=False)
    assert parse_yaml(text) == yaml.safe_load(text) == ODD
    ours = dump_yaml(ODD)
    assert ours == text
    assert yaml.safe_load(ours) == ODD and parse_yaml(ours) == ODD
    nan = parse_yaml("a: .nan\nb: .NaN\n")
    assert all(np.isnan(v) for v in nan.values())
    text = ('# comment\nk: "x\\ty\\u00e9"  # trailing\nl:\n  - 1\n'
            "  - 'two'\nm: 1_000\nn: +.5\no: -1.5e+3\n")
    assert parse_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text,construct", [
    ("a: [1, 2]", "flow sequence"), ("a: {b: 1}", "flow mapping"),
    ("a: &x 1", "anchor"), ("a: *x", "alias"), ("a: !!str 1", "tag"),
    ("a: |\n  x", "block scalar"), ("a: >\n  x", "block scalar"),
    ("a: 0x1F", "hex int"), ("a: 1:30", "sexagesimal"),
    ("a: 2001-01-01", "timestamp"), ("---\na: 1", "document marker"),
    ("a: b: c", "nested mapping on one line"),
    ("a: x\n  y", "multi-line plain scalar"), ("? a\n: b", "complex key"),
    ("a: 'x", "unterminated quoted scalar"), ("a:\n\t b: 1", "tab"),
    ("a: 1\na: 2", "duplicate key"), ("%YAML 1.1\na: 1", "directive"),
])
def test_yaml_refuses_what_it_does_not_take(text, construct):
    """Each construct the port's first YAML reader refused: what
    ``yaml.safe_load`` reads, the port reads equal in value and type; what
    it rejects (an undefined alias, ``a: b: c``, an unterminated quote, a
    tab in the indentation, a directive with no ``---``), the port rejects
    too, naming the construct."""
    try:
        want = yaml.safe_load(text)
    except yaml.YAMLError:
        with pytest.raises(ValueError, match=construct):
            parse_yaml(text)
    else:
        got = parse_yaml(text)
        assert got == want and type(got) is type(want)
        for key, value in want.items():
            assert type(got[key]) is type(value), (key, got[key], value)


# ----------------------------------------------------------------------
# msgpack
# ----------------------------------------------------------------------
def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "extra": json.dumps({"it": 3, "run_id": "ab12"}),
        "state": {
            "params": {"params": {
                "conv": {"kernel": rng.normal(size=(3, 3, 4, 5)).astype(
                    np.float32), "bias": np.zeros(5, np.float32)}}},
            "opt_state": {"0": {"count": np.asarray(7, np.int32),
                                "mu": {"a": rng.normal(size=(70,))},
                                "nu": {}},
                          "1": {"count": np.int32(7)}},
            "step": np.zeros((), np.int32),
            "big": np.arange(70_000, dtype=np.float32),
            "ints": rng.integers(-9, 9, (3, 2), dtype=np.int64),
            "u8": rng.integers(0, 255, (17,), dtype=np.uint8),
            "flags": np.array([True, False]),
        },
        "scalars": [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32, -1,
                    -32, -33, -128, -129, -2 ** 15 - 1, -2 ** 31 - 1,
                    -2 ** 63, 1.5, None, True, False, b"\x00" * 300,
                    "s" * 40, "t" * 300, "u" * 70_000],
        "wide": {str(i): i for i in range(20)},
    }


def _equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(map(_equal, a, b))
    if isinstance(a, (np.ndarray, np.generic)):
        return (type(a) is type(b) and a.dtype == b.dtype
                and a.shape == b.shape and np.array_equal(a, b))
    return type(a) is type(b) and a == b


def _sorted(tree):
    """flax serializes through tree_map, which sorts dict keys."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree, key=str)}
    if isinstance(tree, list):
        return [_sorted(v) for v in tree]
    return tree


@pytest.mark.parametrize("chunk", [None, 4096])
def test_msgpack_matches_flax_both_ways(monkeypatch, chunk):
    """flax's bytes decode to equal values, the port's bytes restore
    through flax to equal values, and with sorted keys the bytes are
    flax's own.  ``chunk`` lowers MAX_CHUNK_SIZE on both sides, so the
    70000-float array becomes flax's chunked-array map."""
    if chunk is not None:
        monkeypatch.setattr(flax_ser, "MAX_CHUNK_SIZE", chunk)
        monkeypatch.setattr(ckpt, "MAX_CHUNK_SIZE", chunk)
    tree = _tree()
    theirs = flax_ser.msgpack_serialize(tree)
    assert (b"__msgpack_chunked_array__" in theirs) == (chunk is not None)
    assert _equal(ckpt.unpackb(theirs), flax_ser.msgpack_restore(theirs))
    ours = ckpt.packb(tree)
    assert _equal(flax_ser.msgpack_restore(ours), ckpt.unpackb(ours))
    assert _equal(ckpt.unpackb(ours), flax_ser.msgpack_restore(theirs))
    assert ckpt.packb(_sorted(tree)) == theirs


def test_msgpack_takes_torch_tensors_and_refuses_garbage():
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3).t()
    out = flax_ser.msgpack_restore(ckpt.packb({"t": t}))
    np.testing.assert_array_equal(out["t"], t.numpy())
    with pytest.raises(ValueError, match="trailing"):
        ckpt.unpackb(ckpt.packb(1) + b"\x00")
    with pytest.raises(ValueError, match="truncated"):
        ckpt.unpackb(ckpt.packb({"a": np.zeros(9)})[:-3])
    with pytest.raises(ValueError, match="unknown ext"):
        ckpt.unpackb(b"\xd4\x07\x00")
    with pytest.raises(TypeError):
        ckpt.packb({"a": object()})


# ----------------------------------------------------------------------
# PNG
# ----------------------------------------------------------------------
def _pil_png(img: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format="PNG", **kw)
    return buf.getvalue()


def _pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


@pytest.mark.parametrize("mode", ["L", "RGB", "P", "P+tRNS", "LA", "RGBA"])
@pytest.mark.parametrize("pattern", ["noise", "ramp"])
def test_png_decodes_pil_files_as_pil_converts_them(mode, pattern):
    rng = np.random.default_rng(1)
    if pattern == "noise":
        arr = rng.integers(0, 256, (13, 17, 4), dtype=np.uint8)
    else:
        arr = np.linspace(0, 255, 13 * 17 * 4).reshape(13, 17, 4).astype(
            np.uint8)
    kw = {}
    if mode.startswith("P"):
        img = Image.fromarray(arr[..., :3]).convert(
            "P", palette=Image.ADAPTIVE, colors=50)
        if mode == "P+tRNS":
            kw["transparency"] = 3
    else:
        chans = {"L": 1, "RGB": 3, "LA": 2, "RGBA": 4}[mode]
        img = Image.fromarray(arr[..., 0] if chans == 1 else arr[..., :chans],
                              mode)
    for optimize in (False, True):
        data = _pil_png(img, optimize=optimize, **kw)
        np.testing.assert_array_equal(decode_png(data), _pil_rgb(data))


def _filter_rows(rows: np.ndarray, bpp: int, kinds) -> bytes:
    """The PNG spec's filters applied to (H, stride) uint8 rows."""
    out, prev = [], np.zeros(rows.shape[1], np.int32)
    for row, kind in zip(rows.astype(np.int32), kinds):
        left = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        if kind == 0:
            pred = np.zeros_like(row)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prev
        elif kind == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        out.append(bytes([kind]) + ((row - pred) % 256).astype(
            np.uint8).tobytes())
        prev = row
    return b"".join(out)


def _png_file(header: bytes, idat: bytes, plte: bytes = b"") -> bytes:
    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
            + (chunk(b"PLTE", plte) if plte else b"")
            + chunk(b"IDAT", zlib.compress(idat)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("color,bpp", [(0, 1), (2, 3), (3, 1), (4, 2),
                                       (6, 4)])
def test_png_every_row_filter_decodes_as_pil(color, bpp):
    """Rows written with each of the five filters (twice over, in
    mixed order) decode exactly as PIL decodes them."""
    rng = np.random.default_rng(color)
    h, w = 10, 9
    hi = 20 if color == 3 else 256
    pix = rng.integers(0, hi, (h, w * bpp), dtype=np.uint8)
    kinds = [0, 1, 2, 3, 4, 4, 3, 2, 1, 0]
    header = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    plte = rng.integers(0, 256, 20 * 3, dtype=np.uint8).tobytes() \
        if color == 3 else b""
    data = _png_file(header, _filter_rows(pix, bpp, kinds), plte)
    np.testing.assert_array_equal(decode_png(data), _pil_rgb(data))


def test_png_encoder_output_decodes_through_pil_exactly():
    rng = np.random.default_rng(2)
    for img in (rng.integers(0, 256, (13, 17, 3), dtype=np.uint8),
                np.linspace(0, 255, 64 * 64 * 3).reshape(64, 64, 3).astype(
                    np.uint8), np.zeros((1, 1, 3), np.uint8)):
        data = encode_png(img)
        np.testing.assert_array_equal(_pil_rgb(data), img)
        np.testing.assert_array_equal(decode_png(data), img)
    with pytest.raises(ValueError, match="uint8"):
        encode_png(np.zeros((4, 4), np.uint8))


def test_png_refuses_interlaced_16_bit_and_corrupt_files():
    """16-bit and interlaced files, once refused, decode as PIL converts
    them (16-bit gray clipped at 255, as PIL's "I;16" -> RGB does);
    corrupt files and other formats still raise."""
    gray16 = _pil_png(Image.fromarray(
        np.arange(64, dtype=np.uint16).reshape(8, 8) * 1000))
    np.testing.assert_array_equal(decode_png(gray16), _pil_rgb(gray16))
    assert decode_png(gray16)[0, :3, 0].tolist() == [0, 255, 255]
    header = struct.pack(">IIBBBBB", 2, 2, 8, 2, 0, 0, 1)
    # Adam7 over 2 x 2: passes 1, 6 and 7 (1 + 3, 1 + 3 and 1 + 6 bytes)
    interlaced = _png_file(header, bytes(
        [0, 10, 20, 30, 1, 40, 50, 60, 2, 1, 2, 3, 4, 5, 6]))
    np.testing.assert_array_equal(decode_png(interlaced),
                                  _pil_rgb(interlaced))
    with pytest.raises(ValueError, match="shorter"):
        decode_png(_png_file(header, b"\x00" * 14))
    good = encode_png(np.zeros((4, 4, 3), np.uint8))
    bad = bytearray(good)
    bad[40] ^= 0xFF
    with pytest.raises(ValueError, match="CRC"):
        decode_png(bytes(bad))
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(b"GIF89a")


# ----------------------------------------------------------------------
# GIF and image helpers
# ----------------------------------------------------------------------
def _gif_frames(data: bytes):
    img = Image.open(io.BytesIO(data))
    return img, [np.asarray(f.convert("RGB")).astype(int)
                 for f in ImageSequence.Iterator(img)]


def test_gif_opens_in_pil_lossless_within_256_colours(tmp_path):
    rng = np.random.default_rng(3)
    colours = rng.integers(0, 256, (40, 3), dtype=np.uint8)
    frames = [colours[rng.integers(0, 40, (30, 45))] for _ in range(5)]
    path = str(tmp_path / "a.gif")
    image.save_gif(frames, path, duration=0.1)
    img, got = _gif_frames(open(path, "rb").read())
    assert img.n_frames == 5 and img.size == (45, 30)
    assert img.info["duration"] == 100 and img.info["loop"] == 0
    for f, g in zip(frames, got):
        np.testing.assert_array_equal(g, f)


def test_gif_over_256_colours_is_within_the_palette_bound():
    """Over 256 colours the palette is the uniform 6x7x6 cube: each
    channel is off by at most half a level, 25.5 of 255 for red and blue
    and 21.25 for green (PIL quantises GIF frames too)."""
    rng = np.random.default_rng(4)
    frames = [rng.uniform(0, 1, (40, 50, 3)).astype(np.float32)
              for _ in range(3)]
    img, got = _gif_frames(image.encode_gif(frames, 0.2))
    assert img.n_frames == 3 and img.size == (50, 40)
    for f, g in zip(frames, got):
        err = np.abs(g - image.to_uint8(f).astype(int)).max(axis=(0, 1))
        assert err[0] <= 25.5 and err[1] <= 21.25 and err[2] <= 25.5


def test_grid_and_uint8_match_the_jax_helpers(tmp_path):
    rng = np.random.default_rng(5)
    imgs = rng.uniform(-0.5, 1.5, (7, 5, 6, 3)).astype(np.float32)
    for kw in ({}, {"nrow": 3, "padding": 1, "pad_value": 0.9},
               {"nrow": 7, "scale_each": True}):
        want = jax_image.make_grid(imgs, **kw)
        np.testing.assert_array_equal(image.make_grid(imgs, **kw), want)
        np.testing.assert_array_equal(image.to_uint8(want),
                                      jax_image.to_uint8(want))
    path = str(tmp_path / "g.png")
    image.save_png(imgs[0], path)
    np.testing.assert_array_equal(np.asarray(Image.open(path)),
                                  jax_image.to_uint8(imgs[0]))


# ----------------------------------------------------------------------
# PSNR / SSIM
# ----------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(3, 8, 8, 3), (2, 64, 64, 3),
                                   (2, 5, 7, 3)])
def test_psnr_and_ssim_match_jax_within_1e_6(shape):
    """Image pairs of the kind eval scores: random images against noisy
    and rescaled copies of themselves, and unrelated images.  SSIM within
    1e-6 absolute; PSNR within 1e-6 of its value (at 10-30 dB one f32
    ulp is 1e-6 to 2e-6, and the f32 mean of the squared error differs
    from the exact one by a few ulp in either package)."""
    rng = np.random.default_rng(6)
    a = rng.uniform(0, 1, shape).astype(np.float32)
    pairs = [(a, np.clip(a + rng.normal(0, s, shape), 0, 1).astype(
        np.float32)) for s in (0.02, 0.2)]
    pairs.append((a, rng.uniform(0, 1, shape).astype(np.float32)))
    pairs.append((a, (0.5 * a + 0.25).astype(np.float32)))
    for x, y in pairs:
        tx, ty = torch.from_numpy(x), torch.from_numpy(y)
        jx, jy = jnp.asarray(x), jnp.asarray(y)
        np.testing.assert_allclose(
            metrics.compute_ssim(tx, ty).numpy(),
            np.asarray(jax_metrics.compute_ssim(jx, jy)), rtol=0, atol=1e-6)
        np.testing.assert_allclose(
            metrics.compute_psnr(tx, ty).numpy(),
            np.asarray(jax_metrics.compute_psnr(jx, jy)), rtol=1e-6, atol=0)
    np.testing.assert_array_equal(metrics.gaussian_window(7, 1.5),
                                  jax_metrics.gaussian_window(7, 1.5))
