"""The port's input codecs against what the JAX package reads through, and
the entry points that use them.

* YAML 1.1: ``parse_yaml`` against ``yaml.safe_load`` (value and type) on
  a table of constructs, on every config in ``configs/`` and on generated
  trees; ``dump_yaml`` against ``yaml.dump(default_flow_style=False)``
  byte for byte; a run dir written by the JAX ``Checkpoint`` whose config
  needs folding, escapes, a date and a nested list, served by the port.
* PNG: every bit depth x colour type x interlace at odd sizes, against
  Pillow's ``Image.open(...).convert("RGB")``.
* JPEG: sampling x baseline/progressive x quality x optimised tables x
  restart intervals x odd sizes, grayscale, Adobe RGB and rewritten
  sampling factors (4:1:1, 4:4:0), against Pillow bit for bit; the
  refused variants raise with their names.
* The fixtures in ``tests/torch_port_formats/`` (the views ``chip_smoke.py``
  phase 26 serves on the card, where neither Pillow nor PyYAML is
  installed): written by :func:`write_fixtures` from seeded arrays, run
  ``python -m tests.test_torch_port_formats`` from the repo root to write
  them again; held here against Pillow and ``expected.npz``.
* The served views (the JAX and the port ``_decode_views``), a WebP view
  served and an unrecognised one answered with HTTP 400, and
  ``compute_metrics`` over a JPEG dump against JAX.
* GIF, BMP, TIFF and WebP: their generated cases are in
  ``tests/test_torch_port_formats_more.py``; their fixtures, refusals,
  huge headers and damaged files here.
"""

import base64
import copy
import datetime
import functools
import io
import itertools
import json
import math
import os
import pathlib
import re
import struct
import time
import tracemalloc
import urllib.error
import urllib.request
import zlib

import numpy as np
import pytest
import torch
import yaml
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from tests.conftest import TINY_CONFIG
from tests.test_torch_port_formats_more import (_bmp, _bmp_rows, _LsbWriter,
                                                _riff, _vp8_rewrite,
                                                _vp8l_runs)
from tests.test_torch_port_formats_more import _refused as _refused_forms
from tests.test_torch_port_io import _filter_rows
from viewfusion_tpu.config import Config as JaxConfig
from viewfusion_tpu.serving import _decode_views as jax_decode_views
from viewfusion_tpu.training.checkpoint import Checkpoint as JaxCheckpoint
from viewfusion_tpu.utils.compute_metrics import \
    compute_folder_metrics as jax_folder_metrics
from viewfusion_tpu_torch.config import (Config, dump_yaml, load_config,
                                         parse_yaml)
from viewfusion_tpu_torch.data.synthetic import render_views_shaded
from viewfusion_tpu_torch.models.unet import UNet
from viewfusion_tpu_torch.serving import (ClientError, ViewFusionService,
                                          _decode_views, make_server,
                                          write_run_dir)
from viewfusion_tpu_torch.utils import compute_metrics
from viewfusion_tpu_torch.utils.convert import unet_params_to_jax
from viewfusion_tpu_torch.utils.image import decode_image, image_format
from viewfusion_tpu_torch.utils.jpeg import decode_jpeg
from viewfusion_tpu_torch.utils.png import _ADAM7, decode_png, encode_png

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "torch_port_formats"
CONFIGS = sorted((REPO / "configs").glob("*.yaml"))


def _same(a, b) -> bool:
    """Equal in value and in type, dict keys and their order included."""
    if type(a) is not type(b):
        return False
    if isinstance(a, float):
        return a == b or (math.isnan(a) and math.isnan(b))
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_same, a, b))
    if isinstance(a, dict):
        return len(a) == len(b) and all(
            _same(k, k2) and _same(v, v2)
            for (k, v), (k2, v2) in zip(a.items(), b.items()))
    return a == b


# ----------------------------------------------------------------------
# YAML reading
# ----------------------------------------------------------------------
READS = {
    "document markers": "---\na: 1\n...\n",
    "yaml directive": "%YAML 1.1\n---\na: [1, 2]\n",
    "tag directive": "%TAG !e! tag:yaml.org,2002:\n---\na: !e!int '3'\n",
    "flow sequence": "a: [1, [2, 3], {b: c}, 'd', \"e\"]",
    "flow mapping over lines": "a: {x: 1,\n   y: [2,\n     3], z: }\n",
    "flow pairs in a sequence": "[a: 1, b, ? c : d]",
    "anchor and alias": "a: &x [1, {b: 2}]\nb: *x\nc: &s 2001-01-01\nd: *s",
    "merge key": "base: &b {x: 1, y: 2}\nd:\n  <<: *b\n  x: 3\n",
    "merge list": ("b1: &b1 {x: 1, w: 0}\nb2: &b2 {x: 2, z: 1}\n"
                   "d: {<<: [*b1, *b2], z: 9}\n"),
    "literal block": "a: |\n  one\n   two\n\n  three\nb: 1\n",
    "folded block": "a: >\n  one\n  two\n\n  three\n   four\nb: 1\n",
    "chomping strip": "a: |-\n  x\n\n",
    "chomping keep": "a: >+\n  x\n\n\nb: 2\n",
    "indentation indicator": "a: |2\n    lead\n  x\n",
    "multi-line plain": "a: one\n  two\n\n  three\n",
    "multi-line single quoted": "a: 'one\n  two\n\n  it''s'\n",
    "multi-line double quoted": 'a: "one\\\n  two\n  three"\n',
    "double-quoted escapes": ('a: "\\0\\a\\b\\t\\\t\\n\\v\\f\\r\\e\\ \\"\\/\\\\'
                              '\\N\\_\\L\\P\\x41\\u00e9\\U0001F600"\n'),
    "complex keys": "? a\n: 1\n? |\n  block key\n: 2\n? b\n",
    "nested sequences": "- - 1\n  - - 2\n    - 3\n- []\n",
    "indentless sequence": "a:\n- 1\n-\n- b: c\n  d: e\n",
    "standard tags": ("a: !!str 1\nb: !!int '12'\nc: !!float '1'\n"
                      "d: !!bool yes\ne: !!null x\nf: !!seq [1]\n"
                      "g: !!map {x: 1}\nh: !!timestamp 2001-01-01\n"),
    "duplicate keys": "a: 1\nb: 2\na: 3\n",
    "ints": ("a: 0x1F\nb: -0b101\nc: 0755\nd: 190:20:30\ne: 1_000\n"
             "f: +12\ng: 09\nh: 0o17\n"),
    "floats": ("a: 1.5e+3\nb: 1e3\nc: 190:20:30.15\nd: .inf\ne: -.Inf\n"
               "f: 6.8523015e+5\ng: 1.\nh: .5\ni: 1.0e3\n"),
    "timestamps": ("a: 2001-12-14\nb: 2001-12-14t21:59:43.10-05:00\n"
                   "c: 2001-12-14 21:59:43.10\nd: 2001-12-14 21:59:43 Z\n"
                   "e: 2001-1-1\n"),
    "bools and nulls": "a: yes\nb: Off\nc: ~\nd: Null\ne: y\nf: NO\ng:\n",
    "comments": "# c\na: b #c\nd: e#f\n# end\n",
    "empty document": "",
    "binary, set, omap, pairs": ("a: !!binary aGVsbG8=\nb: !!set {x, y}\n"
                                 "c: !!omap [x: 1, y: 2]\n"
                                 "d: !!pairs [x: 1, x: 2]\n"),
}


@pytest.mark.parametrize("name", list(READS))
def test_yaml_reads_each_construct_as_pyyaml(name):
    text = READS[name]
    want = yaml.safe_load(text)
    assert _same(parse_yaml(text), want), name


REJECTS = {
    "a tab in the indentation": ("a:\n\tb: 1", "tab"),
    "a: b: c": ("a: b: c", "nested mapping on one line"),
    "an unterminated quote": ("a: 'x\n", "unterminated quoted scalar"),
    "a second document": ("a: 1\n---\nb: 2\n", "second document"),
    "an unknown tag": ("a: !foo 1", "unknown tag"),
    "an undefined alias": ("a: *x", "undefined alias"),
    "a duplicate anchor": ("a: &x 1\nb: &x 2", "duplicate anchor"),
    "an unknown escape": ('a: "\\q"', "unknown escape"),
    "a directive without ---": ("%YAML 1.1\na: 1", "directive"),
    "a merge of a scalar": ("a:\n  <<: 1", "merge key"),
    "a collection key": ("? [1, 2]\n: x", "unhashable"),
    "a bad bool": ("a: !!bool maybe", "bool"),
    "a misindented entry": ("a:\n  b: 1\n c: 2", "indentation"),
    "an unclosed flow sequence": ("a: [1, 2", "flow collection"),
    "a reserved indicator": ("a: @x", "reserved indicator"),
    "a non-printable character": ("a: \x07", "unacceptable character"),
}


@pytest.mark.parametrize("name", list(REJECTS))
def test_yaml_rejects_what_pyyaml_rejects_naming_it(name):
    text, construct = REJECTS[name]
    with pytest.raises((yaml.YAMLError, KeyError)):  # KeyError: !!bool
        yaml.safe_load(text)
    with pytest.raises(ValueError, match=construct):
        parse_yaml(text)


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_yaml_reads_and_writes_every_config_as_pyyaml(path):
    text = path.read_text()
    want = yaml.safe_load(text)
    assert _same(parse_yaml(text), want)
    assert dump_yaml(want) == yaml.dump(want, default_flow_style=False)


# ----------------------------------------------------------------------
# YAML on generated trees
# ----------------------------------------------------------------------
_WORDS = ["lorem", "ipsum", "dolor", "sit", "amet", "é", "naïve", "a:b",
          "#x", "-", "it's", '"q"', "12", "yes", "null", "x\ty", "ü" * 3]
_spaced = st.lists(st.sampled_from(_WORDS), min_size=1, max_size=40).map(
    " ".join)
_lines = st.lists(st.sampled_from(_WORDS + ["", " ", "  x"]), min_size=2,
                  max_size=6).map("\n".join)
_strings = st.one_of(st.text(max_size=12), _spaced, _lines,
                     st.sampled_from(["", "~", "0755", "1e3", "1:30",
                                      "2001-01-01", "<<", "=", "---",
                                      " lead", "trail ", "\x85\u2028"]))
_scalars = st.one_of(
    st.integers(), st.floats(allow_nan=False), st.booleans(), st.none(),
    st.dates(), st.datetimes(), _strings)
_keys = st.one_of(st.from_regex(r"[a-z_][a-z0-9_]{0,12}", fullmatch=True),
                  _spaced, st.integers(-5, 5))
_trees = st.recursive(
    _scalars, lambda inner: st.one_of(
        st.lists(inner, max_size=4),
        st.dictionaries(_keys, inner, max_size=5)),
    max_leaves=24)


@settings(derandomize=True, max_examples=200, deadline=None)
@given(st.dictionaries(_keys, _trees, max_size=6))
def test_yaml_generated_trees_both_ways_as_pyyaml(tree):
    text = yaml.dump(tree, default_flow_style=False)
    assert dump_yaml(tree) == text
    assert _same(parse_yaml(text), yaml.safe_load(text))


# ----------------------------------------------------------------------
# run dirs shared file for file
# ----------------------------------------------------------------------
def _odd_raw():
    raw = copy.deepcopy(TINY_CONFIG)
    raw["notes"] = {
        "summary": " ".join(["a spaced sentence that runs on"] * 5),
        "author": "Zoë Müller, café de la Gare",
        "created": datetime.date(2024, 5, 17),
        "grid": [[1, 2], [3, [4, 5]], []],
        "text": "line one\nline two\n",
        "flags": {"on": "on", "empty": "", "octal": "0755"},
    }
    return raw


def test_port_serves_a_jax_run_dir_whose_config_needs_yaml_1_1(tmp_path):
    """A run dir written by the JAX Checkpoint (config.yaml through
    yaml.dump: a folded line, escaped non-ASCII, a date, nested lists)
    is read and served by the port, and the port writes the same
    config.yaml byte for byte."""
    raw = _odd_raw()
    torch.manual_seed(0)
    weights = UNet(Config.from_dict(raw).unet).state_dict()
    jax_dir = str(tmp_path / "jax")
    JaxCheckpoint(jax_dir, config_yaml=JaxConfig.from_dict(raw).to_yaml()
                  ).save("best_model_all.msgpack",
                         {"params": unet_params_to_jax(weights)})
    jax_text = pathlib.Path(jax_dir, "config.yaml").read_text()
    assert raw["notes"]["summary"] not in jax_text  # folded
    assert "\\xEB" in jax_text and "2024-05-17" in jax_text
    loaded = load_config(os.path.join(jax_dir, "config.yaml")).raw
    assert loaded == raw and _same(loaded, yaml.safe_load(jax_text))

    svc = ViewFusionService(jax_dir, batch_size=2, default_steps=2,
                            device="cpu")
    img = svc.submit(np.random.default_rng(0).uniform(
        0, 1, (2, 8, 8, 3)).astype(np.float32), 0.5)
    assert img.shape == (8, 8, 3) and np.isfinite(img).all()

    port_dir = str(tmp_path / "port")
    write_run_dir(port_dir, Config.from_dict(raw), weights)
    assert pathlib.Path(port_dir, "config.yaml").read_text() == jax_text


# ----------------------------------------------------------------------
# PNG
# ----------------------------------------------------------------------
def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _packed(samples: np.ndarray, depth: int) -> np.ndarray:
    flat = samples.reshape(samples.shape[0], -1)
    if depth == 16:
        return flat.astype(">u2").view(np.uint8).reshape(len(flat), -1)
    if depth == 8:
        return flat.astype(np.uint8)
    bits = (flat[..., None] >> np.arange(depth - 1, -1, -1)) & 1
    return np.packbits(bits.astype(np.uint8).reshape(len(flat), -1), axis=1)


def make_png(samples: np.ndarray, depth: int, color: int,
             interlace: int = 0, palette=None, trns: bytes = None,
             seed: int = 0) -> bytes:
    """A PNG of (H, W, channels) samples at any depth and colour type,
    plain or Adam7, with random row filters (all five kinds) and two IDAT
    chunks."""
    rng = np.random.default_rng(seed)
    h, w, ch = samples.shape
    bpp = max(1, depth * ch // 8)
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    raw = b"".join(_filter_rows(rows, bpp, rng.integers(0, 5, len(rows)))
                   for rows in (_packed(samples[y0::dy, x0::dx], depth)
                                for x0, y0, dx, dy in passes
                                if samples[y0::dy, x0::dx].size))
    comp = zlib.compress(raw)
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0,
                                          0, interlace))
            + (_chunk(b"PLTE", palette.tobytes()) if palette is not None
               else b"")
            + (_chunk(b"tRNS", trns) if trns is not None else b"")
            + _chunk(b"IDAT", comp[:len(comp) // 2])
            + _chunk(b"IDAT", comp[len(comp) // 2:]) + _chunk(b"IEND", b""))


def _pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


PNG_CASES = [(color, depth, interlace)
             for color, depths in ((0, (1, 2, 4, 8, 16)), (2, (8, 16)),
                                   (3, (1, 2, 4, 8)), (4, (8, 16)),
                                   (6, (8, 16)))
             for depth in depths for interlace in (0, 1)]


@pytest.mark.parametrize("color,depth,interlace", PNG_CASES)
def test_png_decodes_every_form_as_pil(color, depth, interlace):
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    rng = np.random.default_rng(color * 100 + depth * 2 + interlace)
    for h, w in ((61, 67), (3, 9), (1, 1)):
        top = (1 << depth) - 1
        palette = trns = None
        if color == 3:
            n = min(256, top + 1) - (depth > 1)
            palette = rng.integers(0, 256, (n, 3), dtype=np.uint8)
            samples = rng.integers(0, n, (h, w, 1))
            trns = bytes(range(min(n, 3)))
        else:
            samples = rng.integers(0, top + 1, (h, w, channels))
            if depth == 16 and h == 61:  # gray 16: some values under 256
                samples[: h // 2] %= 300
            if color in (0, 2):  # a tRNS colour, which RGB ignores
                trns = struct.pack(">" + "H" * channels,
                                   *samples[0, 0].tolist())
        data = make_png(samples, depth, color, interlace, palette, trns)
        np.testing.assert_array_equal(decode_png(data), _pil_rgb(data))


# ----------------------------------------------------------------------
# JPEG
# ----------------------------------------------------------------------
def _photo(h: int, w: int, seed: int) -> np.ndarray:
    """Smooth shading, edges and noise: every kind of block."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(xx / 7 + c) * np.cos(yy / 5 - c)
                     for c in range(3)], -1)
    base[(xx // 9 + yy // 7) % 2 == 0] *= 0.6
    return np.clip(base + rng.normal(0, 25, base.shape), 0, 255).astype(
        np.uint8)


def _jpeg(img: np.ndarray, mode: str = "RGB", **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).convert(mode).save(buf, "JPEG", **kw)
    return buf.getvalue()


@pytest.mark.parametrize("quality", [5, 50, 90, 100])
@pytest.mark.parametrize("progressive", [False, True],
                         ids=["baseline", "progressive"])
@pytest.mark.parametrize("subsampling", ["4:4:4", "4:2:2", "4:2:0"])
def test_jpeg_decodes_as_pil(subsampling, progressive, quality):
    """Odd sizes, optimised Huffman tables and restart intervals (in
    blocks) at each sampling, mode and quality."""
    seed = quality + 7 * progressive
    for (h, w), optimize, restart in itertools.product(
            ((61, 67), (17, 5), (1, 2)), (False, True), (0, 3)):
        kw = dict(quality=quality, subsampling=subsampling,
                  progressive=progressive, optimize=optimize)
        if restart:
            kw["restart_marker_blocks"] = restart
        data = _jpeg(_photo(h, w, seed), **kw)
        np.testing.assert_array_equal(decode_jpeg(data), _pil_rgb(data),
                                      err_msg=str((h, w, kw)))


@pytest.mark.parametrize("progressive", [False, True],
                         ids=["baseline", "progressive"])
def test_jpeg_grayscale_and_adobe_rgb_decode_as_pil(progressive):
    for (h, w), quality in itertools.product(((61, 67), (9, 17)),
                                             (5, 50, 90, 100)):
        img = _photo(h, w, quality)
        for data in (_jpeg(img, "L", quality=quality,
                           progressive=progressive),
                     _jpeg(img, quality=quality, progressive=progressive,
                           keep_rgb=True)):  # Adobe marker, transform 0
            np.testing.assert_array_equal(decode_jpeg(data), _pil_rgb(data))


def _resampled(data: bytes, factors) -> bytes:
    """The baseline file with its SOF0 sampling factors rewritten; the
    MCU count stays the same, so the stream decodes as another
    sampling."""
    at = data.index(b"\xff\xc0")
    out = bytearray(data)
    for k, f in enumerate(factors):
        out[at + 11 + 3 * k] = f
    return bytes(out)


@pytest.mark.parametrize("name,source,factors,size", [
    ("4:1:1 (int_upsample)", "4:2:0", (0x41, 0x11, 0x11), (59, 61)),
    ("4:4:0 (h1v2 fancy)", "4:2:2", (0x12, 0x11, 0x11), (63, 57)),
    ("1x4 (int_upsample)", "4:2:0", (0x14, 0x11, 0x11), (64, 64)),
])
def test_jpeg_other_samplings_decode_as_pil(name, source, factors, size):
    for restart in (0, 2):
        kw = {"restart_marker_blocks": restart} if restart else {}
        data = _resampled(_jpeg(_photo(*size, 1), quality=90,
                                subsampling=source, **kw), factors)
        np.testing.assert_array_equal(decode_jpeg(data), _pil_rgb(data))


def _refused():
    base = _jpeg(_photo(16, 16, 0), quality=90)
    at = base.index(b"\xff\xc0")
    cmyk = _jpeg(_photo(16, 16, 0), "CMYK", quality=90)
    adobe = cmyk.index(b"Adobe")
    progressive = _jpeg(_photo(16, 16, 0), quality=90, progressive=True)
    last_scan = progressive.rindex(b"\xff\xda")
    return {
        # a progressive file ending before its last refinement scan:
        # libjpeg block-smooths it, which the port does not do
        "block smoothing": progressive[:last_scan] + b"\xff\xd9",
        "arithmetic": base[:at] + b"\xff\xc9" + base[at + 2:],
        "arithmetic-coded (progressive)": base[:at] + b"\xff\xca"
        + base[at + 2:],
        "lossless": base[:at] + b"\xff\xc3" + base[at + 2:],
        "hierarchical": base[:at] + b"\xff\xc5" + base[at + 2:],
        "12-bit": base[:at + 4] + b"\x0c" + base[at + 5:],
        "CMYK": cmyk,
        "YCCK": cmyk[:adobe + 11] + b"\x02" + cmyk[adobe + 12:],
        "not a JPEG": b"\x89PNG\r\n\x1a\n",
        "truncated": base[:len(base) // 2],
    }


@pytest.mark.parametrize("variant", list(_refused()))
def test_jpeg_refuses_variants_naming_them(variant):
    data = _refused()[variant]
    if variant == "block smoothing":  # PIL reads it; the port names why not
        assert _pil_rgb(data).shape == (16, 16, 3)
    with pytest.raises(ValueError, match=variant.split(" (")[0]):
        decode_jpeg(data)


# ----------------------------------------------------------------------
# the committed fixtures
# ----------------------------------------------------------------------
FORMATS = {  # name -> (file suffix, what the file is)
    "png8": (".png", "8-bit RGB PNG"),
    "png4_palette": (".png", "4-bit palette PNG"),
    "png16": (".png", "16-bit RGB PNG"),
    "png_interlaced": (".png", "Adam7-interlaced 8-bit RGB PNG"),
    "jpeg_baseline": (".jpg", "baseline 4:2:0 JPEG, quality 90"),
    "jpeg_progressive": (".jpg", "progressive 4:2:0 JPEG, quality 90"),
    "webp_lossy": (".webp", "lossy WebP, quality 90"),
    "webp_lossless": (".webp", "lossless WebP"),
    "webp_alpha": (".webp", "lossy WebP with a coded alpha ramp"),
    "gif": (".gif", "GIF of a 32-colour palette"),
    "bmp": (".bmp", "4-bit palette BMP"),
    "tiff_lzw": (".tif", "LZW RGB TIFF"),
}
_KINDS = {"png": "PNG", "jpeg": "JPEG", "webp": "WebP", "gif": "GIF",
          "bmp": "BMP", "tiff": "TIFF"}
VIEWS = 3
YAML_FIXTURE = "small-tpu-4-yaml11.yaml"


def _fixture_views() -> np.ndarray:
    """Three 64 x 64 views of one seeded synthetic object."""
    return render_views_shaded(11, image_size=64)[[0, 8, 16]]


def _encode_fixture(name: str, view: np.ndarray, seed: int) -> bytes:
    if name == "png8":
        buf = io.BytesIO()
        Image.fromarray(view).save(buf, "PNG")
        return buf.getvalue()
    if name == "png4_palette":
        buf = io.BytesIO()
        Image.fromarray(view).quantize(16).save(buf, "PNG", bits=4)
        return buf.getvalue()
    if name == "png16":  # high byte the view, low byte noise
        low = np.random.default_rng(seed).integers(0, 256, view.shape)
        return make_png(view.astype(np.int64) * 256 + low, 16, 2, seed=seed)
    if name == "png_interlaced":
        return make_png(view.astype(np.int64), 8, 2, interlace=1, seed=seed)
    if name.startswith("jpeg"):
        return _jpeg(view, quality=90, subsampling="4:2:0",
                     progressive=name == "jpeg_progressive")
    buf = io.BytesIO()
    if name == "webp_lossy":
        Image.fromarray(view).save(buf, "WEBP", quality=90)
    elif name == "webp_lossless":
        Image.fromarray(view).save(buf, "WEBP", lossless=True)
    elif name == "webp_alpha":
        ramp = (np.add.outer(np.arange(64), np.arange(64)) * 2 % 256).astype(
            np.uint8)
        Image.fromarray(np.dstack([view, ramp])).save(buf, "WEBP",
                                                     quality=90)
    elif name == "gif":
        Image.fromarray(view).quantize(32).save(buf, "GIF")
    elif name == "bmp":  # Pillow writes palette BMPs at 8 bits only
        quant = Image.fromarray(view).quantize(16)
        idx = np.asarray(quant)
        table = np.asarray(quant.getpalette()[:48]).reshape(16, 3)
        return _bmp(64, 64, 4, _bmp_rows(idx[::-1], 4), 40,
                    palette=[tuple(c) for c in table], colors=16)
    else:
        Image.fromarray(view).save(buf, "TIFF", compression="tiff_lzw")
    return buf.getvalue()


def write_fixtures(out_dir=FIXTURES) -> None:
    """Write the view fixtures, ``expected.npz`` (PIL's decode of each
    file, keyed ``<format>_<view>``) and the YAML 1.1 config
    (``configs/small-tpu-4.yaml`` rewritten)."""
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    expected = {}
    for v, view in enumerate(_fixture_views()):
        for name, (suffix, _) in FORMATS.items():
            data = _encode_fixture(name, view, seed=v)
            (out_dir / f"{name}_{v}{suffix}").write_bytes(data)
            expected[f"{name}_{v}"] = _pil_rgb(data)
    np.savez_compressed(out_dir / "expected.npz", **expected)
    (out_dir / YAML_FIXTURE).write_text(YAML11_CONFIG)


YAML11_CONFIG = """\
%YAML 1.1
---
# configs/small-tpu-4.yaml in the YAML 1.1 forms PyYAML reads: a
# directive and a document marker, an anchored schedule merged into both
# phases, flow collections, block scalars and plain scalars over lines.
# It loads to the same Config; the extra keys are ignored by it.
note: |
  The paper's config at its full widths (64 px, inner 64, mults
  1 2 3 5, attention at 16 px), for the served path.
description: >-
  A description long enough, with spaces between its words, that yaml.dump
  folds it at eighty columns when Config.to_yaml writes a run dir.
schedule: &linear {schedule: linear}
model:
  base_learning_rate: 5.0e-05
  validate_every: 20_000
  validate_from: 150000
  denoise_net: !!str unet
  log_every: 0xA
  view_fusion_params:
    beta_schedule:
      train:
        <<: *linear
        num_timesteps: 2000
        linear_start: 1.0e-06
        linear_end: 0.01
      test: {<<: *linear, num_timesteps: 1000,
             linear_start: 0.0001, linear_end: 0.09}
  denoise_net_params: {image_size: 64, in_channel: 6, out_channel: 6,
    inner_channel: 64, res_blocks: 3, attn_res: [16],
    channel_mults: [1, 2, 3, 5]}
data:
  params:
    num_workers: 1
    max_views: 6
    batch_size: 112
    train:
      params: &split
        start_shard: 0
        end_shard: 3
        path: "./data/nmr/\\
          NMR_sharded_100_4"
        mode: train
    test:
      params:
        <<: *split
        size: 448
        mode: test
    ? validation
    : params: {<<: *split, mode: val}
tpu:
  packed_views: yes
  compute_dtype: 'bfloat16'
"""


def test_fixtures_decode_through_pil_to_expected():
    expected = np.load(FIXTURES / "expected.npz")
    assert sorted(expected.files) == sorted(
        f"{name}_{v}" for name in FORMATS for v in range(VIEWS))
    total = 0
    for name, (suffix, _) in FORMATS.items():
        for v in range(VIEWS):
            data = (FIXTURES / f"{name}_{v}{suffix}").read_bytes()
            total += len(data)
            want = expected[f"{name}_{v}"]
            assert want.shape == (64, 64, 3)
            np.testing.assert_array_equal(_pil_rgb(data), want)
            np.testing.assert_array_equal(decode_image(data), want)
            assert image_format(data) == _KINDS[re.match("[a-z]+",
                                                         name).group()]
    sizes = sum(p.stat().st_size for p in FIXTURES.iterdir())
    assert sizes < 150_000, sizes


def test_yaml_fixture_loads_to_the_paper_config():
    path = FIXTURES / YAML_FIXTURE
    text = path.read_text()
    assert text == YAML11_CONFIG
    raw = parse_yaml(text)
    assert _same(raw, yaml.safe_load(text))
    cfg = load_config(str(path))
    assert cfg == load_config(str(REPO / "configs" / "small-tpu-4.yaml"))
    out = cfg.to_yaml()
    assert out == yaml.dump(raw, default_flow_style=False)
    assert len(raw["description"]) > 80 and raw["description"] not in out
    assert parse_yaml(out) == raw


@pytest.mark.parametrize("kind,data", [
    ("GIF", b"GIF89a\x01\x00"), ("BMP", b"BM\x00\x00"),
    ("TIFF", b"II*\x00\x08"), ("TIFF", b"MM\x00*\x00"),
    ("WebP", b"RIFF\x00\x00\x00\x00WEBPVP8 "), ("unrecognised", b"hello"),
] + [(words, data) for data, words in _refused_forms().values()])
def test_decode_image_names_the_formats_it_does_not_read(kind, data):
    """A file cut short names its format; an unrecognised file says so;
    each form of a read format that the port still refuses (listed under
    ROADMAP's standing differences) names itself."""
    with pytest.raises(ValueError, match=kind):
        decode_image(data)


# ----------------------------------------------------------------------
# the entry points
# ----------------------------------------------------------------------
def _payload(files) -> dict:
    return {"views": [base64.b64encode(f.read_bytes()).decode()
                      for f in files], "angle": 1.0}


@pytest.mark.parametrize("name", list(FORMATS))
def test_served_views_decode_as_the_jax_server_decodes_them(name):
    suffix = FORMATS[name][0]
    payload = _payload(FIXTURES / f"{name}_{v}{suffix}"
                       for v in range(VIEWS))
    got = _decode_views(payload)
    np.testing.assert_array_equal(got, jax_decode_views(payload))
    expected = np.load(FIXTURES / "expected.npz")
    np.testing.assert_array_equal(got, np.stack(
        [expected[f"{name}_{v}"] for v in range(VIEWS)]) / np.float32(255))


SERVED = 64  # the side of the views the tiny server below serves


@pytest.fixture(scope="module")
def post(tmp_path_factory):
    """POST a JSON body to /generate of a tiny CPU server of 64 x 64
    views: (status, reply)."""
    run_dir = str(tmp_path_factory.mktemp("run"))
    torch.manual_seed(0)
    raw = copy.deepcopy(TINY_CONFIG)  # the fixtures' 64 x 64 views
    raw["model"]["denoise_net_params"]["image_size"] = SERVED
    cfg = Config.from_dict(raw)
    write_run_dir(run_dir, cfg, UNet(cfg.unet).state_dict())
    svc = ViewFusionService(run_dir, batch_size=2, default_steps=2,
                            device="cpu")
    server = make_server(svc, host="127.0.0.1", port=0)
    import threading
    threading.Thread(target=server.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{server.server_address[1]}/generate"

    def post(body):
        req = urllib.request.Request(url, json.dumps(body).encode(),
                                     {"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    yield post
    server.shutdown()
    server.server_close()


def test_webp_view_is_a_400_naming_webp(post):
    """JAX's PIL reads a WebP view, and so does the port: its views equal
    JAX's and the service answers HTTP 200 with an image; an unrecognised
    file is still an HTTP 400 that says so, and a JPEG view of the model's
    size is served."""
    payload = _payload(FIXTURES / f"webp_lossy_{v}.webp" for v in range(2))
    want = jax_decode_views(payload)
    assert want.shape == (2, 64, 64, 3)
    np.testing.assert_array_equal(_decode_views(payload), want)
    np.testing.assert_array_equal(_decode_views(payload, SERVED), want)
    buf = io.BytesIO()
    Image.fromarray(_photo(SERVED, SERVED, 1)).save(buf, "WEBP", quality=80)
    small = {"views": [base64.b64encode(buf.getvalue()).decode()],
             "angle": 0.5, "steps": 2}
    np.testing.assert_array_equal(_decode_views(small),
                                  jax_decode_views(small))
    code, body = post(small)
    assert code == 200 and "image" in body, body
    code, body = post({"views": [base64.b64encode(b"hello").decode()],
                       "angle": 1.0})
    assert code == 400 and "unrecognised" in body["error"], body
    small = _jpeg(_photo(SERVED, SERVED, 0), quality=90, progressive=True)
    code, body = post({"views": [base64.b64encode(small).decode()],
                       "angle": 0.5, "steps": 2})
    assert code == 200 and "image" in body, body


def _jpeg_header_only(w: int, h: int, factors=(0x11, 0x11, 0x11)) -> bytes:
    """SOI, a baseline frame header of ``w`` x ``h`` with three components
    of the given sampling factors, and EOI: 25 bytes."""
    body = struct.pack(">BHHB", 8, h, w, 3) + b"".join(
        bytes([i + 1, f, 0]) for i, f in enumerate(factors))
    return (b"\xff\xd8\xff\xc0" + struct.pack(">H", len(body) + 2) + body
            + b"\xff\xd9")


def _bad_headers():
    base = (FIXTURES / "jpeg_baseline_0.jpg").read_bytes()
    sos = base.index(b"\xff\xda")
    scan = sos + 2 + struct.unpack(">H", base[sos + 2:sos + 4])[0]
    png = (b"\x89PNG\r\n\x1a\n"
           + _chunk(b"IHDR", struct.pack(">IIBBBBB", 65535, 65535, 8, 2, 0,
                                         0, 0))
           + _chunk(b"IDAT", zlib.compress(b"")) + _chunk(b"IEND", b""))
    return {  # name -> (file, words the error names)
        "JPEG of 65535x65535": (_jpeg_header_only(65535, 65535),
                                "65535x65535"),
        "JPEG sampling factor 0": (_jpeg_header_only(64, 64, (0,) * 3),
                                   "sampling factors 0x0"),
        "JPEG scan cut short": (base[:scan + 20] + b"\xff\xd9", "truncated"),
        "PNG of 65535x65535": (png, "65535x65535"),
        **_huge_and_broken(),
    }


def _msb_codes(codes, width: int) -> bytes:
    """Codes of one width packed MSB first (TIFF), zero-padded."""
    n = -(-width * len(codes) // 8)
    acc = 0
    for c in codes:
        acc = acc << width | c
    return (acc << (8 * n - width * len(codes))).to_bytes(n, "big")


@functools.lru_cache(maxsize=None)
def _huge_and_broken():
    """GIF, BMP, TIFF and WebP headers of huge frames, and streams with a
    fault the decoders must name: (file, words)."""
    gif = (b"GIF89a" + struct.pack("<HHBBB", 65535, 65535, 0, 0, 0)
           + b"\x2c" + struct.pack("<HHHHB", 0, 0, 1, 1, 0) + b"\x08\x00;")
    bmp = (b"BM" + struct.pack("<IHHI", 54, 0, 0, 54)
           + struct.pack("<IIIHHIIIIII", 40, 65535, 65535, 1, 24, 0, 0, 0, 0,
                         0, 0))
    tiff = _tiff_header({256: 65535, 257: 65535, 258: 8, 262: 1, 273: 8,
                         279: 1})
    vp8 = (b"\x10\x02\x00\x9d\x01\x2a" + struct.pack("<HH", 16383, 16383)
           + bytes(16))
    vp8l = b"\x2f" + (16383 | 16383 << 14).to_bytes(4, "little") + bytes(8)
    vp8x = bytes(4) + (16383).to_bytes(3, "little") * 2
    buf = io.BytesIO()
    Image.fromarray(_photo(32, 32, 3)).save(buf, "WEBP", quality=80)
    lossy = buf.getvalue()
    frame = lossy[20:20 + struct.unpack("<I", lossy[16:20])[0]]
    two = bytearray(_vp8_rewrite(frame, pytest.MonkeyPatch(), nparts=2))
    first = (two[0] | two[1] << 8 | two[2] << 16) >> 5
    two[10 + first:13 + first] = b"\xff\xff\xff"  # past the data
    # an 8 x 8 VP8L image: no transform, cache or meta codes, then a green
    # code whose code-length code has lengths 1 and 2 only: not complete
    bits = _LsbWriter()
    for value, width in ((0x2F, 8), (7, 14), (7, 14), (0, 4), (0, 1),
                         (0, 1), (0, 1), (0, 1), (0, 4), (1, 3), (2, 3),
                         (0, 3), (0, 3)):
        bits.put(value, width)
    incomplete = bits.data() + bytes(4)
    gif_codes = _LsbWriter()
    for code in (4, 1, 7):
        gif_codes.put(code, 3)
    # one row as wide as the pixel limit lets it be, whose delta code
    # skips 255 rows: as many pixels as 45 GB
    wide = 178956970
    rle = _bmp(wide, 1, 8, b"\x05\x01\x00\x02\x00\x00\x00\xff\x00\x01",
               compression=1, palette=[(10, 20, 30), (200, 100, 0)])
    # 12289 x 12289 pixels (under the limit) of runs 4096 long at
    # distance 1 under predictor mode 11: about 75 KB
    runs = _vp8l_runs(12289, 12289, [10], 4096, 1, mode11=True)
    return {
        "BMP RLE8 of 178956970x1 with a delta of 255 rows": (
            rle, "178956970x1"),
        "VP8L of 12289x12289 in long runs": (_riff((b"VP8L", runs)),
                                             "12289x12289"),
        **{f"TIFF of 1x1 in 65520x65520 {name} tiles": (_tiff_header(
            {256: 1, 257: 1, 258: 8, 259: compression, 262: 1,
             322: 65520, 323: 65520, 324: 8, 325: len(tile)}, tile),
            "tiles of 65520x65520") for name, compression, tile in (
                ("Deflate", 8, _zeros_deflated(8 << 20)),
                ("LZW", 5, _zeros_lzw(8 << 20)))},
        "GIF of 65535x65535": (gif, "65535x65535"),
        "BMP of 65535x65535": (bmp, "65535x65535"),
        "TIFF of 65535x65535": (tiff, "65535x65535"),
        "VP8 of 16383x16383": (_riff((b"VP8 ", vp8)), "16383x16383"),
        "VP8L of 16384x16384": (_riff((b"VP8L", vp8l)), "16384x16384"),
        "VP8X canvas of 16384x16384": (_riff((b"VP8X", vp8x)),
                                       "16384x16384"),
        # clear, a literal, then code 7 where the table ends at 6
        "GIF LZW code past the table": (
            b"GIF89a" + struct.pack("<HHBBB", 2, 2, 0, 0, 0) + b"\x2c"
            + struct.pack("<HHHHB", 0, 0, 2, 2, 0) + b"\x02\x02"
            + gif_codes.data() + b"\x00;", "past the table"),
        # clear, a literal, then code 300 where the table ends at 258
        "TIFF LZW code past the table": (
            _tiff_header({256: 2, 257: 2, 258: 8, 259: 5, 262: 1, 273: 8,
                          279: 4}, _msb_codes([256, 65, 300], 9)),
            "past the table"),
        "TIFF IFD chain that loops": (_tiff_header(
            {256: 2, 257: 2, 258: 8, 262: 1, 273: 8, 279: 4}, bytes(4),
            loop=True), "loops"),
        "VP8 partition past the data": (_riff((b"VP8 ", bytes(two))),
                                        "partition"),
        "VP8L Huffman code not complete": (_riff((b"VP8L", incomplete)),
                                           "not complete"),
    }


def _zeros_deflated(n: int) -> bytes:
    return zlib.compress(bytes(n), 9)


def _zeros_lzw(n: int, first: int = 0) -> bytes:
    """libtiff's LZW strip of ``n`` bytes: ``first``, then zeros (a gray
    image Pillow writes in one strip)."""
    img = np.zeros((n // 4096, 4096), np.uint8)
    img[0, 0] = first
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "TIFF", compression="tiff_lzw",
                              strip_size=n)
    data = buf.getvalue()
    tags = Image.open(io.BytesIO(data)).tag_v2
    (off,), (count,) = tags[273], tags[279]
    return data[off:off + count]


def _tiff_header(tags: dict, pixels: bytes = b"", loop: bool = False):
    """A little-endian TIFF: 8-byte header, ``pixels`` at offset 8, one
    IFD of LONG tags (their one value each)."""
    ifd = 8 + len(pixels) + len(pixels) % 2
    body = b"II*\x00" + struct.pack("<I", ifd) + pixels + bytes(
        len(pixels) % 2) + struct.pack("<H", len(tags))
    for tag in sorted(tags):
        body += struct.pack("<HHII", tag, 4, 1, tags[tag])
    return body + struct.pack("<I", ifd if loop else 0)


@pytest.mark.parametrize("case", list(_bad_headers()))
def test_bad_headers_are_400s_without_allocating(case, post):
    """A request of a few bytes whose header declares a huge frame (PIL
    refuses it as a decompression bomb) in any format, or a frame larger
    than the service's views, a sampling factor of 0, scan data that ends
    early, an LZW code past its table, a TIFF IFD chain that loops or
    tiles over the pixel limit, a VP8 partition size past the data or a
    VP8L prefix code that is not complete gets HTTP 400 naming the fault,
    and decoding it takes next to no memory and time."""
    data, words = _bad_headers()[case]
    payload = {"views": [base64.b64encode(data).decode()], "angle": 1.0}
    start = time.perf_counter()
    tracemalloc.start()
    try:
        with pytest.raises(ClientError, match=words):
            _decode_views(payload, SERVED)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert time.perf_counter() - start < 2.0
    assert peak < 4 << 20, peak
    code, body = post(payload)
    assert code == 400 and words in body["error"], body


@pytest.mark.parametrize("name", list(FORMATS))
def test_damaged_files_raise_value_errors_only(name, tmp_path):
    """Cut short or with one byte changed (PNG chunks given their CRC
    again, so the damage reaches the decoder), a fixture decodes or raises
    a ValueError, which the server answers with a 400 and
    ``compute_metrics`` with the file's name."""
    suffix = FORMATS[name][0]
    data = (FIXTURES / f"{name}_0{suffix}").read_bytes()
    rng = np.random.default_rng(sorted(FORMATS).index(name))
    damaged = [data[:k] for k in rng.integers(0, len(data), 40)]
    for _ in range(200):
        out = bytearray(data)
        out[rng.integers(2, len(data))] = rng.integers(0, 256)
        damaged.append(_recrc(bytes(out)) if suffix == ".png"
                       else bytes(out))
    for item in damaged:
        try:
            img = decode_image(item)
        except ValueError:
            continue
        assert img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3
    (tmp_path / f"cut{suffix}").write_bytes(data[:len(data) // 2])
    with pytest.raises(ValueError, match=f"cut{suffix}"):
        compute_metrics._load_dir(str(tmp_path), exts=(suffix,))


def _recrc(data: bytes) -> bytes:
    """A PNG with the CRC of each chunk computed again."""
    out, pos = bytearray(data[:8]), 8
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        out += data[pos:pos + 8] + body + struct.pack(
            ">I", zlib.crc32(kind + body))
        pos += 12 + n
    return bytes(out)


def test_png_inflates_no_more_than_its_header_needs():
    """A 1x1 PNG whose data inflates to 64 MiB: PIL reads its one pixel,
    and so does the port, without inflating the rest."""
    raw = b"\x00\x01\x02\x03" + bytes(64 << 20)
    data = (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", 1, 1, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw, 9)) + _chunk(b"IEND", b""))
    tracemalloc.start()
    try:
        got = decode_png(data)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    np.testing.assert_array_equal(got, _pil_rgb(data))
    assert peak < 4 << 20, peak


@pytest.mark.parametrize("case", ["BMP RLE8 delta", "TIFF Deflate tile",
                                  "TIFF LZW tile"])
def test_rle_and_tiles_keep_no_more_than_the_image(case):
    """A 100000 x 1 RLE8 BMP whose delta code skips 255 rows (25.6 MB of
    pixels), and a 1 x 1 TIFF in one 8192 x 8192 tile (64 MiB): Pillow
    reads each, and so does the port, without holding the pixels past the
    image's end (LZW's string table for a run of zeros holds 7.5 MB of
    the 16 MiB allowed)."""
    if case.startswith("BMP"):
        data = _bmp(100000, 1, 8,
                    b"\x05\x01\x00\x02\x00\x00\x00\xff\x00\x01",
                    compression=1, palette=[(10, 20, 30), (200, 100, 0)])
    else:
        deflate = "Deflate" in case
        tile = zlib.compress(b"\x7f" + bytes((64 << 20) - 1), 9) \
            if deflate else _zeros_lzw(64 << 20, 127)
        data = _tiff_header({256: 1, 257: 1, 258: 8,
                             259: 8 if deflate else 5, 262: 1,
                             322: 8192, 323: 8192, 324: 8,
                             325: len(tile)}, tile)
    tracemalloc.start()
    try:
        got = decode_image(data)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    np.testing.assert_array_equal(got, _pil_rgb(data))
    assert peak < 16 << 20, peak


def test_compute_metrics_over_a_jpeg_dump_matches_jax(tmp_path):
    """The JPEG fixtures as the generated dump, their source views as PNG
    targets: the port's PSNR and SSIM equal JAX's (within 1e-6) and those
    of PIL's decode of the JPEGs."""
    gen, tgt = tmp_path / "generated", tmp_path / "target"
    gen.mkdir()
    tgt.mkdir()
    expected = np.load(FIXTURES / "expected.npz")
    decoded, sources = [], []
    for name in ("jpeg_baseline", "jpeg_progressive"):
        for v, view in enumerate(_fixture_views()):
            i = len(decoded)
            (gen / f"{i:04d}.jpg").write_bytes(
                (FIXTURES / f"{name}_{v}.jpg").read_bytes())
            (tgt / f"{i:04d}.png").write_bytes(encode_png(view))
            decoded.append(expected[f"{name}_{v}"])
            sources.append(view)
    none = str(tmp_path / "none.npz")
    want = jax_folder_metrics(str(gen), str(tgt), batch_size=4,
                              lpips_weights=none)
    got = compute_metrics.compute_folder_metrics(
        str(gen), str(tgt), batch_size=4, lpips_weights=none, device="cpu")
    assert got["count"] == want["count"] == 6
    assert abs(got["psnr"] - want["psnr"]) <= 1e-6 * abs(want["psnr"])
    assert abs(got["ssim"] - want["ssim"]) <= 1e-6
    for folder, arrays in ((gen, decoded), (tgt, sources)):
        for i, arr in enumerate(arrays):
            (folder / f"{i:04d}.png").write_bytes(encode_png(arr))
            (folder / f"{i:04d}.jpg").unlink(missing_ok=True)
    again = compute_metrics.compute_folder_metrics(
        str(gen), str(tgt), batch_size=4, lpips_weights=none, device="cpu")
    assert again == got


if __name__ == "__main__":
    write_fixtures()
    print(f"wrote {FIXTURES}")
