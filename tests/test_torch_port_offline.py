"""The port's offline tools against the JAX package's, on the CPU: LPIPS
(``ops/lpips.py``), the folder metric CLI (``utils/compute_metrics.py``),
the NMR sharder (``data/prep.py``) and the YAML reader it uses.

LPIPS runs with the random VGG16-shaped weights of
tests/test_lpips_and_offline.py (the real weights need downloads).

Tolerances and why:
  * LPIPS: <= 1e-5 relative per image (f32 on both sides; XLA's and
    PyTorch's CPU convolutions sum in other orders through 13 layers;
    measured ~1e-7);
  * folder PSNR within 1e-6 relative and SSIM within 1e-6 absolute
    (the same f32 formulas on the same pixels; PIL and the port's PNG
    codec decode the same bytes);
  * shards: byte-identical files.
"""

import glob
import os

import numpy as np
import pytest
import torch
import yaml

from tests.test_configs_and_cli import _make_nmr_zip
from tests.test_lpips_and_offline import _random_lpips_weights
from viewfusion_tpu.data import prep as jax_prep
from viewfusion_tpu.ops.lpips import load_lpips as jax_load_lpips
from viewfusion_tpu.utils.compute_metrics import \
    compute_folder_metrics as jax_folder_metrics
from viewfusion_tpu_torch.config import parse_yaml
from viewfusion_tpu_torch.data import prep
from viewfusion_tpu_torch.data.nmr import NMRStream
from viewfusion_tpu_torch.ops.lpips import load_lpips
from viewfusion_tpu_torch.utils import compute_metrics
from viewfusion_tpu_torch.utils.png import encode_png

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    return _random_lpips_weights(
        str(tmp_path_factory.mktemp("lpips") / "w.npz"))


# ---------------------------------------------------------------------
# LPIPS
# ---------------------------------------------------------------------
def test_lpips_matches_jax(weights):
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (3, 32, 32, 3)).astype(np.float32)
    y = np.clip(x + rng.normal(0, 0.3, x.shape), -1, 1).astype(np.float32)
    want = np.asarray(jax_load_lpips(weights)(x, y))
    fn = load_lpips(weights, device="cpu")
    got = fn(torch.from_numpy(x), torch.from_numpy(y))
    assert got.shape == (3,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=0)
    assert np.all(want > 0)
    same = fn(x, x).numpy()  # arrays are taken too
    np.testing.assert_allclose(same, 0.0, atol=1e-6)


def test_lpips_missing_weights_raises_the_jax_error(tmp_path):
    path = str(tmp_path / "nope.npz")
    with pytest.raises(FileNotFoundError) as want:
        jax_load_lpips(path)
    with pytest.raises(FileNotFoundError) as got:
        load_lpips(path, device="cpu")
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------
# compute_metrics
# ---------------------------------------------------------------------
def _write_pairs(root, n=5, size=16, seed=2):
    rng = np.random.default_rng(seed)
    gen, tgt = root / "a_generated", root / "b_target"
    gen.mkdir(parents=True)
    tgt.mkdir(parents=True)
    for i in range(n):
        img = rng.integers(0, 256, (size, size, 3)).astype(np.uint8)
        noisy = np.clip(img.astype(int) + rng.integers(-20, 20, img.shape),
                        0, 255).astype(np.uint8)
        (tgt / f"{i:04d}.png").write_bytes(encode_png(img))
        (gen / f"{i:04d}.png").write_bytes(encode_png(noisy))
    return str(gen), str(tgt)


def _close_metrics(got, want):
    assert got["count"] == want["count"]
    assert abs(got["psnr"] - want["psnr"]) <= 1e-6 * abs(want["psnr"])
    assert abs(got["ssim"] - want["ssim"]) <= 1e-6
    assert ("lpips" in got) == ("lpips" in want)
    if "lpips" in want:
        assert abs(got["lpips"] - want["lpips"]) <= 1e-5 * want["lpips"]


@pytest.mark.parametrize("with_lpips", [False, True])
def test_folder_metrics_match_jax(tmp_path, weights, with_lpips):
    """Two batches (batch size 3 over 5 images), with and without LPIPS."""
    gen, tgt = _write_pairs(tmp_path)
    w = weights if with_lpips else str(tmp_path / "missing.npz")
    want = jax_folder_metrics(gen, tgt, batch_size=3, lpips_weights=w)
    got = compute_metrics.compute_folder_metrics(gen, tgt, batch_size=3,
                                                 lpips_weights=w,
                                                 device="cpu")
    _close_metrics(got, want)


def test_cli_root_layout(tmp_path, weights, capsys):
    gen, tgt = _write_pairs(tmp_path)
    want = jax_folder_metrics(gen, tgt, lpips_weights=weights)
    got = compute_metrics.main(["--root", str(tmp_path), "--lpips-weights",
                                weights, "--device", "cpu"])
    _close_metrics(got, want)
    out = capsys.readouterr().out
    assert f"psnr: {got['psnr']}" in out and "lpips: " in out


def test_jpeg_is_refused_with_its_name(tmp_path):
    """JPEGs, once refused, are read as the JAX script's PIL reads them:
    a dump of baseline, progressive, 4:2:0, 4:2:2, grayscale and
    restart-marked ``.jpg``/``.jpeg`` files among the PNGs gives the JAX
    numbers; so does a WebP file named ``.jpg``, which both read by its
    content; a file neither reads raises, naming the file and that its
    format is unrecognised."""
    from PIL import Image

    gen, tgt = _write_pairs(tmp_path, n=2)
    rng = np.random.default_rng(3)
    saves = [dict(quality=90), dict(quality=50, progressive=True),
             dict(quality=75, subsampling=1, restart_marker_blocks=2),
             dict(quality=95, subsampling=0, optimize=True)]
    for i, kw in enumerate(saves):
        for folder in (gen, tgt):
            img = Image.fromarray(rng.integers(0, 256, (16, 16, 3),
                                               dtype=np.uint8))
            if i == 3:
                img = img.convert("L")
            ext = ".jpeg" if i % 2 else ".jpg"
            img.save(os.path.join(folder, f"{i + 2:04d}{ext}"), "JPEG", **kw)
    want = jax_folder_metrics(gen, tgt, batch_size=4)
    assert want["count"] == 6
    got = compute_metrics.compute_folder_metrics(gen, tgt, batch_size=4,
                                                 device="cpu")
    _close_metrics(got, want)
    for folder in (gen, tgt):
        Image.fromarray(rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)
                        ).save(os.path.join(folder, "0009.jpg"), "WEBP")
    want = jax_folder_metrics(gen, tgt, batch_size=4)
    assert want["count"] == 7
    _close_metrics(compute_metrics.compute_folder_metrics(
        gen, tgt, batch_size=4, device="cpu"), want)
    with open(os.path.join(gen, "0009.jpg"), "wb") as f:
        f.write(b"neither reads this")
    with pytest.raises(OSError):  # PIL's UnidentifiedImageError
        jax_folder_metrics(gen, tgt, batch_size=4)
    with pytest.raises(ValueError, match="0009.jpg.*unrecognised"):
        compute_metrics.compute_folder_metrics(gen, tgt, device="cpu")


def test_cuda_is_the_default_device(tmp_path):
    gen, tgt = _write_pairs(tmp_path, n=1)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        compute_metrics.main(["--generated", gen, "--target", tgt])


# ---------------------------------------------------------------------
# the sharder and its YAML
# ---------------------------------------------------------------------
NMR_CATEGORIES = {
    "02691156": "airplane", "02828884": "bench", "02933112": "cabinet",
    "02958343": "car", "03001627": "chair", "03211117": "display",
    "03636649": "lamp", "03691459": "speaker", "04090263": "rifle",
    "04256520": "sofa", "04379243": "table", "04401088": "telephone",
    "04530566": "watercraft"}


@pytest.mark.parametrize("quoted", [True, False])
def test_parse_yaml_reads_nmr_metadata_as_safe_load(quoted):
    """The 13 NMR category ids: ``03001627``, ``03211117`` and others use
    only the digits 0-7, so unquoted they are octal ints to PyYAML;
    ``02691156`` has a 9 and stays a string.  The port reads both forms
    as yaml.safe_load does, types included."""
    q = "'" if quoted else ""
    doc = "".join(f"{q}{cid}{q}:\n  id: {q}{cid}{q}\n  name: {name}\n"
                  for cid, name in NMR_CATEGORIES.items())
    want = yaml.safe_load(doc)
    got = parse_yaml(doc)
    assert got == want and list(got) == list(want)
    for (gk, gv), (wk, wv) in zip(got.items(), want.items()):
        assert type(gk) is type(wk) and type(gv["id"]) is type(wv["id"])
    if not quoted:
        assert got[0o3001627]["name"] == "chair" and "02691156" in got


def _tree(root):
    out = {}
    for path in sorted(glob.glob(os.path.join(root, "**", "*"),
                                 recursive=True)):
        if os.path.isfile(path):
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


PREP_CASES = {
    # (zip classes, views, shard kwargs): JAX's three cases
    "roundtrip": (("02691156",), 4, dict(percent=100, shard_cnt=1)),
    "zero_capacity": (("02691156",), 4, dict(percent=100, shard_cnt=4)),
    "withheld": (("aaa", "bbb"), 2, dict(shard_cnt=1,
                                         withheld=["class-aaa"])),
}


@pytest.mark.parametrize("case", sorted(PREP_CASES))
def test_prep_shards_are_byte_identical_to_jax(tmp_path, case):
    classes, views, kw = PREP_CASES[case]
    src = tmp_path / "src"
    src.mkdir()
    _make_nmr_zip(str(src / "NMR_Dataset.zip"), classes=classes, views=views)
    withheld = kw.get("withheld", ())
    sizes = prep.get_dataset_size(str(src), withheld)
    assert sizes == jax_prep.get_dataset_size(str(src), withheld)
    dests = []
    for name, mod in (("jax", jax_prep), ("port", prep)):
        dest = mod.shard_dataset(str(src), sizes, str(tmp_path / name),
                                 split="train", views_per_scene=views, **kw)
        dests.append(dest)
    assert os.path.relpath(dests[0], tmp_path / "jax") == \
        os.path.relpath(dests[1], tmp_path / "port")
    want, got = _tree(dests[0]), _tree(dests[1])
    assert want and got == want
    if case == "zero_capacity":
        assert list(got) == ["NMR-train-00.tar"]
    shards = sorted(glob.glob(os.path.join(dests[1], "*.tar")))
    stream = NMRStream(shards, "test", shuffle_buffer=0, resample=False,
                       total_views=views, native=False)
    out = list(stream)
    assert len(out) == sum(sizes["train"].values())
    assert out[0]["all_views"].shape == (views, 8, 8, 3)


def test_prep_cli_matches_jax(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    _make_nmr_zip(str(src / "NMR_Dataset.zip"), classes=("02691156", "bbb"),
                  views=24, scenes_per_class=3)
    for name, mod in (("jax", jax_prep), ("port", prep)):
        mod.main(["-s", str(src), "-d", str(tmp_path / name), "-sc", "2",
                  "--raw"])
    want, got = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    assert any(k.endswith(".rec") for k in want)
    assert got == want
