"""The port's data pipeline (viewfusion_tpu_torch.data) against the JAX
package's on synthetic shards at 8 px: the same shards, seeds and
arguments give the same batches bit for bit, the port's shards hold the
JAX shards' pixels, the raw twins are the same files, and the native
reader agrees with the codec.
"""

import os
import shutil

import numpy as np
import pytest

from viewfusion_tpu.config import SplitConfig as JaxSplit
from viewfusion_tpu.data import nmr as jax_nmr
from viewfusion_tpu.data import rawrec as jax_rawrec
from viewfusion_tpu.data import synthetic as jax_synthetic
from viewfusion_tpu_torch.config import SplitConfig
from viewfusion_tpu_torch.data import native_loader, nmr, rawrec, synthetic
from viewfusion_tpu_torch.data.tario import iter_tar_samples


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """Train and test shards written by each package (2 train shards of
    5 objects, 1 test shard of 6), 8 px."""
    root = tmp_path_factory.mktemp("shards")
    out = {}
    for name, mod in (("jax", jax_synthetic), ("port", synthetic)):
        d = str(root / name)
        mod.make_synthetic_shards(d, "train", num_objects=10, num_shards=2,
                                  image_size=8, seed=1)
        mod.make_synthetic_shards(d, "test", num_objects=6, image_size=8,
                                  seed=2, family="shaded")
        out[name] = d
    return out


def _split(cls, path, mode, end=1):
    return cls(path=path, mode=mode, start_shard=0,
               end_shard=end if mode == "train" else 0)


def _equal_batches(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if k == "scene_hash":
            assert a[k] == b[k]
        else:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _batches(mod, split_cls, path, mode, n, batch=4, batcher=None, **kw):
    stream = mod.create_nmr_stream(_split(split_cls, path, mode), **kw)
    it = iter(mod.Batcher(stream, batch, **(batcher or {})))
    return [next(it) for _ in range(n)] if n else list(it), stream


CASES = {
    "train-resampled": dict(mode="train", n=7, shuffle_buffer=6, seed=3),
    "train-u8-trimmed": dict(
        mode="train", n=5, shuffle_buffer=4, seed=4, out_dtype=np.uint8,
        needed_keys=["target", "cond", "angle"], n_cond_views=3,
        batcher=dict(n_cond_views=3, keys=["target", "cond", "angle"])),
    "test": dict(mode="test", n=0, shuffle_buffer=0, seed=5,
                 resample=False),
    "train-process-test": dict(mode="train", n=6, shuffle_buffer=0,
                               seed=6, process_mode="test"),
    "relative": dict(mode="train", n=5, shuffle_buffer=3, seed=7,
                     relative=True, batcher=dict(n_cond_views=3)),
    "pad-final": dict(mode="test", n=0, shuffle_buffer=0, seed=8,
                      resample=False, batcher=dict(pad_final=True),
                      batch=4),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_stream_batches_equal_the_jax_stream(shards, case):
    kw = dict(CASES[case])
    mode, n = kw.pop("mode"), kw.pop("n")
    batch, batcher = kw.pop("batch", 4), kw.pop("batcher", None)
    want, _ = _batches(jax_nmr, JaxSplit, shards["jax"], mode, n, batch,
                       batcher, native=False, **kw)
    got, stream = _batches(nmr, SplitConfig, shards["jax"], mode, n, batch,
                           batcher, native=False, **kw)
    assert stream.reader == "codec" and len(got) == len(want) > 0
    for a, b in zip(got, want):
        _equal_batches(a, b)
    if case == "pad-final":  # 6 samples in batches of 4: one padded batch
        np.testing.assert_array_equal(got[-1]["eval_mask"], [1, 1, 0, 0])


def test_port_shards_decode_to_the_jax_shards_pixels(shards):
    """The port's generator writes the same objects (its own PNG
    encoder), and the JAX stream reads them as it reads its own."""
    for mode in ("train", "test"):
        want, _ = _batches(jax_nmr, JaxSplit, shards["jax"], mode, 3,
                           native=False, seed=9)
        got, _ = _batches(jax_nmr, JaxSplit, shards["port"], mode, 3,
                          native=False, seed=9)
        for a, b in zip(got, want):
            _equal_batches(a, b)
    tar = os.path.join(shards["port"], "NMR-train-00.tar")
    keys = [s["__key__"] for s in iter_tar_samples(tar)]
    assert keys == [f"synth-train-{i:05d}" for i in range(5)]


def test_raw_twins_are_the_jax_files_and_feed_the_same_batches(
        shards, tmp_path):
    """rawrec twins the port converts are byte for byte the JAX ones, and
    both streams pick them (``reader == "rawrec"``) and agree."""
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    shutil.copytree(shards["jax"], jdir)
    shutil.copytree(shards["jax"], pdir)
    jax_paths = jax_rawrec.convert_shard_dir(jdir)
    port_paths = rawrec.convert_shard_dir(pdir)
    for a, b in zip(jax_paths, port_paths):
        assert open(a, "rb").read() == open(b, "rb").read()
    for mode, n in (("train", 5), ("test", 1)):
        want, _ = _batches(jax_nmr, JaxSplit, jdir, mode, n, seed=10,
                           shuffle_buffer=3)
        got, stream = _batches(nmr, SplitConfig, pdir, mode, n, seed=10,
                               shuffle_buffer=3)
        assert stream.reader == "rawrec"
        for a, b in zip(got, want):
            _equal_batches(a, b)
    reader = rawrec.RawShardReader(port_paths[:1], resample=False,
                                   shuffle=False)
    (views, key), = list(reader)[:1]
    assert views.shape == (24, 8, 8, 3) and key == "synth-test-00000"
    reader.close()


def test_native_reader_agrees_with_the_codec(shards):
    """The native library builds here (g++, zlib); its reader and the
    codec give equal views for every object (the native order is the
    threads' completion order, so objects are matched by key)."""
    if not native_loader.native_available():
        pytest.skip(f"the native loader did not build: "
                    f"{native_loader.build_error()}")
    urls = [os.path.join(shards["port"], f"NMR-train-0{i}.tar")
            for i in range(2)]
    reader = native_loader.NativeShardReader(urls, n_threads=2,
                                             resample=False)
    native = dict((k, v) for v, k in reader)
    reader.close()
    codec = {s["__key__"]: nmr.decode_views_u8(s)
             for u in urls for s in iter_tar_samples(u)}
    assert native.keys() == codec.keys() and len(codec) == 10
    for k in codec:
        np.testing.assert_array_equal(native[k], codec[k])
    stream = nmr.create_nmr_stream(
        _split(SplitConfig, shards["port"], "train"), seed=0)
    assert stream.reader == "native"


def test_native_true_raises_with_the_compiler_message(monkeypatch,
                                                      tmp_path, shards):
    """``tpu.native_loader: true`` with a library that does not build
    raises with the compiler's output; ``None`` falls back to the
    codec and says why."""
    broken = tmp_path / "vfloader.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native_loader, "_SOURCE", broken)
    monkeypatch.setattr(native_loader, "_BUILD", tmp_path / "_build")
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "_error", None)
    monkeypatch.setattr(native_loader, "_tried", False)
    split = _split(SplitConfig, shards["port"], "train")
    with pytest.raises(RuntimeError,
                       match="(?s)did not build.*expected unqualified-id"):
        nmr.create_nmr_stream(split, native=True)
    stream = nmr.create_nmr_stream(split)
    assert stream.reader == "codec"
    assert "failed" in native_loader.build_error()
