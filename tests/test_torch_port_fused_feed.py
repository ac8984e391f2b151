"""The port's fused feed (``viewfusion_tpu_torch/training/fused_feed.py``,
``tpu.fused_feed``) against the JAX package's, on the CPU: the same
bytes, an exact round trip, and a training run equal bit for bit to the
split feed's (tests/test_fused_feed.py's cases)."""

import copy
import json
import os

import numpy as np
import pytest
import torch

from tests.conftest import TINY_CONFIG
from viewfusion_tpu.training import fused_feed as jax_fused
from viewfusion_tpu_torch.config import dump_yaml
from viewfusion_tpu_torch.data.synthetic import make_synthetic_shards
from viewfusion_tpu_torch.training.fused_feed import pack_batch, unpack_batch
from viewfusion_tpu_torch.training.trainer import Experiment, ExperimentArgs

torch.set_num_threads(2)


def _prepped(dtype, b=4, n=3, hw=8, rows=7):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (b, 1 + n, hw, hw, 3)).astype(dtype)
    return {
        "target": img[:, 0].copy(),
        "cond": img[:, 1:].copy(),
        # negative, tiny and large floats all survive the i32 bitcast
        "angle": np.asarray([-1.5, 0.0, 3.14159, 1e-30], np.float32)[:b],
        "view_count": rng.integers(1, n + 1, (b,)).astype(np.int32),
        "sample_idx": rng.integers(0, b, (rows,)).astype(np.int32),
        "view_idx": rng.integers(0, n, (rows,)).astype(np.int32),
    }


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_pack_batch_bytes_equal_jax(dtype):
    prepped = _prepped(dtype)
    got, want = pack_batch(prepped), jax_fused.pack_batch(prepped)
    assert set(got) == set(want) == {"img", "meta_b", "meta_r"}
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        assert got[k].tobytes() == want[k].tobytes(), k


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_pack_unpack_round_trip_is_exact(dtype):
    prepped = _prepped(dtype)
    fused = {k: torch.from_numpy(v) for k, v in pack_batch(prepped).items()}
    out = unpack_batch(fused)
    for k in ("target", "cond", "angle", "view_count", "sample_idx",
              "view_idx"):
        assert out[k].dtype == torch.from_numpy(prepped[k]).dtype, k
        np.testing.assert_array_equal(out[k].numpy(), prepped[k], err_msg=k)
    # the angle's bits, not only its value
    assert out["angle"].numpy().tobytes() == prepped["angle"].tobytes()


def test_pack_rejects_relative_channels():
    prepped = _prepped(np.float32)
    prepped["cond"] = np.concatenate([prepped["cond"]] * 2, axis=-1)
    with pytest.raises(ValueError, match="absolute"):
        pack_batch(prepped)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("data"))
    make_synthetic_shards(d, "train", num_objects=8, image_size=8)
    make_synthetic_shards(d, "test", num_objects=8, image_size=8)
    return d


def _config(tmp_path, data_dir, name, model=None, **tpu):
    raw = copy.deepcopy(TINY_CONFIG)
    raw["model"].update(model or {})
    for split in ("train", "test"):
        raw["data"]["params"][split]["params"]["path"] = data_dir
    raw["data"]["params"]["batch_size"] = 4
    raw["model"].update(max_it=5, log_every=1, checkpoint_every=0,
                        validate_every=0)
    raw["tpu"].update({"packed_views": True, "native_loader": False,
                       "lr_warmup": 1, **tpu})
    path = str(tmp_path / f"{name}.yaml")
    with open(path, "w") as f:
        f.write(dump_yaml(raw))
    return path


def test_fused_feed_trains_as_the_split_feed_bit_for_bit(data_dir, tmp_path):
    """The loss of every step (log_every 1) with the fused feed equals the
    split feed's exactly: the unpacked tensors are the same numbers."""
    def losses(fused):
        exp = Experiment(ExperimentArgs(
            config=_config(tmp_path, data_dir, f"f{fused}",
                           fused_feed=fused), train=True, device="cpu"),
            log_root=str(tmp_path / f"logs{fused}"))
        exp.train()
        with open(os.path.join(exp.out_dir, "metrics.jsonl")) as f:
            return [json.loads(line)["loss"] for line in f]

    on, off = losses(True), losses(False)
    assert len(on) == 6 and on == off


@pytest.mark.parametrize("model,tpu", [({}, {"packed_views": False}),
                                       ({"relative": True}, {})])
def test_fused_feed_needs_packed_absolute_conditioning(data_dir, tmp_path,
                                                       model, tpu):
    path = _config(tmp_path, data_dir, "bad", model, fused_feed=True, **tpu)
    with pytest.raises(ValueError, match="tpu.fused_feed requires"):
        Experiment(ExperimentArgs(config=path, train=True, device="cpu"),
                   log_root=str(tmp_path / "logs"))
