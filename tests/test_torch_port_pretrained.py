"""The port's converter of reference checkpoints
(viewfusion_tpu_torch/utils/torch_convert.py) against the JAX package's
(viewfusion_tpu/utils/torch_convert.py), on the CPU at TINY_CONFIG's
sizes.

The input is a file in the reference's layout (``best_model_all.pt``):
``{"model": <ViewFusion state_dict>, "optimizer": <Adam state>, "it",
"t", "run_id", "ssim", "psnr"}``, the UNet's entries under
``denoise_fn.`` (seeded port UNet weights, perturbed so that no bias is
zero), the schedule buffers beside them, and scalars of the types the
reference may have saved: an int ``it``, a float ``t``, a str ``run_id``,
a numpy-float ``ssim`` and a 0-d tensor ``psnr``.
"""

import copy
import json
import os
import pathlib
import pickle
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import serialization

from tests.conftest import TINY_CONFIG
from viewfusion_tpu.config import Config as JaxConfig
from viewfusion_tpu.data.synthetic import make_synthetic_shards
from viewfusion_tpu.serving import ViewFusionService as JaxService
from viewfusion_tpu.training.trainer import Experiment as JaxExperiment
from viewfusion_tpu.training.trainer import ExperimentArgs as JaxArgs
from viewfusion_tpu.utils import torch_convert as jax_convert
from viewfusion_tpu_torch import cli
from viewfusion_tpu_torch.config import Config, dump_yaml, load_config
from viewfusion_tpu_torch.models.unet import UNet
from viewfusion_tpu_torch.serving import ViewFusionService
from viewfusion_tpu_torch.training.checkpoint import packb, unpackb
from viewfusion_tpu_torch.utils import torch_convert
from viewfusion_tpu_torch.utils.convert import unet_state_dict_from_jax

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parents[1]
EXTRAS = {"it": 1000, "t": 3600.5, "run_id": "ab12cd34",
          "ssim": np.float64(0.8125), "psnr": torch.tensor(21.5)}


def _tiny_raw(data_dir=""):
    raw = copy.deepcopy(TINY_CONFIG)
    for split in ("train", "test"):
        raw["data"]["params"][split]["params"]["path"] = data_dir
    raw["data"]["params"]["test"]["params"]["size"] = 4
    raw["data"]["params"]["batch_size"] = 4
    raw["tpu"].update(native_loader=False, eval_dump_images=True)
    return raw


def _payload(dtype=torch.float32, seed=0):
    """A reference-layout checkpoint payload of TINY_CONFIG's UNet."""
    torch.manual_seed(seed)
    unet = UNet(Config.from_dict(TINY_CONFIG).unet)
    rng = np.random.default_rng(seed)
    model = {}
    for k, v in unet.state_dict().items():
        noise = rng.normal(0.0, 0.05, v.shape).astype(np.float32)
        model[f"denoise_fn.{k}"] = (v + torch.from_numpy(noise)).to(dtype)
    for name in torch_convert.SCHEDULE_BUFFERS:
        model[name] = torch.from_numpy(rng.uniform(0, 1, 8))
    params = list(unet.parameters())
    optimizer = {
        "state": {i: {"step": torch.tensor(1000.0),
                      "exp_avg": torch.zeros_like(p),
                      "exp_avg_sq": torch.zeros_like(p)}
                  for i, p in enumerate(params)},
        "param_groups": [{"lr": 5e-5, "betas": (0.9, 0.999), "eps": 1e-8,
                          "weight_decay": 0, "amsgrad": False,
                          "params": list(range(len(params)))}]}
    return {"model": model, "optimizer": optimizer, **EXTRAS}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Per dtype, the .pt and the run dirs both converters made of it."""
    root = tmp_path_factory.mktemp("pretrained")
    out = {}
    for dtype in (torch.float32, torch.float16):
        name = str(dtype).split(".")[1]
        pt = str(root / f"{name}.pt")
        torch.save(_payload(dtype), pt)
        jax_dir, port_dir = str(root / f"jax_{name}"), str(root / f"port_{name}")
        jax_convert.convert_checkpoint_file(
            pt, jax_dir, JaxConfig.from_dict(_tiny_raw()))
        torch_convert.convert_checkpoint_file(
            pt, port_dir, Config.from_dict(_tiny_raw()))
        out[name] = (pt, jax_dir, port_dir)
    return out


def _read(run_dir):
    with open(os.path.join(run_dir, "best_model_all.msgpack"), "rb") as f:
        return f.read()


def _sorted(tree):
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def _assert_trees_equal(a, b, path=""):
    assert isinstance(a, dict) == isinstance(b, dict), path
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{path}/{k}")
    else:
        assert type(a) is type(b), path
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, path
            np.testing.assert_array_equal(a, b, err_msg=path)
        else:
            assert a == b, path


@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_both_converters_write_the_same_run_dir(files, dtype):
    """The two msgpack files decode to equal trees (arrays bit-equal, in
    the stored dtype: f16 stays f16, as the JAX converter keeps it) with
    equal extras of equal types (``it`` a float).  Their bytes differ
    only in the order of map keys: flax writes them sorted (its tree_map
    rebuilds each dict in sorted order), the port in the name map's
    order, so the port's tree written with sorted keys is the JAX file
    byte for byte.  The config.yaml files parse to equal dicts and are
    equal byte for byte (the port's YAML writer writes yaml.dump's sorted
    block style)."""
    _, jax_dir, port_dir = files[dtype]
    theirs = serialization.msgpack_restore(_read(jax_dir))
    ours = unpackb(_read(port_dir))
    _assert_trees_equal(ours["state"], theirs["state"])
    leaves = jax.tree_util.tree_leaves(ours["state"])
    assert {a.dtype for a in leaves} == {np.dtype(dtype)}
    extra = json.loads(ours["extra"])
    _assert_trees_equal(extra, json.loads(theirs["extra"]))
    assert extra == {"it": 1000.0, "t": 3600.5, "run_id": "ab12cd34",
                     "ssim": 0.8125, "psnr": 21.5}
    assert isinstance(extra["it"], float)
    assert _read(port_dir) != _read(jax_dir)
    assert packb(_sorted(ours)) == _read(jax_dir)
    cfg = [pathlib.Path(d, "config.yaml").read_text()
           for d in (port_dir, jax_dir)]
    assert yaml.safe_load(cfg[0]) == yaml.safe_load(cfg[1])
    assert cfg[0] == cfg[1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_stripped_state_dict_loads_strict_and_equals_jax(dtype):
    """convert_unet_state_dict gives the reference names without the
    prefix, as f32 tensors, which a UNet loads with strict=True; they
    equal bit for bit what unet_state_dict_from_jax makes of the JAX
    converter's tree (the claim of models/unet.py's docstring)."""
    model = _payload(dtype)["model"]
    cfg = Config.from_dict(TINY_CONFIG)
    ours = torch_convert.convert_unet_state_dict(model, cfg.unet)
    unet = UNet(cfg.unet)
    assert list(ours) == list(unet.state_dict())
    unet.load_state_dict(ours, strict=True)
    jax_tree = jax_convert.convert_unet_state_dict(
        {k: v.numpy() for k, v in model.items()},
        JaxConfig.from_dict(TINY_CONFIG).unet)
    want = unet_state_dict_from_jax(jax_tree)
    assert set(want) == set(ours)
    for k, v in ours.items():
        assert v.dtype == torch.float32, k
        assert torch.equal(v, want[k]), k
        assert torch.equal(unet.state_dict()[k], v), k


def test_services_serve_each_others_converted_run_dir(files):
    """The JAX service on the port-written run dir and the port's on the
    JAX-written one: one DDIM generation on the same y_T and draws
    agrees within the serving tolerance of test_torch_port_experiment."""
    _, jax_dir, port_dir = files["float32"]
    jax_svc = JaxService(port_dir, batch_size=2)
    port_svc = ViewFusionService(jax_dir, batch_size=2, device="cpu")
    rng = np.random.default_rng(2)
    b, steps = 3, 4
    counts = np.array([1, 3, 2], np.int32)
    cond = rng.uniform(0, 1, (b, 3, 8, 8, 3)).astype(np.float32)
    angle = rng.uniform(0, 6.3, b).astype(np.float32)
    y_t = rng.normal(size=(b, 8, 8, 3)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want = np.asarray(jax_svc.model.generate_ddim(
        jax_svc.params, key, cond, counts, angle, num_steps=steps, y_t=y_t))
    draws, k = [], jax.random.split(key)[1]
    for _ in range(steps):
        k, sub = jax.random.split(k)
        draws.append(torch.from_numpy(np.array(
            jax.random.normal(sub, (b, 8, 8, 3), jnp.float32))))
    got = port_svc.model.generate_ddim(
        torch.from_numpy(cond), torch.from_numpy(counts.astype(np.int64)),
        torch.from_numpy(angle), num_steps=steps, y_t=torch.from_numpy(y_t),
        noise=draws).numpy()
    assert np.abs(got - want).max() <= 5e-5


@pytest.mark.parametrize("key", [
    "denoise_fn.mid.0.res_block.block1.block.0.weight",
    "denoise_fn.final_conv.block.0.bias",
    "denoise_fn.downs.3.attn.qkv.weight",
])
def test_missing_key_raises_naming_it(key):
    model = _payload()["model"]
    del model[key]
    cfg = Config.from_dict(TINY_CONFIG)
    with pytest.raises(KeyError, match=key.replace(".", r"\.")):
        torch_convert.convert_unet_state_dict(model, cfg.unet)
    with pytest.raises(KeyError):
        jax_convert.convert_unet_state_dict(
            {k: v.numpy() for k, v in model.items()},
            JaxConfig.from_dict(TINY_CONFIG).unet)


def test_misshapen_entry_and_foreign_globals_raise(tmp_path):
    """A weight of another shape than the config's UNet raises
    ValueError naming it; a file that needs a global beyond tensors,
    Python and numpy scalars raises (weights_only load), naming it."""
    model = _payload()["model"]
    key = "denoise_fn.downs.0.weight"
    model[key] = model[key][:4]
    with pytest.raises(ValueError, match=r"downs\.0\.weight"):
        torch_convert.convert_unet_state_dict(
            model, Config.from_dict(TINY_CONFIG).unet)
    payload = _payload()
    payload["args"] = pathlib.PurePosixPath("configs")
    torch.save(payload, str(tmp_path / "foreign.pt"))
    with pytest.raises(pickle.UnpicklingError, match="PurePosixPath"):
        torch_convert.convert_checkpoint_file(
            str(tmp_path / "foreign.pt"), str(tmp_path / "out"),
            Config.from_dict(TINY_CONFIG))
    assert not (tmp_path / "out").exists()


_BLOCKED = """
import runpy, sys
for name in ("jax", "flax", "optax", "viewfusion_tpu", "yaml", "PIL",
             "msgpack"):
    sys.modules[name] = None
sys.argv = ["torch_convert", *sys.argv[1:]]
runpy.run_module("viewfusion_tpu_torch.utils.torch_convert",
                 run_name="__main__")
"""


def test_cli_converts_with_jax_yaml_and_msgpack_blocked(files, tmp_path):
    """python -m viewfusion_tpu_torch.utils.torch_convert in a fresh
    interpreter where jax, flax, optax, viewfusion_tpu, yaml, PIL and
    msgpack cannot be imported: it writes the file that the port's
    converter writes in this process (which holds the JAX converter's
    tree) and prints ``wrote <path>``; with fewer than two arguments it
    prints the usage and exits 2."""
    pt, _, port_dir = files["float32"]
    cfg_path = str(tmp_path / "tiny.yaml")
    pathlib.Path(cfg_path).write_text(dump_yaml(_tiny_raw()))
    out = str(tmp_path / "run")
    proc = subprocess.run([sys.executable, "-c", _BLOCKED, pt, out, cfg_path],
                          cwd=str(REPO), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == f"wrote {out}/best_model_all.msgpack"
    assert _read(out) == _read(port_dir)
    proc = subprocess.run([sys.executable, "-c", _BLOCKED, pt],
                          cwd=str(REPO), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 2
    assert proc.stdout.startswith(
        "usage: python -m viewfusion_tpu_torch.utils.torch_convert "
        "<checkpoint.pt> <out_dir> [config.yaml]")


def test_cli_default_config_is_the_paper_config(monkeypatch, tmp_path):
    """Without a config, main converts with configs/small-tpu-4.yaml
    under the working directory, as the JAX converter does (read by the
    port's YAML reader, equal to PyYAML's reading); elsewhere it finds
    none."""
    seen = []
    monkeypatch.setattr(torch_convert, "convert_checkpoint_file",
                        lambda pt, out, config: seen.append(config) or out)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError, match="small-tpu-4.yaml"):
        torch_convert.main(["x.pt", "out"])
    monkeypatch.chdir(REPO)
    torch_convert.main(["x.pt", "out"])
    with open(REPO / "configs" / "small-tpu-4.yaml") as f:
        paper = Config.from_dict(yaml.safe_load(f))
    assert seen[0] == paper
    assert seen[0] == load_config(str(REPO / "configs" / "small-tpu-4.yaml"))


def _tree_listing(run_dir):
    return sorted(str(p.relative_to(run_dir))
                  for p in pathlib.Path(run_dir).rglob("*"))


def _records(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_eval_on_a_converted_run_dir_names_artifacts_like_jax(
        files, tmp_path, monkeypatch):
    """-e on a converted run dir (``it`` saved as a float, 1000.0): the
    port's CLI and the JAX Experiment leave the same files (the eval
    dumps under images-1000.0/) and metrics.jsonl records with the same
    keys and the same float ``it``."""
    data = str(tmp_path / "data")
    make_synthetic_shards(data, "train", num_objects=8, image_size=8)
    make_synthetic_shards(data, "test", num_objects=8, image_size=8)
    pt = files["float32"][0]
    run = str(tmp_path / "converted")
    torch_convert.convert_checkpoint_file(pt, run,
                                          Config.from_dict(_tiny_raw(data)))
    jax_run, port_run = str(tmp_path / "jax"), str(tmp_path / "port")
    shutil.copytree(run, jax_run)
    shutil.copytree(run, port_run)
    monkeypatch.chdir(tmp_path)
    exp = JaxExperiment(JaxArgs(src=jax_run, eval=True))
    exp.eval()
    assert exp.it == 1000.0
    port = cli.main(["-s", port_run, "-e", "--device", "cpu"])
    assert port.it == 1000.0 and isinstance(port.it, float)
    listing = _tree_listing(port_run)
    assert listing == _tree_listing(jax_run)
    assert "images-1000.0/generated/0000-0000.png" in listing
    ours, theirs = _records(port_run), _records(jax_run)
    assert [sorted(r) for r in ours] == [sorted(r) for r in theirs]
    assert [r["it"] for r in ours] == [r["it"] for r in theirs] == [1000.0]
    assert all(np.isfinite(r["ssim"]) and np.isfinite(r["psnr"])
               for r in ours)
