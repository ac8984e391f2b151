"""The port's serving path (viewfusion_tpu_torch.serving) on the CPU, its
config copy, and its independence from the JAX package.

The service runs on a tiny run dir written by the port (TINY_CONFIG's
sizes, seeded random weights) with ``device="cpu"``, where the kernel
wrappers run their plain versions.
"""

import ast
import base64
import copy
import dataclasses
import io
import json
import pathlib
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
import yaml

from tests.conftest import TINY_CONFIG
from viewfusion_tpu_torch.config import Config
from viewfusion_tpu_torch.models.unet import UNet
from viewfusion_tpu_torch.serving import (ClientError, ViewFusionService,
                                          make_server, write_run_dir)

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parents[1]


def _weights(seed):
    torch.manual_seed(seed)
    return UNet(Config.from_dict(TINY_CONFIG).unet).state_dict()


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("port_run")
    write_run_dir(str(path), Config.from_dict(TINY_CONFIG), _weights(0))
    return str(path)


@pytest.fixture(scope="module")
def service(run_dir):
    return ViewFusionService(run_dir, batch_size=4, max_wait_ms=20,
                             default_steps=4, device="cpu")


def _check_image(img):
    assert img.shape == (8, 8, 3)
    assert np.all(np.isfinite(img))
    assert 0.0 <= img.min() and img.max() <= 1.0


def test_concurrent_requests_across_buckets_and_samplers(service):
    """Concurrent submits over two step buckets and all three samplers
    are batched per (steps, sampler) bucket and all answered."""
    service.warmup([4])
    assert service.warmed_steps[-1] == (4, "ddim")
    rng = np.random.default_rng(0)
    jobs = [(4, "ddim"), (6, "ddim"), (4, "ddim"), (6, "ddim"),
            (4, "dpm"), (4, "dpm_sde"), (6, "dpm")]
    results = {}

    def call(i, steps, sampler):
        cond = rng.uniform(0, 1, (1 + i % 3, 8, 8, 3)).astype(np.float32)
        results[i] = service.submit(cond, angle=0.4 * i, steps=steps,
                                    sampler=sampler)

    threads = [threading.Thread(target=call, args=(i, *job))
               for i, job in enumerate(jobs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert sorted(results) == list(range(len(jobs)))
    for img in results.values():
        _check_image(img)
    buckets = {(steps, sampler) for steps, sampler, _, _ in service.batch_log}
    assert set(jobs) <= buckets


def test_submit_validation(service):
    cond = np.zeros((1, 8, 8, 3), np.float32)
    for bad, match in [
            (dict(cond=np.zeros((8, 8, 3), np.float32)), "N, H, W, 3"),
            (dict(cond=np.zeros((1, 16, 16, 3), np.float32)), "8x8"),
            (dict(cond=np.zeros((4, 8, 8, 3), np.float32)), "at most"),
            (dict(cond=np.zeros((0, 8, 8, 3), np.float32)), "at least one"),
            (dict(steps=0), "steps"), (dict(steps=10 ** 9), "steps"),
            (dict(angle=None), "angle"), (dict(sampler="plms"), "sampler"),
            (dict(sampler="dpm", steps=1), "steps >= 2")]:
        kw = dict(cond=cond, angle=0.0)
        kw.update(bad)
        with pytest.raises(ClientError, match=match):
            service.submit(kw.pop("cond"), **kw)
    with pytest.raises(ValueError, match="warmup steps"):
        service.warmup([0])


def test_abandoned_requests_skipped(service):
    cond = np.zeros((1, 8, 8, 3), np.float32)
    with pytest.raises(TimeoutError):
        service.submit(cond, 0.0, timeout=0.0)
    _check_image(service.submit(cond, 0.0))


@pytest.fixture(scope="module")
def http_server(service):
    httpd = make_server(service, host="127.0.0.1", port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()


def _post(url, payload):
    req = urllib.request.Request(
        f"{url}/generate", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.status, json.loads(resp.read())


def test_http_healthz_and_generate(http_server):
    from PIL import Image

    with urllib.request.urlopen(f"{http_server}/healthz") as resp:
        health = json.loads(resp.read())
    assert health == {"status": "ok", "image_size": 8, "max_views": 3,
                      "max_steps": 8}
    buf = io.BytesIO()
    Image.fromarray((np.random.default_rng(1).uniform(0, 1, (8, 8, 3))
                     * 255).astype(np.uint8)).save(buf, format="PNG")
    status, out = _post(http_server, {
        "views": [base64.b64encode(buf.getvalue()).decode()],
        "angle": 1.0, "steps": 4, "sampler": "dpm"})
    assert status == 200
    assert Image.open(io.BytesIO(base64.b64decode(out["image"]))).size == (8, 8)


@pytest.mark.parametrize("payload,match", [
    ({"angle": 1.0}, "views"),
    ({"views": [], "angle": 1.0}, "non-empty"),
    ({"views": ["bm90YXBuZw=="], "angle": 1.0}, "undecodable"),
    ({"views": [np.zeros((8, 8, 3)).tolist()], "angle": None}, "angle"),
    ({"views": [123], "angle": 1.0}, "invalid view"),
    ({"views": [np.zeros((8, 8, 3)).tolist()], "angle": 1.0,
      "sampler": "nope"}, "sampler"),
    ({"views": [np.zeros((8, 8, 3)).tolist()]}, "angle"),
])
def test_http_client_errors_are_400(http_server, payload, match):
    with pytest.raises(urllib.error.HTTPError) as exc:
        _post(http_server, payload)
    assert exc.value.code == 400
    assert match in json.loads(exc.value.read())["error"]


def test_http_not_found(http_server):
    req = urllib.request.Request(f"{http_server}/nope", data=b"{}")
    with pytest.raises(urllib.error.HTTPError) as exc:
        urllib.request.urlopen(req, timeout=30)
    assert exc.value.code == 404


def _ema_config():
    raw = copy.deepcopy(TINY_CONFIG)
    raw["tpu"]["ema_decay"] = 0.9
    return Config.from_dict(raw)


def test_service_serves_ema_weights_when_present(tmp_path):
    raw_w, ema_w = _weights(1), _weights(2)
    write_run_dir(str(tmp_path), _ema_config(), raw_w, ema_params=ema_w)
    svc = ViewFusionService(str(tmp_path), batch_size=2, device="cpu")
    served = svc.model.unet.state_dict()
    for k, v in ema_w.items():
        torch.testing.assert_close(served[k], v.to(served[k].dtype))


def test_service_without_ema_field_serves_raw_params(tmp_path, capsys):
    raw_w = _weights(3)
    write_run_dir(str(tmp_path), _ema_config(), raw_w)
    svc = ViewFusionService(str(tmp_path), batch_size=2, device="cpu")
    assert "no ema_params" in capsys.readouterr().out
    served = svc.model.unet.state_dict()
    for k, v in raw_w.items():
        torch.testing.assert_close(served[k], v.to(served[k].dtype))


def test_service_reads_model_msgpack_without_a_best_file(tmp_path):
    """The JAX service's precedence: best_model_all.msgpack, else the
    rolling model.msgpack."""
    best, rolling = _weights(4), _weights(5)
    write_run_dir(str(tmp_path), Config.from_dict(TINY_CONFIG), rolling)
    (tmp_path / "best_model_all.msgpack").rename(tmp_path / "model.msgpack")
    served = ViewFusionService(str(tmp_path), batch_size=2,
                               device="cpu").model.unet.state_dict()
    torch.testing.assert_close(served["downs.0.weight"],
                               rolling["downs.0.weight"])
    write_run_dir(str(tmp_path), Config.from_dict(TINY_CONFIG), best)
    served = ViewFusionService(str(tmp_path), batch_size=2,
                               device="cpu").model.unet.state_dict()
    torch.testing.assert_close(served["downs.0.weight"],
                               best["downs.0.weight"])


def test_default_device_is_cuda(run_dir):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        ViewFusionService(run_dir)


def test_config_copy_loads_every_repo_config_like_jax():
    from viewfusion_tpu.config import load_config as jax_load

    from viewfusion_tpu_torch.config import load_config

    paths = sorted((REPO / "configs").glob("*.yaml"))
    assert paths
    for path in paths:
        ours, theirs = load_config(str(path)), jax_load(str(path))
        for name in ("unet", "diffusion", "data", "train"):
            assert dataclasses.asdict(getattr(ours, name)) == \
                dataclasses.asdict(getattr(theirs, name)), (path, name)
        assert (ours.denoise_net, ours.relative) == \
            (theirs.denoise_net, theirs.relative)


def test_chip_smoke_config_is_the_paper_config():
    """chip_smoke.py keeps configs/small-tpu-4.yaml in code (the card's
    machine may lack PyYAML): equal on every field the serving path
    reads."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    with open(REPO / "configs" / "small-tpu-4.yaml") as f:
        paper = Config.from_dict(yaml.safe_load(f))
    ours = Config.from_dict(chip_smoke.PAPER_CONFIG)
    assert ours.unet == paper.unet
    assert ours.diffusion == paper.diffusion
    assert ours.data.max_views == paper.data.max_views
    assert ours.train.compute_dtype == paper.train.compute_dtype
    assert ours.denoise_net == paper.denoise_net


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_sources_import_nothing_of_jax():
    """No port source imports JAX, the JAX package, PyYAML, PIL or
    msgpack; and in a fresh interpreter where PIL and PyYAML cannot be
    imported, the port's image codecs (PNG, JPEG, WebP, GIF, BMP, TIFF)
    and YAML reader decode the committed fixtures to their expected
    arrays and load the YAML 1.1 config."""
    files = list((REPO / "viewfusion_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    for path in files:
        for name in _imports(path):
            root = name.split(".")[0]
            assert root not in ("jax", "flax", "optax", "viewfusion_tpu",
                                "yaml", "PIL", "msgpack"), (path, name)
    script = """
import pathlib, sys
for name in ("PIL", "yaml", "jax", "viewfusion_tpu"):
    sys.modules[name] = None
import numpy as np
from viewfusion_tpu_torch.utils.jpeg import decode_jpeg
from viewfusion_tpu_torch.utils.image import decode_image
from viewfusion_tpu_torch.config import load_config
root = pathlib.Path("tests/torch_port_formats")
expected = np.load(root / "expected.npz")
for key in expected.files:
    path = next(root.glob(key + ".*"))
    data = path.read_bytes()
    got = decode_jpeg(data) if path.suffix == ".jpg" else decode_image(data)
    assert np.array_equal(got, expected[key]), key
assert load_config(str(root / "small-tpu-4-yaml11.yaml")) == load_config(
    "configs/small-tpu-4.yaml")
print("ok", len(expected.files))
"""
    proc = subprocess.run([sys.executable, "-c", script], cwd=str(REPO),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok 36"


def test_port_runs_with_jax_and_the_jax_package_blocked(tmp_path):
    """A fresh interpreter where importing jax, flax, optax,
    viewfusion_tpu, yaml, PIL or msgpack fails imports every port module
    (the DiT, LPIPS, compute_metrics and prep among them), runs a tiny
    CPU generate_ddim, and writes and serves a UNet and a DiT run dir."""
    dit_raw = copy.deepcopy(TINY_CONFIG)
    dit_raw["model"]["denoise_net"] = "dit"
    dit_raw["model"]["denoise_net_params"] = dict(
        image_size=8, in_channel=6, out_channel=6, patch_size=2,
        hidden_size=32, depth=2, num_heads=2)
    script = """
import pathlib, sys
for name in ("jax", "flax", "optax", "viewfusion_tpu", "yaml", "PIL",
             "msgpack"):
    sys.modules[name] = None
import importlib
import torch
import viewfusion_tpu_torch
root = pathlib.Path(viewfusion_tpu_torch.__file__).parent
for path in sorted(root.rglob("*.py")):
    importlib.import_module(".".join(
        path.relative_to(root.parent).with_suffix("").parts))
for name in ("models.dit", "ops.lpips", "utils.compute_metrics",
             "data.prep"):
    assert "viewfusion_tpu_torch." + name in sys.modules, name
from viewfusion_tpu_torch.config import Config
from viewfusion_tpu_torch.models.dit import DiT
from viewfusion_tpu_torch.models.view_fusion import ViewFusion
from viewfusion_tpu_torch.serving import ViewFusionService, write_run_dir
cfg = Config.from_dict(%r)
model = ViewFusion.from_config(cfg)
g = torch.Generator().manual_seed(0)
out = model.generate_ddim(torch.rand(2, 3, 8, 8, 3, generator=g),
                          torch.tensor([1, 3]), torch.zeros(2),
                          num_steps=3, generator=g)
assert out.shape == (2, 8, 8, 3) and bool(torch.isfinite(out).all())
write_run_dir(%r, cfg, model.unet.state_dict())
svc = ViewFusionService(%r, batch_size=2, device="cpu")
img = svc.submit(torch.rand(1, 8, 8, 3).numpy(), 0.5, steps=2)
assert img.shape == (8, 8, 3)
dcfg = Config.from_dict(%r)
dit = ViewFusion.from_config(dcfg).unet
assert isinstance(dit, DiT)
write_run_dir(%r, dcfg, dit.state_dict())
dsvc = ViewFusionService(%r, batch_size=2, device="cpu")
img = dsvc.submit(torch.rand(2, 8, 8, 3).numpy(), 0.5, steps=2)
assert img.shape == (8, 8, 3) and isinstance(dsvc.model.unet, DiT)
print("ok")
""" % (TINY_CONFIG, str(tmp_path), str(tmp_path), dit_raw,
       str(tmp_path / "dit"), str(tmp_path / "dit"))
    proc = subprocess.run([sys.executable, "-c", script], cwd=str(REPO),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
