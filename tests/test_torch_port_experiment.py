"""The port's experiment loop against the JAX package's, on the CPU at
TINY_CONFIG's sizes with synthetic shards at 8 px: run dirs and
checkpoints cross over both ways exactly, the port's service serves a
JAX run dir as the JAX service does, and the port's CLI leaves the JAX
CLI's artifacts (tests/test_trainer.py).
"""

import copy
import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import TINY_CONFIG
from viewfusion_tpu.config import Config as JaxConfig
from viewfusion_tpu.data.synthetic import make_synthetic_shards
from viewfusion_tpu.models.unet import UNet as JaxUNet
from viewfusion_tpu.serving import ViewFusionService as JaxService
from viewfusion_tpu.training.checkpoint import Checkpoint as JaxCheckpoint
from viewfusion_tpu.training.trainer import Experiment as JaxExperiment
from viewfusion_tpu.training.trainer import ExperimentArgs as JaxArgs
from viewfusion_tpu_torch import cli
from viewfusion_tpu_torch.config import Config, dump_yaml, parse_yaml
from viewfusion_tpu_torch.serving import ViewFusionService, write_run_dir
from viewfusion_tpu_torch.training.checkpoint import Checkpoint
from viewfusion_tpu_torch.training.trainer import (Experiment,
                                                   ExperimentArgs, Trainer)
from viewfusion_tpu_torch.utils.convert import (load_trainer_state,
                                                trainer_state_to_jax,
                                                unet_state_dict_from_jax)

torch.set_num_threads(2)
FIELDS = ["params", "opt_state", "step", "ema_params"]


def _raw(data_dir, **tpu):
    raw = copy.deepcopy(TINY_CONFIG)
    for split in ("train", "test"):
        raw["data"]["params"][split]["params"]["path"] = data_dir
    raw["data"]["params"]["test"]["params"]["size"] = 4
    raw["data"]["params"]["batch_size"] = 4
    raw["model"].update(max_it=3, checkpoint_every=0, log_every=2,
                        validate_every=0)
    raw["tpu"].update({"packed_views": True, "ema_decay": 0.9,
                       "lr_warmup": 1, "native_loader": False, **tpu})
    return raw


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("data"))
    make_synthetic_shards(d, "train", num_objects=8, image_size=8)
    make_synthetic_shards(d, "test", num_objects=8, image_size=8)
    return d


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory, data_dir):
    """A JAX Experiment's run dir: 4 packed steps with EMA (it 0..3),
    then an eval that writes the best-model files."""
    root = tmp_path_factory.mktemp("jax_run")
    path = str(root / "tiny.yaml")
    with open(path, "w") as f:
        f.write(dump_yaml(_raw(data_dir)))
    exp = JaxExperiment(JaxArgs(config=path, train=True),
                        log_root=str(root / "logs"))
    exp.train()
    exp.eval()
    return exp


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tree_equal(a, b, path=""):
    assert isinstance(a, dict) == isinstance(b, dict), path
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _tree_equal(a[k], b[k], f"{path}/{k}")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)


def _port_state(trainer):
    return jax.tree_util.tree_map(
        lambda t: t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
        else np.asarray(t), trainer_state_to_jax(trainer))


def test_port_trainer_loads_a_jax_checkpoint_exactly(jax_run):
    """model.msgpack of a JAX Experiment into the port's Trainer: Adam
    moments, counts, step and EMA equal exactly (written back out they
    are the JAX state dict), and the UNet forward within 1e-5."""
    cfg = Config.from_dict(parse_yaml(open(
        os.path.join(jax_run.out_dir, "config.yaml")).read()))
    trainer = Trainer(cfg, device="cpu")
    state, extra = Checkpoint(jax_run.out_dir).load(
        "model.msgpack", dict.fromkeys(FIELDS))
    load_trainer_state(trainer, state)
    assert extra["it"] == 3 and trainer.step == 4
    from flax import serialization
    want = _np(serialization.to_state_dict(jax_run.state))
    _tree_equal(_port_state(trainer), want)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 8, 8, 6)).astype(np.float32)
    angle = rng.uniform(0, 6.3, 4).astype(np.float32)
    level = rng.uniform(0, 1, 4).astype(np.float32)
    jax_out = np.asarray(JaxUNet(config=jax_run.config.unet,
                                 dtype=jnp.float32).apply(
        jax_run.state.params, x, angle, level))
    with torch.no_grad():
        port_out = trainer.model.unet.eval()(
            *(torch.from_numpy(a) for a in (x, angle, level))).numpy()
    assert np.abs(port_out - jax_out).max() <= 1e-5


def test_port_resumes_a_jax_run_dir(jax_run, tmp_path):
    """-s <JAX run> -r -t on the port continues at the saved it and
    writes a model.msgpack that JAX loads."""
    run = str(tmp_path / "run")
    os.makedirs(run)
    for name in ("config.yaml", "model.msgpack"):
        with open(os.path.join(jax_run.out_dir, name), "rb") as f, \
                open(os.path.join(run, name), "wb") as g:
            g.write(f.read())
    raw = parse_yaml(open(os.path.join(run, "config.yaml")).read())
    raw["model"]["max_it"] = 5
    with open(os.path.join(run, "config.yaml"), "w") as f:
        f.write(dump_yaml(raw))
    exp = Experiment(ExperimentArgs(src=run, train=True, resume=True,
                                    device="cpu"))
    assert exp.it == 3 and exp.trainer.step == 4
    exp.train()
    assert exp.it == 5 and exp.trainer.step == 6
    ck = JaxCheckpoint(run)
    state, extra = ck.load("model.msgpack", jax_run.state)
    assert extra["it"] == 5 and int(state.step) == 6 and not ck.last_missing


def test_jax_loads_a_port_checkpoint_exactly(jax_run, data_dir, tmp_path,
                                            monkeypatch):
    """A port Experiment's model.msgpack restores through the JAX
    Checkpoint.load into a TrainState equal to the port's state."""
    monkeypatch.chdir(tmp_path)
    with open("tiny.yaml", "w") as f:
        f.write(dump_yaml(_raw(data_dir)))
    exp = cli.main(["-c", "tiny.yaml", "-t", "--device", "cpu"])
    ck = JaxCheckpoint(str(tmp_path / exp.out_dir))
    state, extra = ck.load("model.msgpack", jax_run.state)
    assert not ck.last_missing and extra["it"] == 3
    from flax import serialization
    _tree_equal(_np(serialization.to_state_dict(state)),
                _port_state(exp.trainer))


def test_params_only_and_missing_ema_behave_as_in_jax(jax_run, tmp_path):
    """write_run_dir's params-only file: JAX and the port both keep fresh
    values for the missing fields and list the same ones; the params
    cross over exactly."""
    torch.manual_seed(0)
    cfg = Config.from_dict(parse_yaml(open(
        os.path.join(jax_run.out_dir, "config.yaml")).read()))
    params = Trainer(cfg, device="cpu").model.unet.state_dict()
    write_run_dir(str(tmp_path), cfg, params)
    ck = JaxCheckpoint(str(tmp_path))
    state, _ = ck.load("best_model_all.msgpack", jax_run.state)
    assert ck.last_missing == ["ema_params", "opt_state", "step"]
    back = unet_state_dict_from_jax(_np(state.params))
    for k, v in params.items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0)
    port_ck = Checkpoint(str(tmp_path))
    port_ck.load("best_model_all.msgpack", dict.fromkeys(FIELDS))
    assert port_ck.last_missing == ck.last_missing


def test_port_service_serves_a_jax_run_dir_like_the_jax_service(jax_run):
    """Both services load the JAX run dir (best_model_all.msgpack, the
    EMA shadow); DDIM on the same y_T and draws agrees within 5e-5."""
    jax_svc = JaxService(jax_run.out_dir, batch_size=2)
    port_svc = ViewFusionService(jax_run.out_dir, batch_size=2,
                                 device="cpu")
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


def _records(run):
    with open(os.path.join(run, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def port_run(tmp_path_factory, data_dir):
    """-t through the CLI: 13 packed steps (it 0..12), evals and vis grids
    at 6 and 12, rolling saves every 5."""
    root = tmp_path_factory.mktemp("port_run")
    raw = _raw(data_dir)
    raw["model"].update(max_it=12, checkpoint_every=5, log_every=4,
                        validate_every=6, validate_from=6)
    path = str(root / "tiny.yaml")
    with open(path, "w") as f:
        f.write(dump_yaml(raw))
    cwd = os.getcwd()
    os.chdir(root)
    try:
        exp = cli.main(["-c", path, "-t", "--device", "cpu"])
    finally:
        os.chdir(cwd)
    exp.out_dir = str(root / exp.out_dir)
    return exp


def test_cli_train_writes_the_jax_artifacts(port_run):
    run = port_run.out_dir
    assert port_run.it == 12 and port_run.trainer.step == 13
    assert os.path.dirname(run).endswith("logs")
    for name in ("model.msgpack", "config.yaml", "metrics.jsonl",
                 "best_model_ssim.msgpack", "best_model_psnr.msgpack",
                 "best_model_all.msgpack", "output-6.png", "output-12.png"):
        assert os.path.exists(os.path.join(run, name)), name
    records = _records(run)
    losses = [(r["it"], r["loss"]) for r in records if "loss" in r]
    assert [it for it, _ in losses] == [0, 4, 8, 12]
    assert all(np.isfinite(v) for _, v in losses)
    evals = [r for r in records if "ssim" in r]
    assert [r["it"] for r in evals] == [6, 12]
    assert all(-1 <= r["ssim"] <= 1 and np.isfinite(r["psnr"])
               for r in evals)
    _, extra = Checkpoint(run).load("best_model_all.msgpack", {})
    assert extra["ssim"] == pytest.approx(port_run.best_metrics["ssim"])
    assert extra["run_id"] == port_run.run_id


def test_cli_resume_eval_and_inference_modes(port_run):
    """-r continues at the saved it; -e logs ssim/psnr; -i -ex -ar -gif
    leave their images and GIFs."""
    run = port_run.out_dir
    raw = parse_yaml(open(os.path.join(run, "config.yaml")).read())
    raw["model"]["max_it"] = 14
    with open(os.path.join(run, "config.yaml"), "w") as f:
        f.write(dump_yaml(raw))
    exp = cli.main(["-s", run, "-r", "-t", "--device", "cpu"])
    assert exp.it == 14 and exp.trainer.step == 15
    assert [r["it"] for r in _records(run) if "loss" in r][-1] == 12
    n = len(_records(run))
    exp = cli.main(["-s", run, "-e", "--device", "cpu"])
    new = _records(run)[n:]
    assert len(new) == 1 and {"ssim", "psnr"} <= set(new[0])
    exp = cli.main(["-s", run, "-i", "-ex", "-ar", "-gif", "--device",
                    "cpu"])
    it = exp.it
    for name in (f"extrapolate-{it}.png", f"autoregressive_single-{it}.png",
                 f"autoregressive_animated-{it}.gif",
                 f"weights_animated-{it}.gif"):
        assert os.path.exists(os.path.join(run, name)), name


def test_dense_accum_exact_epoch_train_split_and_dumps(data_dir, tmp_path):
    """The dense path with grad_accum 2, an exact-epoch eval with padded
    rows, the held-in train-split pass and eval image dumps."""
    raw = _raw(data_dir, packed_views=False, grad_accum=2,
               eval_exact_epoch=True, eval_train_split=True,
               eval_dump_images=True, async_checkpoint=False)
    raw["data"]["params"]["test"]["params"]["size"] = 8
    raw["data"]["params"]["batch_size"] = 6
    raw["model"].update(max_it=2, validate_every=2, validate_from=2)
    path = str(tmp_path / "dense.yaml")
    with open(path, "w") as f:
        f.write(dump_yaml(raw))
    exp = Experiment(ExperimentArgs(config=path, train=True, device="cpu"),
                     log_root=str(tmp_path / "logs"))
    exp.train()
    assert exp.trainer.step == 3 and exp.last_eval_count == 8
    ev = [r for r in _records(exp.out_dir) if "ssim" in r]
    assert {"ssim_train", "psnr_train"} <= set(ev[0])
    dumped = os.listdir(os.path.join(exp.out_dir, "images-2", "generated"))
    assert len(dumped) == 8  # the padded rows of the last batch skipped


def test_sigterm_saves_the_last_completed_step(data_dir, tmp_path):
    raw = _raw(data_dir)
    raw["model"]["max_it"] = 50
    path = str(tmp_path / "t.yaml")
    with open(path, "w") as f:
        f.write(dump_yaml(raw))
    exp = Experiment(ExperimentArgs(config=path, train=True, device="cpu"),
                     log_root=str(tmp_path / "logs"))
    step = exp.trainer.train_step
    calls = []

    def counted(*a, **kw):
        calls.append(1)
        if len(calls) == 3:
            os.kill(os.getpid(), signal.SIGTERM)
        return step(*a, **kw)

    exp.trainer.train_step = counted
    exp.train()
    assert len(calls) == 3 and exp.it == 3
    state, extra = Checkpoint(exp.out_dir).load("model.msgpack",
                                                dict.fromkeys(FIELDS))
    assert extra["it"] == 2 and int(state["step"]) == 3


@pytest.fixture(scope="module")
def two_rank_knobs(tmp_path_factory):
    """tpu.mesh_data: 2 (two data ranks, a shard each; with grad_accum 2,
    so each rank's microbatches carry packed rows of their own lengths)
    and tpu.mesh_view: 2 (one data rank, two view ranks), each an
    Experiment of two gloo ranks (tests/_torch_port_ranks.py), in one
    spawn."""
    from tests import _torch_port_ranks as ranks

    tmp = str(tmp_path_factory.mktemp("knobs"))
    data = os.path.join(tmp, "data")
    for mode in ("train", "test"):
        make_synthetic_shards(data, mode, num_objects=8, num_shards=2,
                              image_size=8)
    calls = []
    for name, tpu in (("mesh_data", {"mesh_data": 2, "grad_accum": 2}),
                      ("mesh_view", {"mesh_view": 2})):
        raw = _raw(data, **tpu)
        for split in ("train", "test"):
            raw["data"]["params"][split]["params"]["end_shard"] = 1
        path = os.path.join(tmp, f"{name}.yaml")
        with open(path, "w") as f:
            f.write(dump_yaml(raw))
        calls.append((ranks.knob_body, (path, os.path.join(tmp, name),
                                        name)))
    ranks.spawn(ranks.sequence_body, 2, tmp, calls)
    return {name: [ranks.load(tmp, name, r) for r in range(2)]
            for name in ("mesh_data", "mesh_view")}


@pytest.mark.parametrize("tpu,what", [
    ({"fused_feed": True}, "tpu.fused_feed"),
    ({"shard_opt_state": True}, "tpu.shard_opt_state"),
    ({"mesh_data": 2}, "tpu.mesh_data"), ({"mesh_view": 2}, "tpu.mesh_view"),
])
def test_knobs_once_refused_are_honoured(request, data_dir, tmp_path, tpu,
                                         what):
    """Each knob the loop once refused now builds the Experiment and
    trains with it to max_it (4 steps): the fused feed and ZeRO-1 in one
    process, the mesh knobs on two ranks (WORLD_SIZE > 1)."""
    if what.startswith("tpu.mesh"):
        recs = request.getfixturevalue("two_rank_knobs")[what[4:]]
        want = (2, 1) if what == "tpu.mesh_data" else (1, 2)
        assert [r["mesh"] for r in recs] == [want] * 2
        assert [(r["it"], r["step"]) for r in recs] == [(3, 4)] * 2
        assert recs[0]["out_dir"] == recs[1]["out_dir"]
        assert os.path.exists(os.path.join(recs[0]["out_dir"],
                                           "model.msgpack"))
        return
    path = str(tmp_path / "r.yaml")
    with open(path, "w") as f:
        f.write(dump_yaml(_raw(data_dir, **tpu)))
    exp = Experiment(ExperimentArgs(config=path, train=True, device="cpu"),
                     log_root=str(tmp_path / "logs"))
    assert (exp.trainer.zero1 is not None) == ("shard_opt_state" in tpu)
    exp.train()
    assert (exp.it, exp.trainer.step) == (3, 4)
    losses = [json.loads(line)["loss"] for line in open(os.path.join(
        exp.out_dir, "metrics.jsonl")) if "loss" in line]
    assert losses and all(np.isfinite(losses))


def test_eval_needs_a_best_checkpoint_and_cuda_is_the_default(
        data_dir, tmp_path):
    run = str(tmp_path / "empty")
    os.makedirs(run)
    with open(os.path.join(run, "config.yaml"), "w") as f:
        f.write(dump_yaml(_raw(data_dir)))
    with pytest.raises(FileNotFoundError, match="best_model_all"):
        Experiment(ExperimentArgs(src=run, eval=True, device="cpu"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["-s", run, "-e"])
