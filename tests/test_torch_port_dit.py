"""The port's DiT denoiser against the JAX package's, on the CPU.

JAX initialises the DiT at tests/test_dit.py's ``CFG`` (image 8, patch 2,
hidden 32, depth 2, two heads); every parameter is then perturbed (a
fresh DiT is the zero map, so a test on fresh weights proves nothing)
and crosses over through the port's name map
(``viewfusion_tpu_torch.utils.convert``).  Both stacks run the same
seeded numpy inputs; the JAX attention op takes its XLA path on the CPU
and the port's its plain version.  The JAX losses and chains draw from
keys; the tests reproduce those draws and feed them to the port
(``noise=``/``sample_gammas=``).

Tolerances and why:
  * f32 forward: <= 1e-5 of the output's scale (measured ~3e-7);
  * bf16 forward: <= 4 bf16 ulps of the f32 output's scale (measured
    1.5-2.5 ulps over five seeds; JAX's own bf16 output is ~1.9 ulps
    from its f32 one).  Values cannot show the casts here: the port's
    bf16 output is about as far from JAX's bf16 output as from JAX's f32
    one (L2 ratio 1.1-1.3), and so is a port that keeps the token stream
    in f32 (1.5-1.8), because flax rounds at every jnp op of a
    composite where torch's fused op rounds once: ``nn.silu`` is
    x * sigmoid(x) in bf16, ``nn.gelu``'s constants are rounded to bf16
    (sqrt(2/pi) to 0.796875), a Dense adds its bias to the rounded
    product.  Already the conditioning MLP's output agrees bit for bit
    in only ~30% of its elements.  So a second test checks the dtype
    of every activation instead;
  * f32 loss within 1e-5 relative and every parameter gradient within
    1e-5 of the largest gradient (measured ~1e-7);
  * remat against no remat: equal bit for bit (the recomputed forward is
    the same CPU arithmetic);
  * DDIM and ancestral chains: <= 5e-5 (as the UNet's, f32 through T
    steps);
  * name map and trainer state round trips, checkpoints both ways:
    exact.
"""

import copy
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import TINY_CONFIG
from tests.test_dit import CFG
from tests.test_torch_port_train import _batch, _bf16_ulp, _jax_draws
from viewfusion_tpu.config import Config as JaxConfig
from viewfusion_tpu.data.synthetic import make_synthetic_shards
from viewfusion_tpu.models.dit import DiT as JaxDiT
from viewfusion_tpu.models.view_fusion import ViewFusion as JaxViewFusion
from viewfusion_tpu.serving import ViewFusionService as JaxService
from viewfusion_tpu.training.checkpoint import Checkpoint as JaxCheckpoint
from viewfusion_tpu.training.trainer import Experiment as JaxExperiment
from viewfusion_tpu.training.trainer import ExperimentArgs as JaxArgs
from viewfusion_tpu_torch import cli
from viewfusion_tpu_torch.config import (Config, dump_yaml, load_config,
                                        parse_yaml)
from viewfusion_tpu_torch.models import dit as dit_module
from viewfusion_tpu_torch.models.dit import DiT, DiTBlock, MHAttention
from viewfusion_tpu_torch.models.unet import Conv2d, Linear, UNet
from viewfusion_tpu_torch.models.view_fusion import ViewFusion
from viewfusion_tpu_torch.serving import ViewFusionService
from viewfusion_tpu_torch.training.checkpoint import Checkpoint
from viewfusion_tpu_torch.training.trainer import (Experiment,
                                                   ExperimentArgs, Trainer)
from viewfusion_tpu_torch.utils.convert import (load_trainer_state,
                                                trainer_state_to_jax,
                                                unet_params_to_jax,
                                                unet_state_dict_from_jax)

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False

B, N, HW = 4, 3, 8
T = TINY_CONFIG["model"]["view_fusion_params"]["beta_schedule"]["train"][
    "num_timesteps"]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ["params", "opt_state", "step", "ema_params"]


def _raw(**tpu):
    raw = copy.deepcopy(TINY_CONFIG)
    raw["model"]["denoise_net"] = "dit"
    raw["model"]["denoise_net_params"] = dataclasses.asdict(CFG)
    raw["tpu"].update(dict(packed_views=True, peak_lr=1e-3, lr_warmup=1,
                           ema_decay=0.9), **tpu)
    return raw


def _perturbed(tree, seed, sigma=0.1):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(0, sigma, a.shape).astype(
            np.float32), tree)


@pytest.fixture(scope="module")
def params():
    """A JAX DiT's init params, every leaf perturbed."""
    p = jax.jit(JaxDiT(config=CFG).init)(
        jax.random.PRNGKey(0), np.zeros((1, HW, HW, 6), np.float32),
        np.zeros(1, np.float32), np.ones(1, np.float32))
    return _perturbed(p, 0)


def _port_dit(params, dtype=torch.float32):
    dit = DiT(Config.from_dict(_raw()).denoiser, dtype=dtype)
    dit.load_state_dict(unet_state_dict_from_jax(params))
    return dit.eval()


def _inputs(seed=1, b=B):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, HW, HW, 6)).astype(np.float32),
            rng.uniform(0, 6.3, b).astype(np.float32),
            rng.uniform(0, 1, b).astype(np.float32))


def _jax_dit(dtype, params, *inputs):
    return np.asarray(jax.jit(JaxDiT(config=CFG, dtype=dtype).apply)(
        params, *inputs))


def _run_port(dit, *inputs):
    with torch.no_grad():
        return dit(*(torch.from_numpy(a) for a in inputs)).numpy()


# ---------------------------------------------------------------------
# the module
# ---------------------------------------------------------------------
def test_dit_forward_f32_matches_jax(params):
    inputs = _inputs()
    want = _jax_dit(jnp.float32, params, *inputs)
    got = _run_port(_port_dit(params), *inputs)
    assert got.shape == want.shape == (B, HW, HW, 6)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("seed", [1, 2])
def test_dit_forward_bf16_close_to_jax(params, seed):
    inputs = _inputs(seed)
    want = _jax_dit(jnp.bfloat16, params, *inputs)
    ref32 = _jax_dit(jnp.float32, params, *inputs)
    got = _run_port(_port_dit(params, torch.bfloat16), *inputs)
    assert got.dtype == np.float32
    assert np.abs(got - want).max() <= 4 * _bf16_ulp(np.abs(ref32).max())


def test_dit_bf16_keeps_every_activation_in_bf16(params, monkeypatch):
    """The casts that flax's ``dtype=`` makes, which the bf16 values
    cannot show (see the tolerances above): at bf16 every Linear and
    the patchify conv take and return bf16, every block takes and
    returns the bf16 token stream (after both residual adds), every
    LayerNorm returns bf16, K3 takes bf16 q, k, v and returns f32, cast
    back before ``proj``; only the output is f32."""
    dit = _port_dit(params, torch.bfloat16)
    seen = []

    def record(name):
        def hook(module, args, out):
            seen.append((name, [a.dtype for a in args], out.dtype))
        return hook

    kinds = (Linear, Conv2d, DiTBlock, MHAttention)
    n_mods = 0
    for name, m in dit.named_modules():
        if isinstance(m, kinds):
            m.register_forward_hook(record(name))
            n_mods += 1
    attn_calls, ln_calls = [], []
    attention, layer_norm = dit_module.spatial_self_attention, \
        dit_module.layer_norm

    def attn(q, k, v, scale):
        out = attention(q, k, v, scale)
        attn_calls.append((q.dtype, k.dtype, v.dtype, out.dtype))
        return out

    def ln(x):
        out = layer_norm(x)
        ln_calls.append((x.dtype, out.dtype))
        return out

    monkeypatch.setattr(dit_module, "spatial_self_attention", attn)
    monkeypatch.setattr(dit_module, "layer_norm", ln)
    out = dit(*(torch.from_numpy(a) for a in _inputs()))
    bf = torch.bfloat16
    assert out.dtype == torch.float32
    assert len(seen) == n_mods == 5 + 7 * CFG.depth
    for name, ins, got in seen:
        assert ins and all(d == bf for d in ins) and got == bf, (name, ins,
                                                                   got)
    assert attn_calls == [(bf, bf, bf, torch.float32)] * CFG.depth
    assert ln_calls == [(bf, bf)] * (2 * CFG.depth + 1)


def test_fresh_dit_is_the_zero_map():
    """Zero kernels in adaLN, final_adaLN and unpatchify and zero biases,
    as flax initialises them: the fresh network outputs exact zeros."""
    torch.manual_seed(0)
    dit = DiT(Config.from_dict(_raw()).denoiser)
    for name, p in dit.named_parameters():
        if name.endswith("bias") or any(
                k in name for k in ("adaLN", "unpatchify")):
            assert not p.any(), name
        else:
            assert p.std() > 0, name
    out = _run_port(dit, *_inputs())
    assert out.shape == (B, HW, HW, 6) and not out.any()


def test_dit_small_builds_with_the_jax_parameter_count():
    cfg = load_config(os.path.join(REPO, "configs", "dit-small-tpu-4.yaml"))
    port = ViewFusion.from_config(cfg)
    assert isinstance(port.unet, DiT) and port.unet.dtype == torch.bfloat16
    jcfg = JaxConfig.from_dict(cfg.raw)
    shapes = jax.eval_shape(
        JaxDiT(config=jcfg.denoiser).init, jax.random.PRNGKey(0),
        jnp.zeros((1, 64, 64, 6)), jnp.zeros(1), jnp.zeros(1))
    want = sum(int(np.prod(a.shape))
               for a in jax.tree_util.tree_leaves(shapes))
    assert sum(p.numel() for p in port.unet.parameters()) == want \
        == 33_471_072


def test_unknown_denoise_net_raises():
    raw = copy.deepcopy(TINY_CONFIG)
    raw["model"]["denoise_net"] = "mlp"
    with pytest.raises(ValueError, match="not supported"):
        ViewFusion.from_config(Config.from_dict(raw))


# ---------------------------------------------------------------------
# the name map and the training state
# ---------------------------------------------------------------------
def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def test_dit_name_map_round_trips(params):
    back = unet_params_to_jax(_port_dit(params).state_dict())
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(params)
    want, got = _leaves(params), _leaves(back)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def _state_np(trainer):
    return jax.tree_util.tree_map(
        lambda t: t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
        else np.asarray(t), trainer_state_to_jax(trainer))


def test_dit_trainer_state_round_trips(params):
    """Two steps (Adam moments and the EMA move), then the state as the
    JAX TrainState dict into a fresh Trainer and out again: exact."""
    cfg = Config.from_dict(_raw())
    tr = Trainer(cfg, device="cpu",
                 state_dict=unet_state_dict_from_jax(params))
    for it in range(2):
        assert np.isfinite(tr.train_step(_batch(60 + it, salt=it)).item())
    state = _state_np(tr)
    assert state["opt_state"]["0"]["count"] == 2 and state["step"] == 2
    assert jax.tree_util.tree_structure(state["ema_params"]) == \
        jax.tree_util.tree_structure(params)
    fresh = Trainer(cfg, device="cpu", seed=5)
    load_trainer_state(fresh, state)
    again = _state_np(fresh)
    a, b = _leaves(state), _leaves(again)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)


# ---------------------------------------------------------------------
# the loss, its gradients, remat
# ---------------------------------------------------------------------
def _port_loss(model, batch, gammas, noise):
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    return model.loss_packed(
        t["target"], t["cond"], t["view_count"].long(), t["angle"],
        t["sample_idx"].long(), t["view_idx"].long(),
        noise=torch.from_numpy(noise.copy()),
        sample_gammas=torch.from_numpy(gammas.copy()))


def test_dit_loss_packed_and_gradients_match_jax_grad(params):
    jmodel = JaxViewFusion.from_config(JaxConfig.from_dict(_raw()))
    batch, key = _batch(7), jax.random.PRNGKey(3)

    def loss(p):
        return jmodel.loss_packed(
            p, key, batch["target"], batch["cond"], batch["view_count"],
            batch["angle"], batch["sample_idx"], batch["view_idx"])

    loss_j, grads_j = jax.jit(jax.value_and_grad(loss))(params)
    port = ViewFusion.from_config(Config.from_dict(_raw()))
    port.unet.load_state_dict(unet_state_dict_from_jax(params))
    got = _port_loss(port, batch, *_jax_draws(jmodel, key))
    got.backward()
    assert abs(got.item() - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    grads = _leaves(unet_params_to_jax(
        {k: p.grad for k, p in port.unet.named_parameters()}))
    want = _leaves(grads_j)
    assert sorted(grads) == sorted(want)
    scale = max(np.abs(v).max() for v in want.values())
    for k, v in want.items():
        assert np.abs(grads[k] - v).max() <= 1e-5 * scale, k


def _unet_raw():
    raw = copy.deepcopy(TINY_CONFIG)
    raw["tpu"]["packed_views"] = True
    return raw


@pytest.mark.parametrize("family", ["dit", "unet"])
def test_remat_gives_equal_gradients(family):
    """loss_packed's gradients with tpu.remat (each block recomputed in
    the backward) equal those without, bit for bit."""
    raw = _raw() if family == "dit" else _unet_raw()
    rng = np.random.default_rng(9)
    gammas = rng.uniform(0.05, 0.95, B).astype(np.float32)
    noise = rng.normal(size=(B, HW, HW, 3)).astype(np.float32)
    batch = _batch(11)
    grads = []
    for remat in (False, True):
        raw["tpu"]["remat"] = remat
        torch.manual_seed(0)
        model = ViewFusion.from_config(Config.from_dict(raw))
        assert model.unet.remat == remat
        with torch.no_grad():  # a DiT's zero-init layers get gradients too
            for p in model.unet.parameters():
                p.add_(torch.randn(p.shape, generator=torch.Generator()
                                   .manual_seed(p.numel())) * 0.05)
        loss = _port_loss(model, batch, gammas, noise)
        loss.backward()
        grads.append([p.grad for p in model.unet.parameters()])
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    assert isinstance(model.unet, DiT if family == "dit" else UNet)


# ---------------------------------------------------------------------
# the samplers
# ---------------------------------------------------------------------
BS = 3
COUNTS = np.array([1, 3, 2], np.int32)


@pytest.fixture(scope="module")
def chain(params):
    rng = np.random.default_rng(5)
    data = dict(y_cond=rng.uniform(-1, 1, (BS, N, HW, HW, 3)).astype(
                    np.float32),
                angle=rng.uniform(0, 6.3, BS).astype(np.float32),
                y_t=rng.normal(size=(BS, HW, HW, 3)).astype(np.float32))
    port = ViewFusion.from_config(Config.from_dict(_raw()))
    port.unet.load_state_dict(unet_state_dict_from_jax(params))
    port.unet.eval()
    return JaxViewFusion.from_config(JaxConfig.from_dict(_raw())), port, \
        data


def _draws(key, steps):
    draws = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        draws.append(torch.from_numpy(np.array(
            jax.random.normal(sub, (BS, HW, HW, 3), jnp.float32))))
    return draws


def _args(data):
    return (torch.from_numpy(data["y_cond"]),
            torch.from_numpy(COUNTS.astype(np.int64)),
            torch.from_numpy(data["angle"]))


@pytest.mark.parametrize("eta", [0.0, 1.0])
def test_dit_ddim_matches_jax(params, chain, eta):
    jmodel, port, data = chain
    key, steps = jax.random.PRNGKey(11), 5
    want = np.asarray(jmodel.generate_ddim(
        params, key, data["y_cond"], COUNTS, data["angle"],
        num_steps=steps, eta=eta, y_t=data["y_t"]))
    got = port.generate_ddim(
        *_args(data), num_steps=steps, eta=eta,
        y_t=torch.from_numpy(data["y_t"]),
        noise=_draws(jax.random.split(key)[1], steps)).numpy()
    assert np.abs(got - want).max() <= 5e-5


def test_dit_ancestral_chain_matches_jax(params, chain):
    """The whole T = 8 ancestral chain, its frames and weights."""
    jmodel, port, data = chain
    key, sample_num = jax.random.PRNGKey(12), 4
    want = jax.jit(jmodel.generate, static_argnames=("sample_num",))(
        params, key, data["y_cond"], COUNTS, data["angle"],
        y_t=data["y_t"], sample_num=sample_num)
    before = port.unet_forwards
    got = port.generate(*_args(data), y_t=torch.from_numpy(data["y_t"]),
                        sample_num=sample_num,
                        noise=_draws(jax.random.split(key)[1], T))
    assert port.unet_forwards - before == T
    for name in ("y_t", "ret_arr", "weight_arr"):
        w = np.asarray(getattr(want, name))
        g = getattr(got, name).numpy()
        assert g.shape == w.shape and np.abs(g - w).max() <= 5e-5, name


# ---------------------------------------------------------------------
# run dirs: checkpoints both ways, serving, the CLI
# ---------------------------------------------------------------------
def _exp_raw(data_dir):
    raw = _raw(native_loader=False, lr_warmup=1)
    for split in ("train", "test"):
        raw["data"]["params"][split]["params"]["path"] = data_dir
    raw["data"]["params"]["test"]["params"]["size"] = 4
    raw["data"]["params"]["batch_size"] = 4
    raw["model"].update(max_it=3, checkpoint_every=0, log_every=2,
                        validate_every=0)
    return raw


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("data"))
    make_synthetic_shards(d, "train", num_objects=8, image_size=HW)
    make_synthetic_shards(d, "test", num_objects=8, image_size=HW)
    return d


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory, data_dir):
    """A JAX DiT Experiment's run dir: 4 packed steps with EMA, then an
    eval that writes the best-model files."""
    root = tmp_path_factory.mktemp("jax_dit_run")
    path = str(root / "dit.yaml")
    with open(path, "w") as f:
        f.write(dump_yaml(_exp_raw(data_dir)))
    exp = JaxExperiment(JaxArgs(config=path, train=True),
                        log_root=str(root / "logs"))
    exp.train()
    exp.eval()
    return exp


def _tree_equal(a, b):
    from flax import serialization
    want = _leaves(serialization.to_state_dict(b))
    got = _leaves(a)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_port_resumes_a_jax_dit_run(jax_run, tmp_path):
    """-s <JAX DiT run> -r -t on the port: the loaded state equals the JAX
    TrainState exactly; training continues at the saved it and writes a
    model.msgpack that JAX loads."""
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
    assert isinstance(exp.trainer.model.unet, DiT)
    assert exp.it == 3 and exp.trainer.step == 4
    _tree_equal(_state_np(exp.trainer), jax_run.state)
    exp.train()
    assert exp.it == 5 and exp.trainer.step == 6
    ck = JaxCheckpoint(run)
    state, extra = ck.load("model.msgpack", jax_run.state)
    assert extra["it"] == 5 and int(state.step) == 6 and not ck.last_missing


def test_jax_loads_a_port_dit_checkpoint_exactly(jax_run, data_dir,
                                                 tmp_path, monkeypatch):
    """-t through the port's CLI on a DiT config: the model.msgpack it
    writes restores through the JAX Checkpoint.load into a TrainState
    equal to the port's state."""
    monkeypatch.chdir(tmp_path)
    with open("dit.yaml", "w") as f:
        f.write(dump_yaml(_exp_raw(data_dir)))
    exp = cli.main(["-c", "dit.yaml", "-t", "--device", "cpu"])
    ck = JaxCheckpoint(str(tmp_path / exp.out_dir))
    state, extra = ck.load("model.msgpack", jax_run.state)
    assert not ck.last_missing and extra["it"] == 3
    _tree_equal(_state_np(exp.trainer), state)
    port_ck = Checkpoint(str(tmp_path / exp.out_dir))
    port_ck.load("model.msgpack", dict.fromkeys(FIELDS))
    assert not port_ck.last_missing


def test_port_service_serves_a_jax_dit_run_like_the_jax_service(jax_run):
    jax_svc = JaxService(jax_run.out_dir, batch_size=2)
    port_svc = ViewFusionService(jax_run.out_dir, batch_size=2,
                                 device="cpu")
    assert isinstance(port_svc.model.unet, DiT)
    rng = np.random.default_rng(2)
    steps = 4
    cond = rng.uniform(0, 1, (BS, N, HW, HW, 3)).astype(np.float32)
    angle = rng.uniform(0, 6.3, BS).astype(np.float32)
    y_t = rng.normal(size=(BS, HW, HW, 3)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want = np.asarray(jax_svc.model.generate_ddim(
        jax_svc.params, key, cond, COUNTS, angle, num_steps=steps, y_t=y_t))
    got = port_svc.model.generate_ddim(
        torch.from_numpy(cond), torch.from_numpy(COUNTS.astype(np.int64)),
        torch.from_numpy(angle), num_steps=steps, y_t=torch.from_numpy(y_t),
        noise=_draws(jax.random.split(key)[1], steps)).numpy()
    assert np.abs(got - want).max() <= 5e-5
    img = port_svc.submit(cond[0, :2], float(angle[0]), steps=2)
    assert img.shape == (HW, HW, 3) and np.isfinite(img).all()
