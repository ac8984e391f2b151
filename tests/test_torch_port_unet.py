"""The port's UNet, composition and samplers against the JAX package.

JAX initialises the UNet at TINY_CONFIG's sizes; the params cross over
through ``viewfusion_tpu_torch.utils.convert.unet_state_dict_from_jax``
and both stacks run the same seeded numpy inputs on the CPU.  The
samplers are fed the same y_T and the per-step noise the JAX chain draws
(reproduced here by the same key splits), with mixed view counts so
that masked views take part.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import TINY_CONFIG
from viewfusion_tpu.config import Config as JaxConfig
from viewfusion_tpu.models.unet import UNet as JaxUNet
from viewfusion_tpu.models.view_fusion import ViewFusion as JaxViewFusion
from viewfusion_tpu.models.view_fusion import view_mask as jax_view_mask
from viewfusion_tpu.utils.torch_convert import convert_unet_state_dict
from viewfusion_tpu_torch import tracing
from viewfusion_tpu_torch.config import Config
from viewfusion_tpu_torch.models.unet import UNet
from viewfusion_tpu_torch.models.view_fusion import (ViewFusion,
                                                     ddim_timesteps,
                                                     view_mask)
from viewfusion_tpu_torch.ops.schedules import (DiffusionSchedule,
                                                make_beta_schedule)
from viewfusion_tpu_torch.utils.convert import unet_state_dict_from_jax

torch.set_num_threads(2)
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture(scope="module")
def jax_cfg():
    return JaxConfig.from_dict(TINY_CONFIG)


@pytest.fixture(scope="module")
def params(jax_cfg):
    """JAX-initialised params, perturbed so biases and norms are not
    trivial."""
    unet = JaxUNet(config=jax_cfg.unet, dtype=jnp.float32)
    x = np.zeros((1, 8, 8, 6), np.float32)
    p = jax.jit(unet.init)(jax.random.PRNGKey(0), x,
                           np.zeros(1, np.float32), np.ones(1, np.float32))
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(0, 0.1, a.shape).astype(
            np.float32), p)


def _port_unet(params, dtype=torch.float32):
    unet = UNet(Config.from_dict(TINY_CONFIG).unet, dtype=dtype)
    unet.load_state_dict(unet_state_dict_from_jax(params))
    return unet.eval()


def _unet_inputs(seed=1, b=4):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, 8, 8, 6)).astype(np.float32),
            rng.uniform(0, 6.3, b).astype(np.float32),
            rng.uniform(0, 1, b).astype(np.float32))


def _jax_unet(cfg, dtype, params, x, angle, level):
    apply = jax.jit(JaxUNet(config=cfg.unet, dtype=dtype).apply)
    return np.asarray(apply(params, x, angle, level))


def _run_port(unet, x, angle, level):
    with torch.no_grad():
        return unet(*(torch.from_numpy(a) for a in (x, angle, level))).numpy()


def test_unet_forward_f32_matches_jax(jax_cfg, params):
    x, angle, level = _unet_inputs()
    want = _jax_unet(jax_cfg, jnp.float32, params, x, angle, level)
    got = _run_port(_port_unet(params), x, angle, level)
    assert got.shape == want.shape == (4, 8, 8, 6)
    assert np.abs(got - want).max() <= 1e-5


def test_unet_forward_bf16_close_to_jax(jax_cfg, params):
    """bf16 compute on both sides rounds at different places; the bound
    (3% of the f32 output scale; measured ~1.5%) still catches a
    statistic or softmax computed in bf16."""
    x, angle, level = _unet_inputs()
    want = _jax_unet(jax_cfg, jnp.bfloat16, params, x, angle, level)
    ref32 = _jax_unet(jax_cfg, jnp.float32, params, x, angle, level)
    got = _run_port(_port_unet(params, torch.bfloat16), x, angle, level)
    assert got.dtype == np.float32
    assert np.abs(got - want).max() <= 0.03 * np.abs(ref32).max()


def test_state_dict_round_trips_to_jax_params(jax_cfg, params):
    sd = {k: v.numpy() for k, v in _port_unet(params).state_dict().items()}
    back = convert_unet_state_dict(sd, jax_cfg.unet, prefix="")
    want = jax.tree_util.tree_leaves_with_path(params)
    got = {jax.tree_util.keystr(k): v
           for k, v in jax.tree_util.tree_leaves_with_path(back)}
    assert len(got) == len(want)
    for k, v in want:
        np.testing.assert_array_equal(got[jax.tree_util.keystr(k)],
                                      np.asarray(v))


@pytest.mark.parametrize("schedule", ["quad", "linear", "warmup10",
                                      "warmup50", "const", "jsd", "cosine"])
def test_schedules_match_jax(schedule):
    from viewfusion_tpu.config import BetaScheduleConfig as JaxBeta
    from viewfusion_tpu.ops.schedules import DiffusionSchedule as JaxSched
    from viewfusion_tpu.ops.schedules import make_beta_schedule as jax_mbs

    from viewfusion_tpu_torch.config import BetaScheduleConfig

    kw = dict(schedule=schedule, num_timesteps=50, linear_start=1e-4,
              linear_end=0.09)
    np.testing.assert_array_equal(make_beta_schedule(**kw), jax_mbs(**kw))
    got = DiffusionSchedule.create(BetaScheduleConfig(**kw))
    want = JaxSched.create(JaxBeta(**kw))
    for name in ("betas", "gammas", "gammas_prev", "sqrt_recip_gammas",
                 "sqrt_recipm1_gammas", "posterior_log_variance_clipped",
                 "posterior_mean_coef1", "posterior_mean_coef2"):
        np.testing.assert_array_equal(getattr(got, name),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


def test_ddim_grid_matches_jax_bit_for_bit():
    """Every n at T=200 (the float32 grid differs from torch.linspace at
    n=23 and from float64 numpy at n=63) and a stride of n at T=2000.
    The JAX grids are compiled in one jit, as inside the jitted sampler
    (view_fusion.py:617)."""
    for T, ns in ((200, list(range(1, 201))),
                  (2000, list(range(1, 2001, 37)) + [50, 250, 2000])):
        grids = jax.jit(lambda: [
            jnp.linspace(0, T - 1, n).round().astype(jnp.int32)[::-1]
            for n in ns])()
        for n, want in zip(ns, grids):
            np.testing.assert_array_equal(ddim_timesteps(T, n),
                                          np.asarray(want),
                                          err_msg=f"T={T} n={n}")


@pytest.mark.parametrize("weighting", [True, False])
def test_compose_matches_jax(weighting):
    rng = np.random.default_rng(2)
    out = rng.normal(size=(3, 4, 5, 5, 6)).astype(np.float32)
    counts = np.array([1, 4, 2])
    want = JaxViewFusion.compose(None, jnp.asarray(out),
                                 jax_view_mask(jnp.asarray(counts), 4),
                                 weighting)
    got = ViewFusion.compose(torch.from_numpy(out),
                             view_mask(torch.from_numpy(counts), 4),
                             weighting)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)


# ---------------------------------------------------------------------
# the samplers: the slice as a whole
# ---------------------------------------------------------------------
B, N = 3, 3
COUNTS = np.array([1, 3, 2], np.int32)


@pytest.fixture(scope="module")
def chain_setup(jax_cfg, params):
    rng = np.random.default_rng(5)
    y_cond = rng.uniform(-1, 1, (B, N, 8, 8, 3)).astype(np.float32)
    angle = rng.uniform(0, 6.3, B).astype(np.float32)
    y_t = rng.normal(size=(B, 8, 8, 3)).astype(np.float32)
    jax_model = JaxViewFusion.from_config(jax_cfg)
    port = ViewFusion.from_config(Config.from_dict(TINY_CONFIG))
    port.unet.load_state_dict(unet_state_dict_from_jax(params))
    port.unet.eval()
    return jax_model, port, y_cond, angle, y_t


def _jax_draws(key, steps):
    """The per-step normal draws of the JAX scan: key, sub = split(key)."""
    draws = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        draws.append(torch.from_numpy(np.array(
            jax.random.normal(sub, (B, 8, 8, 3), jnp.float32))))
    return draws


def _port_args(y_cond, angle, y_t):
    return (torch.from_numpy(y_cond), torch.from_numpy(COUNTS.astype(np.int64)),
            torch.from_numpy(angle)), torch.from_numpy(y_t)


@pytest.mark.parametrize("eta", [0.0, 1.0])
def test_generate_ddim_matches_jax(chain_setup, params, eta):
    jax_model, port, y_cond, angle, y_t = chain_setup
    rng_key = jax.random.PRNGKey(11)
    steps = 5
    want = np.asarray(jax_model.generate_ddim(
        params, rng_key, y_cond, COUNTS, angle, num_steps=steps, eta=eta,
        y_t=y_t))
    _, k_scan = jax.random.split(rng_key)
    args, yt = _port_args(y_cond, angle, y_t)
    mark = tracing.mark()
    got = port.generate_ddim(*args, num_steps=steps, eta=eta, y_t=yt,
                             noise=_jax_draws(k_scan, steps)).numpy()
    assert np.abs(got - want).max() <= 5e-5
    assert len(tracing.spans("unet.forward", after=mark)) == steps


@pytest.mark.parametrize("sde", [False, True])
def test_generate_dpm_matches_jax(chain_setup, params, sde):
    jax_model, port, y_cond, angle, y_t = chain_setup
    rng_key = jax.random.PRNGKey(12)
    steps = 4
    want = np.asarray(jax_model.generate_dpm(
        params, rng_key, y_cond, COUNTS, angle, num_steps=steps, y_t=y_t,
        sde=sde))
    args, yt = _port_args(y_cond, angle, y_t)
    got = port.generate_dpm(
        *args, num_steps=steps, y_t=yt, sde=sde,
        noise=_jax_draws(jax.random.fold_in(rng_key, 1), steps)).numpy()
    assert np.abs(got - want).max() <= 5e-5


def test_generate_without_fed_noise_is_seeded(chain_setup):
    _, port, y_cond, angle, _ = chain_setup
    args, _ = _port_args(y_cond, angle, np.zeros((B, 8, 8, 3), np.float32))
    outs = [port.generate_ddim(*args, num_steps=3,
                               generator=torch.Generator().manual_seed(3))
            for _ in range(2)]
    assert torch.equal(outs[0], outs[1])
    assert outs[0].shape == (B, 8, 8, 3) and torch.isfinite(outs[0]).all()
