"""The port's ancestral sampler and the Trainer's generation entry points
against the JAX package, on the CPU.

JAX initialises the UNet at TINY_CONFIG's sizes (T = 8, sample_num 4:
a frame every 2 steps, 4 frames); the params cross over through
``viewfusion_tpu_torch.utils.convert``.  Both stacks run the same seeded
numpy inputs with mixed view counts (masked views take part).  The JAX
chain splits its key into (k_init, k_scan) and draws the noise of each
step from ``key, sub = split(key)``; the tests reproduce those draws and
feed them to the port (``noise=``), and pass y_T explicitly.

Tolerances and why:
  * chains, steps, frames, logits and weights against JAX: <= 5e-5
    (f32 on both sides; the UNet agrees to ~1e-6 per forward and the
    chain carries it through T steps);
  * a segmented chain against one call, and the Trainer's paths against
    the sampler they pick: equal bit for bit (the same operations on the
    same draws);
  * packed rows against dense: <= 1e-5 (the convolutions run other batch
    compositions and sum in another order);
  * DDIM at num_steps = T, eta = 1, against the ancestral chain with the
    same draws: <= 1e-4 (the same update written with other f32
    coefficients: sqrt(gamma_prev) and the DDIM sigma against the
    posterior coefficients and log-variance).
"""

import copy

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
from viewfusion_tpu_torch.config import Config
from viewfusion_tpu_torch.models.view_fusion import (ViewFusion,
                                                     view_mask)
from viewfusion_tpu_torch.training.trainer import (Trainer, packed_indices,
                                                   salted_generator)
from viewfusion_tpu_torch.utils.convert import unet_state_dict_from_jax

torch.set_num_threads(2)
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

B, N, HW = 3, 3, 8
COUNTS = np.array([1, 3, 2], np.int32)
T = TINY_CONFIG["model"]["view_fusion_params"]["beta_schedule"]["train"][
    "num_timesteps"]
SAMPLE_NUM = TINY_CONFIG["tpu"]["sample_num"]


@pytest.fixture(scope="module")
def setup():
    jcfg = JaxConfig.from_dict(TINY_CONFIG)
    unet = JaxUNet(config=jcfg.unet, dtype=jnp.float32)
    p = jax.jit(unet.init)(jax.random.PRNGKey(0),
                           np.zeros((1, HW, HW, 6), np.float32),
                           np.zeros(1, np.float32), np.ones(1, np.float32))
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(0, 0.1, a.shape).astype(
            np.float32), p)
    rng = np.random.default_rng(5)
    data = dict(y_cond=rng.uniform(-1, 1, (B, N, HW, HW, 3)).astype(
                    np.float32),
                angle=rng.uniform(0, 6.3, B).astype(np.float32),
                y_t=rng.normal(size=(B, HW, HW, 3)).astype(np.float32))
    return JaxViewFusion.from_config(jcfg), params, data


def _port(params, weighting=True):
    port = ViewFusion.from_config(Config.from_dict(TINY_CONFIG))
    port.unet.load_state_dict(unet_state_dict_from_jax(params))
    port.unet.eval()
    port.weighting_inference = weighting
    return port


def _draws(key, steps=T):
    """The per-step normal draws of the JAX scan: key, sub = split(key)."""
    draws = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        draws.append(torch.from_numpy(np.array(
            jax.random.normal(sub, (B, HW, HW, 3), jnp.float32))))
    return draws


def _args(data):
    return (torch.from_numpy(data["y_cond"]),
            torch.from_numpy(COUNTS.astype(np.int64)),
            torch.from_numpy(data["angle"]))


def _close(got, want, tol=5e-5):
    assert got.shape == np.shape(want)
    assert np.abs(np.asarray(got) - np.asarray(want)).max() <= tol


@pytest.fixture(scope="module")
def jax_step(setup):
    """JAX p_mean_variance and p_sample at a traced t: one compile."""
    jax_model, params, data = setup
    mask = jax_view_mask(jnp.asarray(COUNTS), N)

    def both(key, t):
        args = (data["y_t"], data["y_cond"], mask, data["angle"], t)
        return (jax_model.p_mean_variance(params, *args),
                jax_model.p_sample(params, key, *args)[0])

    return jax.jit(both)


@pytest.mark.parametrize("t", [T // 2, 0])
def test_p_mean_variance_and_p_sample_match_jax(setup, jax_step, t):
    _, params, data = setup
    key = jax.random.PRNGKey(21)
    (mean_j, logvar_j, logits_j, weights_j), y_j = jax_step(key,
                                                            jnp.int32(t))
    port = _port(params)
    y_cond, counts, angle = _args(data)
    pargs = (torch.from_numpy(data["y_t"]), y_cond, view_mask(counts, N),
             angle, t)
    mean, logvar, logits, weights = port.p_mean_variance(*pargs)
    _close(mean.numpy(), mean_j)
    assert logvar == np.float32(logvar_j)
    _close(logits.numpy(), logits_j)
    _close(weights.numpy(), weights_j)
    z = torch.from_numpy(np.array(
        jax.random.normal(key, (B, HW, HW, 3), jnp.float32)))
    y, _, _ = port.p_sample(*pargs, noise=z)
    _close(y.numpy(), y_j)
    if t == 0:  # no noise at t = 0: the step is the posterior mean
        assert torch.equal(y, mean)


@pytest.fixture(scope="module")
def jax_generate(setup):
    jax_model, params, data = setup
    key = jax.random.PRNGKey(11)
    gen = jax.jit(jax_model.generate,
                  static_argnames=("sample_num", "capture_aux"))
    out = gen(params, key, data["y_cond"], COUNTS, data["angle"],
              y_t=data["y_t"], sample_num=SAMPLE_NUM)
    return key, out


def test_generate_matches_jax(setup, jax_generate):
    """Samples, every kept frame, logits and weights; the frame order and
    the (B, frames, ...) contract."""
    _, params, data = setup
    key, want = jax_generate
    port = _port(params)
    draws = _draws(jax.random.split(key)[1])
    got = port.generate(*_args(data), y_t=torch.from_numpy(data["y_t"]),
                        sample_num=SAMPLE_NUM, noise=draws)
    frames = (T - 1) // (T // SAMPLE_NUM) + 1
    assert got.ret_arr.shape == (B, frames + 1, HW, HW, 3)
    assert got.logit_arr.shape == (B, frames, N, HW, HW, 3)
    for name in ("y_t", "ret_arr", "logit_arr", "weight_arr",
                 "generated_samples"):
        _close(getattr(got, name).numpy(), getattr(want, name))
    np.testing.assert_array_equal(got.ret_arr[:, 0].numpy(), data["y_t"])
    assert torch.equal(got.generated_samples, got.y_t)
    assert port.unet_forwards == T


@pytest.mark.parametrize("variant", ["no_capture", "no_weighting"])
def test_generate_variants_match_jax(setup, jax_generate, variant):
    """capture_aux=False keeps no logit/weight buffers and the samples of
    JAX's chain (which captures: its samples do not depend on it); the
    mean composition (weighting off) keeps none either, against JAX's
    chain with weighting off."""
    jax_model, params, data = setup
    key, want = jax_generate
    weighting = variant != "no_weighting"
    if not weighting:
        jax_model = copy.copy(jax_model)
        object.__setattr__(jax_model, "weighting_inference", False)
        key = jax.random.PRNGKey(12)
        want = jax.jit(jax_model.generate,
                       static_argnames=("sample_num", "capture_aux"))(
            params, key, data["y_cond"], COUNTS, data["angle"],
            y_t=data["y_t"], sample_num=SAMPLE_NUM, capture_aux=False)
        assert want.logit_arr is None
    port = _port(params, weighting)
    got = port.generate(*_args(data), y_t=torch.from_numpy(data["y_t"]),
                        sample_num=SAMPLE_NUM, capture_aux=False,
                        noise=_draws(jax.random.split(key)[1]))
    assert got.logit_arr is None and got.weight_arr is None
    _close(got.ret_arr.numpy(), want.ret_arr)
    _close(got.generated_samples.numpy(), want.generated_samples)


def test_segmented_chain_equals_one_call(setup, jax_generate):
    """init_chain -> 3 uneven segments -> finalize_chain: equal bit for
    bit to one port generate() with the same draws, and to JAX's own
    segmented chain within the chain tolerance."""
    jax_model, params, data = setup
    key, _ = jax_generate
    port = _port(params)
    args = _args(data)
    y_t = torch.from_numpy(data["y_t"])
    draws = _draws(jax.random.split(key)[1])
    one = port.generate(*args, y_t=y_t, sample_num=SAMPLE_NUM, noise=draws)
    carry = port.init_chain(args[0], args[1], SAMPLE_NUM, y_t=y_t)
    for ts in ([7, 6, 5], [4, 3, 2, 1], [0]):
        carry = port.chain_segment(carry, ts, *args, sample_num=SAMPLE_NUM,
                                   noise=draws)
    seg = port.finalize_chain(carry)
    for a, b in zip(seg, one):
        assert torch.equal(a, b)

    jcarry = jax_model.init_chain(key, data["y_cond"], COUNTS,
                                  sample_num=SAMPLE_NUM, y_t=data["y_t"])
    step = jax.jit(lambda c, ts: jax_model.chain_segment(
        params, c, ts, data["y_cond"], COUNTS, data["angle"],
        sample_num=SAMPLE_NUM))
    for lo in range(T - 2, -1, -2):
        jcarry = step(jcarry, jnp.arange(lo + 1, lo - 1, -1))
    want = jax_model.finalize_chain(jcarry)
    _close(seg.ret_arr.numpy(), want.ret_arr)
    _close(seg.weight_arr.numpy(), want.weight_arr)


def test_packed_rows_match_dense(setup):
    """Every sampler with packed_idx (the valid (sample, view) rows only)
    against the dense layout, on the same draws."""
    _, params, data = setup
    port = _port(params)
    args = _args(data)
    y_t = torch.from_numpy(data["y_t"])
    draws = _draws(jax.random.PRNGKey(13))
    packed = tuple(torch.from_numpy(a).long()
                   for a in packed_indices(COUNTS))
    runs = []
    for idx in (None, packed):
        before = port.unet_forwards
        out = port.generate(*args, y_t=y_t, sample_num=SAMPLE_NUM,
                            noise=draws, packed_idx=idx)
        ddim = port.generate_ddim(*args, num_steps=4, y_t=y_t, noise=draws,
                                  packed_idx=idx)
        dpm = port.generate_dpm(*args, num_steps=3, y_t=y_t, noise=draws,
                                sde=True, packed_idx=idx)
        assert port.unet_forwards - before == T + 4 + 3
        # logits of masked views are the UNet's in the dense layout and
        # 0 in the packed one; both give them zero weight
        mask = view_mask(args[1], N)[:, None, :, None, None, None]
        logits = torch.where(mask, out.logit_arr, 0.0)
        runs.append((out.ret_arr, logits, out.weight_arr, ddim, dpm))
    for a, b in zip(*runs):
        _close(b.numpy(), a.numpy(), 1e-5)


def test_ddim_at_every_step_reproduces_the_ancestral_chain(setup):
    """DDIM with num_steps = T and eta = 1 visits every timestep with the
    posterior's noise scale: with the same draws it is the ancestral chain
    (the port's counterpart of tests/test_ddim.py's sanity check)."""
    _, params, data = setup
    port = _port(params)
    args = _args(data)
    y_t = torch.from_numpy(data["y_t"])
    draws = _draws(jax.random.PRNGKey(14))
    anc = port.generate(*args, y_t=y_t, sample_num=SAMPLE_NUM, noise=draws)
    ddim = port.generate_ddim(*args, num_steps=T, eta=1.0, y_t=y_t,
                              noise=draws)
    _close(ddim.numpy(), anc.generated_samples.numpy(), 1e-4)


# ---------------------------------------------------------------------
# the Trainer's entry points
# ---------------------------------------------------------------------
def _trainer(params, **tpu):
    raw = copy.deepcopy(TINY_CONFIG)
    raw["tpu"].update(tpu)
    return Trainer(Config.from_dict(raw), device="cpu",
                   state_dict=unet_state_dict_from_jax(params))


def _host_batch(data, packed=False):
    batch = dict(cond=((data["y_cond"] + 1) * 127.5).astype(np.uint8),
                 view_count=COUNTS, angle=data["angle"])
    if packed:
        batch["sample_idx"], batch["view_idx"] = packed_indices(COUNTS)
    return batch


@pytest.mark.parametrize("sampler", ["ddpm", "ddim", "dpm", "dpm_sde"])
def test_eval_samples_picks_the_configured_sampler(setup, sampler):
    """_eval_samples runs tpu.sampler with the config's step counts on
    packed rows, equal bit for bit to calling that sampler directly with
    a generator of the same seed."""
    _, params, data = setup
    tr = _trainer(params, sampler=sampler, ddim_steps=3, dpm_steps=3,
                  chain_segments=2)
    batch = _host_batch(data, packed=True)
    got = tr._eval_samples(torch.Generator().manual_seed(4), batch)
    model, gen = tr.model, torch.Generator().manual_seed(4)
    cond = torch.from_numpy(batch["cond"]).float() / 255.0
    args = (cond, torch.from_numpy(COUNTS).long(),
            torch.from_numpy(data["angle"]))
    idx = tuple(torch.from_numpy(a).long() for a in packed_indices(COUNTS))
    if sampler == "ddim":
        want = model.generate_ddim(*args, num_steps=3, generator=gen,
                                   packed_idx=idx)
    elif sampler == "ddpm":
        want = model.generate(*args, sample_num=SAMPLE_NUM, generator=gen,
                              packed_idx=idx).generated_samples
    else:
        want = model.generate_dpm(*args, num_steps=3, generator=gen,
                                  sde=sampler == "dpm_sde", packed_idx=idx)
    assert got.shape == (B, HW, HW, 3)
    assert torch.equal(got, want)


def test_generation_runs_on_the_ema_shadow(setup):
    """With ema_decay > 0 generation uses the EMA parameters (a second
    UNet that the update moves), not the live ones."""
    _, params, data = setup
    plain = _trainer(params)
    assert plain.ema_model is None and plain._infer_model is plain.model
    tr = _trainer(params, ema_decay=0.5, peak_lr=1e-2, lr_warmup=0,
                  packed_views=True)
    for p in tr.params:
        p.grad = torch.ones_like(p)
    tr.apply_update()
    shadow = tr._infer_model
    assert shadow is tr.ema_model
    live = dict(tr.model.unet.named_parameters())
    for name, e in shadow.unet.named_parameters():
        assert not e.requires_grad
        assert not torch.equal(e, live[name])
    model = ViewFusion.from_config(tr.config)
    model.unet.load_state_dict(shadow.unet.state_dict())
    got = tr._generate_np(_host_batch(data)["cond"], COUNTS, data["angle"],
                          key_salt=1)
    gen, cond, vc, angle = tr._gen_inputs(_host_batch(data)["cond"], COUNTS,
                                          data["angle"], 1)
    want = model.generate(cond, vc, angle, sample_num=SAMPLE_NUM,
                          generator=gen)
    np.testing.assert_array_equal(got.generated_samples,
                                  want.generated_samples.numpy())


def test_chain_segments_and_salts(setup):
    """tpu.chain_segments gives the one-call chain bit for bit; the
    (seed + 23, salt) generator repeats for a salt and differs across
    salts; the ddpm sample-only path is the chain's final frame."""
    _, params, data = setup
    cond = _host_batch(data)["cond"]
    outs = [_trainer(params, chain_segments=s)._generate_np(
        cond, COUNTS, data["angle"], key_salt=2) for s in (1, 3)]
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    frames = (T - 1) // (T // SAMPLE_NUM) + 1
    assert outs[0].ret_arr.shape == (B, frames + 1, HW, HW, 3)
    tr = _trainer(params)
    np.testing.assert_array_equal(
        tr._sample_only_np(cond, COUNTS, data["angle"], key_salt=2),
        outs[0].generated_samples)
    draws = [salted_generator(23, s, "cpu").initial_seed() for s in (0, 0, 1)]
    assert draws[0] == draws[1] != draws[2]
