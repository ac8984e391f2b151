"""The port's training step against the JAX package, on the CPU.

The same seeded numpy inputs go through the JAX functions and their port
counterparts at TINY_CONFIG's sizes.  JAX initialises the UNet; its
params cross over through ``viewfusion_tpu_torch.utils.convert`` and the
port's gradients and parameters come back through
``viewfusion_tpu.utils.torch_convert.convert_unet_state_dict`` for the
comparison.  The JAX losses draw t, u and the noise from one key split;
the tests reproduce those draws and feed them to the port
(``noise=``/``sample_gammas=``).  The GroupNorm backward is held against
the Pallas kernel ``_pallas_bwd`` in interpret mode; the port's kernel
wrappers run their plain versions here (tests/test_torch_port_cuda.py
holds the CUDA kernels against them on a card).

Tolerances and why:
  * f32 GroupNorm/attention gradients: <= 2e-6 of the gradient scale
    (f32 sums in another order); bf16 dx within one bf16 ulp of its
    scale (both sides round the same f32 value once);
  * losses <= 1e-6 relative (f32, same draws; the convolutions run other
    batch compositions and sum in another order);
  * UNet parameter gradients <= 1e-4 of the largest gradient (the bound
    the port is held to; measured ~1e-6);
  * one Adam update on equal gradients and parameters <= 1e-7 (optax and
    torch.optim order the bias correction differently: a few ulps of the
    update, ~1e-3 here, and the sum may round to a neighbouring float,
    <= 6e-8 for parameters below 1 in magnitude);
  * the EMA after it <= 2e-7 (the parameter's ulp carried into the
    shadow, plus its own rounding);
  * the 3-step loss trajectory <= 1e-5 relative (measured ~1e-7).  The
    parameters are held only to the learning rate: Adam divides each
    gradient by its own running scale, and some gradients are rounding
    noise in both stacks (the logit channels' output bias has an exactly
    zero gradient: the softmax over views ignores a shared shift), so
    such an element moves by up to ~lr in either direction; measured
    2.3e-4 at lr 1e-3.
"""

import copy
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.conftest import TINY_CONFIG
from viewfusion_tpu.config import Config as JaxConfig
from viewfusion_tpu.models.unet import UNet as JaxUNet
from viewfusion_tpu.models.view_fusion import ViewFusion as JaxViewFusion
from viewfusion_tpu.ops.attention import \
    spatial_self_attention as jax_attention
from viewfusion_tpu.ops.groupnorm import _pallas_bwd
from viewfusion_tpu.ops.groupnorm import group_norm_act as jax_gn
from viewfusion_tpu.training import trainer as jax_trainer
from viewfusion_tpu.training.schedulers import lr_schedule as jax_lr_schedule
from viewfusion_tpu.utils.torch_convert import convert_unet_state_dict
from viewfusion_tpu_torch import tracing
from viewfusion_tpu_torch.config import Config
from viewfusion_tpu_torch.models.unet import ResnetBlocWithAttn, UNet
from viewfusion_tpu_torch.models.view_fusion import ViewFusion
from viewfusion_tpu_torch.ops.attention import spatial_self_attention
from viewfusion_tpu_torch.ops.groupnorm import (
    group_norm_act, group_norm_act_backward,
    group_norm_act_backward_reference, group_norm_act_reference)
from viewfusion_tpu_torch.training.schedulers import lr_schedule
from viewfusion_tpu_torch.training.trainer import (Trainer, norm_img,
                                                   global_packed_counts,
                                                   packed_indices,
                                                   stratified_count_multiset)
from viewfusion_tpu_torch.utils.convert import unet_state_dict_from_jax
from viewfusion_tpu_torch.utils.device import to_device

torch.set_num_threads(2)

B, N, HW = 4, 3, 8      # samples, max_views (TINY_CONFIG), image size
EMA = 0.9


def _bf16_ulp(scale: float) -> float:
    return 2.0 ** (np.floor(np.log2(scale)) - 7)


def _bf16_round(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


# ---------------------------------------------------------------------
# the ops: GroupNorm backward (K2's plain version) and the Functions
# ---------------------------------------------------------------------
# (B, H, W, C, G): channels per group 2 and 3, an odd spatial size
GN_SHAPES = [(2, 8, 8, 64, 32), (3, 5, 7, 24, 8)]


def _gn_case(seed, shape, dtype):
    b, h, w, c, _ = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(0.5, 1.5, (b, h * w, c)).astype(np.float32)
    g = rng.normal(0.0, 1.0, (b, h * w, c)).astype(np.float32)
    if dtype == "bfloat16":  # values exactly representable in both
        x, g = _bf16_round(x), _bf16_round(g)
    scale = rng.normal(1.0, 0.5, c).astype(np.float32)
    bias = rng.normal(0.0, 0.5, c).astype(np.float32)
    return x, g, scale, bias


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["none", "silu"])
@pytest.mark.parametrize("shape", GN_SHAPES)
def test_group_norm_backward_matches_pallas(shape, act, dtype):
    """dx and the per-sample dscale/dbias partials against the Pallas
    backward (interpret mode) from the same saved statistics."""
    x, g, scale, bias = _gn_case(4, shape, dtype)
    groups = shape[-1]
    tdt = getattr(torch, dtype)
    tx, tg = (torch.from_numpy(a.copy()).to(tdt) for a in (x, g))
    ts, tb = torch.from_numpy(scale), torch.from_numpy(bias)
    _, mean, rstd = group_norm_act_reference(tx, ts, tb, groups=groups)
    before = group_norm_act_backward.launches
    dx, dsc, dbi = group_norm_act_backward(tx, tg, ts, tb, mean, rstd,
                                           groups=groups, act=act)
    assert group_norm_act_backward.launches == before  # plain version
    ref = group_norm_act_backward_reference(tx, tg, ts, tb, mean, rstd,
                                            groups=groups, act=act)
    for a, r in zip((dx, dsc, dbi), ref):
        assert torch.equal(a, r)
    jdt = getattr(jnp, dtype)
    jdx, jdsc, jdbi = _pallas_bwd(
        jnp.asarray(x, jdt), jnp.asarray(scale), jnp.asarray(bias),
        jnp.asarray(mean.numpy()[:, None, :]),
        jnp.asarray(rstd.numpy()[:, None, :]), jnp.asarray(g, jdt), groups,
        1e-5, act, True)
    assert dx.dtype == tdt and dx.shape == x.shape
    assert dsc.shape == dbi.shape == (shape[0], shape[3])
    want = np.asarray(jdx.astype(jnp.float32))
    scale_dx = np.abs(want).max()
    tol = 2e-6 * scale_dx if dtype == "float32" else _bf16_ulp(scale_dx)
    assert np.abs(dx.float().numpy() - want).max() <= tol
    for got, w in ((dsc, jdsc), (dbi, jdbi)):
        w = np.asarray(w)
        np.testing.assert_allclose(got.numpy(), w, rtol=0,
                                   atol=2e-6 * np.abs(w).max())


@pytest.mark.parametrize("act", ["none", "silu"])
def test_group_norm_autograd_matches_jax_vjp(act):
    """torch.autograd through the GroupNorm Function against jax.vjp of
    the JAX op on its Pallas path (custom VJP, interpret mode)."""
    x, g, scale, bias = _gn_case(5, (2, 6, 6, 40, 8), "float32")
    y_j, vjp = jax.vjp(
        lambda a, s, b: jax_gn(a, s, b, groups=8, act=act, use_pallas=True),
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    want = vjp(jnp.asarray(g))
    tx, ts, tb = (torch.from_numpy(a).requires_grad_()
                  for a in (x, scale, bias))
    y = group_norm_act(tx, ts, tb, groups=8, act=act)
    assert y.grad_fn is not None
    y.backward(torch.from_numpy(g))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j),
                               atol=1e-5, rtol=0)
    for got, w in zip((tx.grad, ts.grad, tb.grad), want):
        w = np.asarray(w)
        np.testing.assert_allclose(got.numpy(), w, rtol=0,
                                   atol=2e-6 * np.abs(w).max())


@pytest.mark.parametrize("strided, shape", [
    pytest.param(False, (2, 36, 24), id="False"),
    pytest.param(True, (2, 36, 24), id="True"),
    # heads of 64 (K5's on the card) at a tiny batch: the DiT's S = 256,
    # the ADM's S = 1024, 256 and 64
    pytest.param(False, (2, 256, 64), id="dit-s256"),
    pytest.param(False, (1, 1024, 64), id="adm-s1024"),
    pytest.param(True, (3, 256, 64), id="adm-s256"),
    pytest.param(False, (4, 64, 64), id="adm-s64")])
def test_attention_autograd_matches_jax_vjp(strided, shape):
    """Closed-form attention backward against jax.vjp of the JAX op on
    its Pallas path; q, k, v as column slices of one qkv buffer (the
    gradient lands in that buffer) or as separate tensors."""
    b, s, c = shape
    rng = np.random.default_rng(6)
    qkv = rng.normal(size=(b, s, 3 * c)).astype(np.float32)
    g = rng.normal(size=(b, s, c)).astype(np.float32)
    scale = 1.0 / np.sqrt(c)
    parts = [qkv[..., i * c:(i + 1) * c] for i in range(3)]
    _, vjp = jax.vjp(lambda q, k, v: jax_attention(q, k, v, scale, True),
                     *(jnp.asarray(p) for p in parts))
    want = np.concatenate([np.asarray(w) for w in vjp(jnp.asarray(g))], -1)
    before = spatial_self_attention.launches
    if strided:
        t = torch.from_numpy(qkv).requires_grad_()
        out = spatial_self_attention(t[..., :c], t[..., c:2 * c],
                                     t[..., 2 * c:], scale)
        out.backward(torch.from_numpy(g))
        got = t.grad.numpy()
    else:
        ts = [torch.from_numpy(np.ascontiguousarray(p)).requires_grad_()
              for p in parts]
        out = spatial_self_attention(*ts, scale)
        out.backward(torch.from_numpy(g))
        got = np.concatenate([p.grad.numpy() for p in ts], -1)
    assert out.grad_fn is not None
    assert spatial_self_attention.launches == before
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-6 * np.abs(want).max())


@pytest.mark.parametrize("c, route", [(64, "k5"), (192, "closed_form"),
                                      (320, "closed_form")])
def test_attention_backward_route_by_head_width(monkeypatch, c, route):
    """On the card the backward is chosen by the head width: the DiT's
    and ADM's heads of 64 take K5, the UNet's single heads of 192 and 320
    the closed form; the CPU and f32 always take the closed form.  Through
    the autograd Function (told the tensors are on the card, K5's launch
    stubbed by the closed form) the counters ``k5.launches`` and
    ``attn_bwd.closed_form_calls`` show which ran, and the gradients are
    the closed form's."""
    from viewfusion_tpu_torch.ops import attention as attn

    real = attn.backward_route
    assert real("cuda", c, torch.bfloat16) == route
    assert real("cpu", c, torch.bfloat16) == "closed_form"
    assert real("cuda", c, torch.float32) == "closed_form"
    rng = np.random.default_rng(c)
    qkv = torch.from_numpy(rng.normal(size=(3, 2, 40, c)).astype(
        np.float32)).bfloat16()
    g = torch.from_numpy(rng.normal(size=(2, 40, c)).astype(np.float32))

    def grads():
        ts = [t.clone().requires_grad_() for t in qkv]
        spatial_self_attention(*ts, c ** -0.5).backward(g)
        return [t.grad for t in ts]

    before = tracing.counters()
    want = grads()  # on the CPU: the closed form
    after = tracing.counters()
    assert after["k5.launches"] == before["k5.launches"]
    assert after["attn_bwd.closed_form_calls"] == \
        before["attn_bwd.closed_form_calls"] + 1
    monkeypatch.setattr(attn, "backward_route",
                        lambda dev, cc, dt: real("cuda", cc, dt))
    monkeypatch.setattr(
        attn, "_launch_backward",
        lambda q, k, v, gg, scale, plan:
        attn.spatial_self_attention_backward(q, k, v, gg, scale))
    got = grads()
    last = tracing.counters()
    k5 = last["k5.launches"] - after["k5.launches"]
    closed = (last["attn_bwd.closed_form_calls"]
              - after["attn_bwd.closed_form_calls"])
    assert (k5, closed) == ((1, 0) if route == "k5" else (0, 1))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_attention_backward_kernel_refuses_what_it_does_not_take():
    """K5's wrapper checks before it launches: k and v match q in shape,
    dtype and strides; g has q's shape; bf16; heads of 64; contiguous
    channels and 8-element row steps; CUDA tensors."""
    from viewfusion_tpu_torch.ops.attention import attention_backward

    q = torch.zeros((2, 16, 64), dtype=torch.bfloat16)
    g = torch.zeros((2, 16, 64))
    with pytest.raises(ValueError, match="match q"):
        attention_backward(q, q.float(), q, g, 1.0)
    with pytest.raises(ValueError, match="match q"):
        attention_backward(q, q[:, :8], q, g, 1.0)
    with pytest.raises(ValueError, match="g must be"):
        attention_backward(q, q, q, g[:, :8], 1.0)
    with pytest.raises(ValueError, match="bfloat16"):
        attention_backward(q.float(), q.float(), q.float(), g, 1.0)
    t = torch.zeros((2, 16, 32), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="heads of 64"):
        attention_backward(t, t, t, torch.zeros((2, 16, 32)), 1.0)
    t = torch.zeros((2, 64, 16), dtype=torch.bfloat16).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        attention_backward(t, t, t, g, 1.0)
    rows = torch.zeros((2, 16, 3 * 64 + 4), dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="multiples of 8"):
        attention_backward(rows, rows, rows, g, 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        attention_backward(q, q, q, g, 1.0)


# ---------------------------------------------------------------------
# the model: losses, gradients, the train step
# ---------------------------------------------------------------------
def _raw(**tpu):
    raw = copy.deepcopy(TINY_CONFIG)
    raw["tpu"].update(dict(packed_views=True, peak_lr=1e-3, lr_warmup=1,
                           ema_decay=EMA), **tpu)
    return raw


@pytest.fixture(scope="module")
def jax_setup():
    """The JAX model and its init params, perturbed so that biases and
    norms are not trivial."""
    jcfg = JaxConfig.from_dict(_raw())
    model = JaxViewFusion.from_config(jcfg)
    init = jax.jit(JaxUNet(config=jcfg.unet, dtype=jnp.float32).init)
    p = _jax_init(init, 0)
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(0, 0.1, a.shape).astype(
            np.float32), p)
    return jcfg, model, params, init


def _jax_init(init, seed):
    return init(jax.random.PRNGKey(seed),
                np.zeros((1, HW, HW, 6), np.float32),
                np.zeros(1, np.float32), np.ones(1, np.float32))


@pytest.fixture(scope="module")
def jax_loss_grad(jax_setup):
    _, model, _, _ = jax_setup

    def loss(params, key, batch):
        return model.loss_packed(
            params, key, batch["target"], batch["cond"],
            batch["view_count"], batch["angle"], batch["sample_idx"],
            batch["view_idx"])

    return jax.jit(jax.value_and_grad(loss))


def _batch(seed, salt=0, b=B):
    rng = np.random.default_rng(seed)
    counts, si, vi = global_packed_counts(0, salt, b, N)
    return dict(
        target=rng.uniform(0, 1, (b, HW, HW, 3)).astype(np.float32),
        cond=rng.uniform(0, 1, (b, N, HW, HW, 3)).astype(np.float32),
        angle=rng.uniform(0, 6.3, b).astype(np.float32),
        view_count=counts.astype(np.int32), sample_idx=si, view_idx=vi)


def _jax_draws(model, key, b=B):
    """The draws of the JAX loss: t, u and the noise from one key split."""
    k_t, k_u, k_noise, _ = jax.random.split(key, 4)
    sched = model.schedule
    t = jax.random.randint(k_t, (b,), 1, sched.num_timesteps)
    g1, g2 = jnp.take(sched.gammas, t - 1), jnp.take(sched.gammas, t)
    u = jax.random.uniform(k_u, (b,))
    noise = jax.random.normal(k_noise, (b, HW, HW, 3), jnp.float32)
    return np.asarray((g2 - g1) * u + g1), np.asarray(noise)


def _trainer(params, **tpu):
    return Trainer(Config.from_dict(_raw(**tpu)), device="cpu",
                   state_dict=unet_state_dict_from_jax(params))


def _as_jax_tree(named, jcfg):
    """Port tensors by state_dict name -> the JAX params tree."""
    sd = {k: v.detach().numpy().copy() for k, v in named}
    return convert_unet_state_dict(sd, jcfg.unet, prefix="")


def _tree_max_err(got, want):
    errs = jax.tree_util.tree_map(
        lambda a, b: float(np.abs(np.asarray(a) - np.asarray(b)).max()),
        got, want)
    return max(jax.tree_util.tree_leaves(errs))


def _tree_max_abs(tree):
    return max(float(np.abs(np.asarray(a)).max())
               for a in jax.tree_util.tree_leaves(tree))


def _port_loss(model, batch, gammas, noise, packed=True):
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    args = (t["target"], t["cond"], t["view_count"].long(), t["angle"])
    kw = dict(noise=torch.from_numpy(noise.copy()),
              sample_gammas=torch.from_numpy(gammas.copy()))
    if packed:
        return model.loss_packed(*args, t["sample_idx"].long(),
                                 t["view_idx"].long(), **kw)
    return model.loss(*args, **kw)


def test_unet_gradients_match_jax_grad(jax_setup, jax_loss_grad):
    """loss_packed and every UNet parameter gradient in f32 against
    jax.value_and_grad of the JAX loss_packed."""
    jcfg, model, params, _ = jax_setup
    batch, key = _batch(7), jax.random.PRNGKey(3)
    loss_j, grads_j = jax_loss_grad(params, key, batch)
    tr = _trainer(params)
    loss = _port_loss(tr.model, batch, *_jax_draws(model, key))
    loss.backward()
    assert abs(loss.item() - float(loss_j)) <= 1e-6 * abs(float(loss_j))
    grads = _as_jax_tree(((k, p.grad) for k, p in
                          tr.model.unet.named_parameters()), jcfg)
    assert _tree_max_err(grads, grads_j) <= 1e-4 * _tree_max_abs(grads_j)


def test_dense_and_packed_losses_match_jax(jax_setup):
    """JAX loss (dense) with its own draws fed to the port's loss and
    loss_packed: all three agree."""
    jcfg, model, params, _ = jax_setup
    batch, key = _batch(8), jax.random.PRNGKey(4)
    want = float(jax.jit(lambda p, k, b: model.loss(
        p, k, b["target"], b["cond"], b["view_count"], b["angle"]))(
            params, key, batch))
    port = ViewFusion.from_config(Config.from_dict(_raw()))
    port.unet.load_state_dict(unet_state_dict_from_jax(params))
    draws = _jax_draws(model, key)
    mark = tracing.mark()
    with torch.no_grad():
        dense = _port_loss(port, batch, *draws, packed=False).item()
        packed = _port_loss(port, batch, *draws).item()
    assert abs(dense - want) <= 1e-6 * abs(want)
    assert abs(packed - dense) <= 1e-6 * abs(dense)
    assert len(tracing.spans("unet.forward", after=mark)) == 2


@pytest.fixture(scope="module")
def jax_update(jax_setup):
    """optax.adam with the config's schedule, then the EMA, jitted:
    (params, opt_state, ema, grads) -> the same after one update."""
    t = jax_setup[0].train
    tx = optax.adam(jax_lr_schedule(peak_lr=t.peak_lr, peak_it=t.lr_warmup,
                                    decay_rate=t.decay_rate,
                                    decay_it=t.decay_it),
                    b1=0.9, b2=0.999, eps=1e-8)

    def update(params, opt, ema, grads):
        upd, opt = tx.update(grads, opt, params)
        params = optax.apply_updates(params, upd)
        ema = jax.tree_util.tree_map(
            lambda e, p: EMA * e + (1.0 - EMA) * p, ema, params)
        return params, opt, ema

    return tx.init, jax.jit(update)


def test_adam_update_matches_optax(jax_setup, jax_update):
    """Three updates on identical gradients against optax.adam with the
    same schedule, and the EMA; under warmup the first update is exactly
    zero.  Parameters are drawn in (-0.9, 0.9), where one f32 ulp is
    <= 6e-8: the two optimizers order the update's arithmetic
    differently, so a parameter may round to a neighbouring float."""
    jcfg, _, params, _ = jax_setup
    init, update = jax_update
    rng = np.random.default_rng(9)
    params = jax.tree_util.tree_map(
        lambda a: rng.uniform(-0.9, 0.9, a.shape).astype(np.float32), params)
    p_j, opt, ema_j = params, init(params), params
    tr = _trainer(params)
    names = [k for k, _ in tr.model.unet.named_parameters()]
    delta = lambda new, old: jax.tree_util.tree_map(  # noqa: E731
        lambda x, y: np.asarray(x, np.float64) - np.asarray(y, np.float64),
        new, old)
    for step in range(3):
        grads = jax.tree_util.tree_map(
            lambda a: rng.normal(0, 1, a.shape).astype(np.float32), params)
        before_j = p_j
        p_j, opt, ema_j = update(p_j, opt, ema_j, grads)
        before = _as_jax_tree(tr.model.unet.named_parameters(), jcfg)
        sd = unet_state_dict_from_jax(grads)
        for name, p in tr.model.unet.named_parameters():
            p.grad = sd[name]
        tr.apply_update()
        got = _as_jax_tree(tr.model.unet.named_parameters(), jcfg)
        if step == 0:
            assert _tree_max_abs(delta(got, before)) == 0.0
        assert _tree_max_err(delta(got, before),
                             delta(p_j, before_j)) <= 1e-7
    # each nonzero update may round a parameter to a neighbouring float
    assert _tree_max_err(got, p_j) <= 2 * 6e-8
    ema = _as_jax_tree(zip(names, tr.ema), jcfg)
    assert _tree_max_err(ema, ema_j) <= 2e-7
    assert tr.step == 3


def test_three_step_trajectory_matches_jax(jax_setup, jax_loss_grad,
                                           jax_update):
    """Three train steps (the first a zero update under warmup) through
    Trainer.train_step against the JAX loss_packed + optax + EMA, with
    the JAX draws of each step fed to the port."""
    jcfg, model, params, _ = jax_setup
    init, update = jax_update
    p_j, opt, ema_j = params, init(params), params
    tr = _trainer(params)
    for it in range(3):
        batch, key = _batch(20 + it, salt=it), jax.random.PRNGKey(50 + it)
        loss_j, g = jax_loss_grad(p_j, key, batch)
        p_j, opt, ema_j = update(p_j, opt, ema_j, g)
        gammas, noise = _jax_draws(model, key)
        loss = tr.train_step(batch, noise=noise, sample_gammas=gammas)
        assert loss.requires_grad is False
        assert abs(loss.item() - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    lr = jcfg.train.peak_lr
    got = _as_jax_tree(tr.model.unet.named_parameters(), jcfg)
    assert _tree_max_err(got, p_j) <= lr
    names = [k for k, _ in tr.model.unet.named_parameters()]
    assert _tree_max_err(_as_jax_tree(zip(names, tr.ema), jcfg),
                         ema_j) <= lr


def test_grad_accum_matches_one_full_batch(jax_setup):
    """grad_accum=2 over two microbatches of 4 against one step on the
    batch of 8 they make up, with the same draws: the same loss and
    gradient (mean over microbatches), and parameters within the
    learning rate (Adam's update of a rounding-noise gradient, see the
    module docstring)."""
    _, _, params, _ = jax_setup
    halves = [_batch(30, salt=0), _batch(31, salt=1)]
    rng = np.random.default_rng(32)
    noise = rng.normal(size=(2, B, HW, HW, 3)).astype(np.float32)
    gammas = rng.uniform(0.05, 0.95, (2, B)).astype(np.float32)
    acc = _trainer(params, grad_accum=2, lr_warmup=0)
    loss_acc = acc.train_step(
        {k: np.stack([h[k] for h in halves]) for k in halves[0]},
        noise=noise, sample_gammas=gammas)
    counts = np.concatenate([h["view_count"] for h in halves])
    si, vi = packed_indices(counts)
    full = {k: np.concatenate([h[k] for h in halves]) for k in
            ("target", "cond", "angle")}
    full.update(view_count=counts, sample_idx=si, view_idx=vi)
    one = _trainer(params, lr_warmup=0)
    loss_one = one.train_step(full, noise=noise.reshape(2 * B, HW, HW, 3),
                              sample_gammas=gammas.reshape(-1))
    assert abs(loss_acc.item() - loss_one.item()) <= 1e-6 * loss_one.item()
    gmax = max(p.grad.abs().max().item() for p in one.params)
    for a, b in zip(acc.params, one.params):
        assert (a.grad - b.grad).abs().max().item() <= 1e-6 * gmax
        assert (a - b).abs().max().item() <= acc.lr_fn(0)


def _read_only(a):
    a = a.copy()
    a.setflags(write=False)
    return a


@pytest.mark.parametrize("kind", ["numpy", "read_only", "cpu_tensor",
                                  "microbatch_list"])
def test_trainer_loads_uint8_batches_and_counts_no_launch(jax_setup, kind):
    """The loader's layout (uint8 images) trains on the CPU through the
    plain versions from every input kind ``to_device`` takes: numpy
    arrays, read-only ones, CPU tensors, and under grad accumulation a
    list of the K microbatches' arrays.  Each loss equals the numpy
    batch's on a second trainer, the launch counters do not move, and
    the parameters change after the (zero) warmup update."""
    _, _, params, _ = jax_setup
    k = 2 if kind == "microbatch_list" else 1
    tr, ref = (_trainer(params, grad_accum=k) for _ in range(2))
    rng = np.random.default_rng(40)
    counters = (group_norm_act.launches, group_norm_act_backward.launches,
                spatial_self_attention.launches)
    start = [p.detach().clone() for p in tr.params]
    for it in range(2):
        micro = []
        for j in range(k):
            mb = _batch(41 + it * k + j, salt=it * k + j)
            mb["target"] = rng.integers(0, 256, (B, HW, HW, 3), np.uint8)
            mb["cond"] = rng.integers(0, 256, (B, N, HW, HW, 3), np.uint8)
            micro.append(mb)
        host = micro[0] if k == 1 else {
            key: np.stack([m[key] for m in micro]) for key in micro[0]}
        given = {"numpy": lambda: host,
                 "read_only": lambda: {key: _read_only(v)
                                       for key, v in host.items()},
                 "cpu_tensor": lambda: {key: torch.from_numpy(v.copy())
                                        for key, v in host.items()},
                 "microbatch_list": lambda: {key: [m[key] for m in micro]
                                             for key in micro[0]}}[kind]()
        loss = tr.train_step(given)
        assert np.isfinite(loss.item())
        assert torch.equal(loss, ref.train_step(host))
        changed = any(not torch.equal(a, b) for a, b in zip(tr.params, start))
        assert changed == (it == 1)
    assert counters == (group_norm_act.launches,
                        group_norm_act_backward.launches,
                        spatial_self_attention.launches)


def test_to_device_passes_what_is_on_the_device_through():
    """A tensor already on the target device comes back as the same
    storage, at any depth of the tree; a numpy array becomes a tensor
    over its own memory, a read-only one over a writeable copy; None
    stays None and the containers keep their types."""
    on = torch.arange(6.0).reshape(2, 3)
    a = np.arange(4, dtype=np.int32)
    ro = _read_only(np.ones((2, 2), np.uint8))
    out = to_device({"t": on, "l": [on, a], "p": (ro, None)}, "cpu")
    assert out["t"] is on and out["l"][0] is on
    assert out["l"][1].data_ptr() == a.ctypes.data
    assert isinstance(out["l"], list) and isinstance(out["p"], tuple)
    assert out["p"][1] is None
    assert out["p"][0].data_ptr() != ro.ctypes.data
    assert torch.equal(out["p"][0], torch.ones((2, 2), dtype=torch.uint8))
    assert to_device(on, torch.device("cpu")) is on


# ---------------------------------------------------------------------
# host helpers, init, refusals
# ---------------------------------------------------------------------
@pytest.mark.parametrize("b,max_views", [(28, 6), (8, 3), (13, 5), (1, 6)])
def test_host_helpers_match_jax_bit_for_bit(b, max_views):
    """Stratified counts, packed indices, salted counts and the uint8
    normalisation equal the JAX trainer's, dtypes included."""
    want = jax_trainer.stratified_count_multiset(b, max_views)
    got = stratified_count_multiset(b, max_views)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype
    for seed in (0, 7):
        fake = types.SimpleNamespace(
            config=types.SimpleNamespace(
                train=types.SimpleNamespace(seed=seed)),
            local_batch_size=b, max_views=max_views,
            _packed_indices=jax_trainer.Experiment._packed_indices)
        for salt in (0, 1, 5, 123):
            want = jax_trainer.Experiment._global_packed_counts(fake, salt)
            got = global_packed_counts(seed, salt, b, max_views)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
                assert g.dtype == w.dtype
    u8 = np.random.default_rng(b).integers(0, 256, (b, 4, 4, 3), np.uint8)
    np.testing.assert_array_equal(
        norm_img(torch.from_numpy(u8)).numpy(),
        np.asarray(jax_trainer._norm_img(jnp.asarray(u8))))


def test_lr_schedule_matches_jax():
    kw = dict(peak_lr=5e-5, peak_it=2500, decay_rate=0.16,
              decay_it=4_000_000)
    want, got = jax_lr_schedule(**kw), lr_schedule(**kw)
    its = [0, 1, 2, 1249, 2499, 2500, 2501, 10 ** 5, 4 * 10 ** 6]
    np.testing.assert_array_equal(
        np.array([got(i) for i in its], np.float32),
        np.array([want(i) for i in its], np.float32))
    assert got(0) == 0.0


def _kernel_sigmas(named):
    """Each conv/dense kernel divided by its flax lecun-normal sigma
    sqrt(1 / fan_in), with fan_in from the kernel's shape."""
    out = []
    for name, w in named:
        fan_in = int(np.prod(w.shape[:-1]))  # flax kernels: (..., in, out)
        out.append((name, w / np.sqrt(1.0 / fan_in)))
    return out


def test_fresh_init_follows_flax(jax_setup):
    """A fresh port UNet draws its kernels from flax's lecun-normal
    (truncated at two sigma, variance 1/fan_in), zero biases and unit
    GroupNorm scales; the pooled normalised kernels of the port and of a
    JAX init agree in their quantiles (sampling error ~0.01 here)."""
    jcfg, _, _, init = jax_setup
    torch.manual_seed(0)
    unet = UNet(Config.from_dict(TINY_CONFIG).unet)
    tree = _as_jax_tree(unet.named_parameters(), jcfg)
    j = _jax_init(init, 1)
    pooled = []
    for params in (tree, j):
        leaves = jax.tree_util.tree_leaves_with_path(params)
        kernels = [(jax.tree_util.keystr(k), np.asarray(v))
                   for k, v in leaves if "kernel" in jax.tree_util.keystr(k)]
        for k, v in leaves:
            name = jax.tree_util.keystr(k)
            if name.endswith("['bias']"):
                assert not np.asarray(v).any(), name
            if name.endswith("['scale']"):
                assert (np.asarray(v) == 1.0).all(), name
        norm = _kernel_sigmas(kernels)
        for name, z in norm:
            assert np.abs(z).max() <= 2.0 / 0.87962566103423978 + 1e-6, name
        pooled.append(np.concatenate([z.ravel() for _, z in norm]))
    qs = [0.02, 0.1, 0.25, 0.5, 0.75, 0.9, 0.98]
    np.testing.assert_allclose(np.quantile(pooled[0], qs),
                               np.quantile(pooled[1], qs), atol=0.05)
    assert abs(pooled[0].std() - 1.0) <= 0.03


def test_dropout_builds_and_trains():
    """dropout > 0 builds the UNet and the Trainer, and a dense step
    draws masks from the Trainer's generator (one per ResnetBlock's
    second Block, tests/test_torch_port_dropout.py holds them against
    JAX): the loss differs from the same step at p = 0."""
    raw = copy.deepcopy(TINY_CONFIG)
    raw["model"]["denoise_net_params"]["dropout"] = 0.1
    cfg = Config.from_dict(raw)
    assert ViewFusion.from_config(cfg).unet.dropout == 0.1
    batch = _batch(12)
    losses = []
    for p in (0.1, 0.0):
        raw["model"]["denoise_net_params"]["dropout"] = p
        tr = Trainer(Config.from_dict(raw), device="cpu", seed=3)
        before = tr.generator.get_state()
        losses.append(tr.train_step(batch).item())
        assert np.isfinite(losses[-1]) and tr.step == 1
        assert not torch.equal(tr.generator.get_state(), before)
    assert losses[0] != losses[1]


def test_remat_builds_and_recomputes(monkeypatch):
    """tpu.remat builds a UNet and a Trainer whose UNet recomputes each
    block in the backward: the blocks' forwards run twice per step
    (tests/test_torch_port_dit.py holds remat's gradients).  The forwards
    are counted on the class: module hooks do not fire in the
    recomputation."""
    raw = copy.deepcopy(TINY_CONFIG)
    raw["tpu"]["remat"] = True
    cfg = Config.from_dict(raw)
    assert ViewFusion.from_config(cfg).unet.remat
    unet = Trainer(cfg, device="cpu").model.unet
    assert unet.remat
    blocks = sum(isinstance(m, ResnetBlocWithAttn) for m in unet.modules())
    calls = []
    forward = ResnetBlocWithAttn.forward
    monkeypatch.setattr(ResnetBlocWithAttn, "forward",
                        lambda self, *a: calls.append(1) or forward(self, *a))
    rng = np.random.default_rng(0)
    hw, cin = unet.config.image_size, unet.config.in_channel
    x = torch.from_numpy(rng.normal(size=(2, hw, hw, cin)).astype(
        np.float32))
    out = unet(x, torch.ones(2), torch.full((2,), 0.5))
    assert blocks and len(calls) == blocks
    out.square().mean().backward()
    assert len(calls) == 2 * blocks
