"""The UNet's dropout in the port (``models/unet.py``) against the JAX
package's, on the CPU.

Dropout follows the fused GroupNorm+SiLU of each ResnetBlock's second
Block, as in JAX, and is on in the dense training loss only (JAX's
``loss_packed`` runs deterministic).  JAX's masks are recovered from
flax with ``capture_intermediates`` on the ``Dropout`` modules (a kept
element is nonzero) and fed to the port by module name.

Tolerances: the dense loss <= 1e-6 relative and every gradient <= 1e-4
of the largest (tests/test_torch_port_train.py's bounds); everything
else is exact (the same arithmetic on the same masks), and the keep rate
is held to five binomial standard deviations.
"""

import copy
import re

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import TINY_CONFIG
from tests.test_torch_port_train import _batch, _jax_draws
from viewfusion_tpu.config import Config as JaxConfig
from viewfusion_tpu.models.unet import UNet as JaxUNet
from viewfusion_tpu.models.view_fusion import ViewFusion as JaxViewFusion
from viewfusion_tpu_torch.config import Config
from viewfusion_tpu_torch.models.unet import Dropout, UNet
from viewfusion_tpu_torch.models.view_fusion import ViewFusion
from viewfusion_tpu_torch.training.trainer import Trainer
from viewfusion_tpu_torch.utils.convert import (_map_entries,
                                                unet_params_to_jax,
                                                unet_state_dict_from_jax)

torch.set_num_threads(2)
P, B, N, HW = 0.3, 4, 3, 8


def _raw(p=P, **tpu):
    raw = copy.deepcopy(TINY_CONFIG)
    raw["model"]["denoise_net_params"]["dropout"] = p
    raw["tpu"].update(dict(lr_warmup=0, peak_lr=1e-3), **tpu)
    return raw


@pytest.fixture(scope="module")
def jax_side():
    jcfg = JaxConfig.from_dict(_raw())
    model = JaxViewFusion.from_config(jcfg)
    init = jax.jit(JaxUNet(config=jcfg.unet, dtype=jnp.float32).init)
    p = init(jax.random.PRNGKey(0), np.zeros((1, HW, HW, 6), np.float32),
             np.zeros(1, np.float32), np.ones(1, np.float32))
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(0, 0.1, a.shape).astype(
            np.float32), p)
    return model, params


def _port_unet(params, p=P, remat=False):
    cfg = Config.from_dict(_raw(p))
    unet = UNet(cfg.unet, remat=remat)
    unet.load_state_dict(unet_state_dict_from_jax(params))
    return unet


def _dropout_names(names):
    """JAX Block path of each ResnetBlock's second Block -> the port's
    name of its dropout module."""
    out = {}
    for prefix, path, _, _ in _map_entries(names, jax_side=False):
        if re.search(r"\.res_block\.block2\.block\.0$", prefix):
            out[path[:-1]] = prefix[:-len("block.0")] + "block.2"
    return out


def _jax_masks(model, params, key, batch, noise, gammas, names):
    """The masks JAX's dense loss draws with ``key``: its UNet rows run
    with the loss's dropout key, the Dropout outputs captured."""
    _, _, _, k_drop = jax.random.split(key, 4)
    y = model.q_sample(jnp.asarray(batch["target"]),
                       jnp.asarray(gammas)[:, None, None, None],
                       jnp.asarray(noise))
    b, n = batch["cond"].shape[:2]
    x = jnp.concatenate([batch["cond"], jnp.broadcast_to(
        y[:, None], (b, n) + y.shape[1:])], -1).reshape(b * n, HW, HW, 6)
    rep = lambda v: jnp.repeat(jnp.asarray(v), n)  # noqa: E731
    _, state = model.denoise_fn.apply(
        params, x, rep(batch["angle"]), rep(gammas), deterministic=False,
        rngs={"dropout": k_drop}, mutable=["intermediates"],
        capture_intermediates=lambda m, _: isinstance(m, nn.Dropout))
    blocks = _dropout_names(names)
    masks = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            state["intermediates"]):
        keys = tuple(k.key for k in path if hasattr(k, "key"))
        masks[blocks[keys[:-2]]] = np.asarray(leaf) != 0
    assert len(masks) == len(blocks)
    return masks


def test_dense_loss_and_gradients_match_jax_with_its_masks(jax_side):
    model, params = jax_side
    batch, key = _batch(3, b=B), jax.random.PRNGKey(7)
    loss_j, grads_j = jax.jit(jax.value_and_grad(lambda q: model.loss(
        q, key, batch["target"], batch["cond"], batch["view_count"],
        batch["angle"], deterministic=False)))(params)
    gammas, noise = _jax_draws(model, key)
    port = ViewFusion.from_config(Config.from_dict(_raw()))
    port.unet = _port_unet(params)
    names = [k for k, _ in port.unet.named_parameters()]
    masks = _jax_masks(model, params, key, batch, noise, gammas, names)
    kept = np.mean([m.mean() for m in masks.values()])
    assert abs(kept - (1 - P)) < 0.05
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    loss = port.loss(t["target"], t["cond"], t["view_count"].long(),
                     t["angle"], noise=torch.from_numpy(noise.copy()),
                     sample_gammas=torch.from_numpy(gammas.copy()),
                     dropout=masks)
    loss.backward()
    want = float(loss_j)
    assert abs(loss.item() - want) <= 1e-6 * abs(want)
    grads = unet_params_to_jax({k: p.grad for k, p in
                                port.unet.named_parameters()})
    err = max(float(np.abs(np.asarray(a) - np.asarray(b)).max()) for a, b in
              zip(jax.tree_util.tree_leaves(grads),
                  jax.tree_util.tree_leaves(grads_j)))
    gmax = max(float(np.abs(np.asarray(a)).max())
               for a in jax.tree_util.tree_leaves(grads_j))
    assert err <= 1e-4 * gmax
    # without the masks the same loss differs: dropout was on
    with torch.no_grad():
        plain = port.loss(t["target"], t["cond"], t["view_count"].long(),
                          t["angle"], noise=torch.from_numpy(noise.copy()),
                          sample_gammas=torch.from_numpy(gammas.copy()))
    assert plain.item() != loss.item()


def _unet_inputs(seed=1, rows=12):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.normal(size=(rows, HW, HW, 6)).astype(
        np.float32)), torch.from_numpy(rng.uniform(0, 6, rows).astype(
            np.float32)), torch.from_numpy(rng.uniform(0, 1, rows).astype(
                np.float32)))


def test_without_dropout_the_forward_is_unchanged(jax_side):
    """p = 0 with a generator given, and p > 0 without one (eval, the
    samplers), give the forward of a UNet without dropout, bit for bit;
    p = 0 draws nothing from the generator."""
    _, params = jax_side
    x = _unet_inputs()
    base = _port_unet(params, p=0.0)(*x)
    g = torch.Generator().manual_seed(3)
    state = g.get_state()
    assert torch.equal(_port_unet(params, p=0.0)(*x, dropout=g), base)
    assert torch.equal(g.get_state(), state)
    assert torch.equal(_port_unet(params, p=P)(*x), base)
    with torch.no_grad():
        assert torch.equal(_port_unet(params, p=P).eval()(*x), base)


def test_keep_rate_and_scale(jax_side):
    """Each dropout's output is its input / (1 - p) where kept and 0
    elsewhere; the kept share is within five binomial sigmas of 1 - p."""
    _, params = jax_side
    unet = _port_unet(params)
    seen = []
    for m in unet.modules():
        if isinstance(m, Dropout) and m.p > 0:
            m.register_forward_hook(lambda mod, a, out: seen.append(
                (a[0], a[1], out)))
    unet(*_unet_inputs(rows=24), dropout=torch.Generator().manual_seed(0))
    assert len(seen) == sum(isinstance(m, Dropout) and m.p > 0
                            for m in unet.modules()) > 0
    total = kept = 0
    for x, mask, out in seen:
        assert torch.equal(out, torch.where(mask, x / (1 - P), 0.0))
        total += mask.numel()
        kept += int(mask.sum())
    sigma = np.sqrt(total * P * (1 - P))
    assert abs(kept - total * (1 - P)) <= 5 * sigma


def test_remat_gives_the_gradients_of_no_remat_with_dropout_on(jax_side):
    """Masks drawn before each checkpointed block: the recomputation sees
    the same masks, so the gradients equal those without remat."""
    _, params = jax_side
    x = _unet_inputs()
    grads = []
    for remat in (False, True):
        unet = _port_unet(params, remat=remat)
        out = unet(*x, dropout=torch.Generator().manual_seed(5))
        out.square().mean().backward()
        grads.append({k: p.grad for k, p in unet.named_parameters()})
    for k in grads[0]:
        assert torch.equal(grads[0][k], grads[1][k]), k


def test_packed_training_ignores_dropout(jax_side):
    """As in JAX, the packed loss runs without dropout: a step at p > 0
    equals the step at p = 0 bit for bit, draws included."""
    _, params = jax_side
    batch = _batch(9, b=B)
    out = []
    for p in (0.0, P):
        tr = Trainer(Config.from_dict(_raw(p, packed_views=True)),
                     device="cpu", state_dict=unet_state_dict_from_jax(
                         params))
        loss = tr.train_step(batch)
        out.append((loss, [q.detach().clone() for q in tr.params],
                    tr.generator.get_state()))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))
    assert torch.equal(out[0][2], out[1][2])
