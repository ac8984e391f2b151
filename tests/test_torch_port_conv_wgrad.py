"""The port's conv3x3 weight gradient (K4's plain version on the CPU) and
its ``conv3x3`` op against the JAX package.

The same seeded numpy inputs go through JAX's ``conv3x3_wgrad`` (the
Pallas kernel in interpret mode) and the port's; the port's result is
also held against ``torch.nn.grad.conv2d_weight``, an independent oracle
(transposed from HWIO to PyTorch's OIHW).  The op's gradients are held
against ``jax.grad`` of JAX's ``conv3x3(..., "pallas-interpret")``.

Tolerances and why:
  * f32: atol = rtol = 1e-4, the JAX package's own bound
    (tests/test_conv_wgrad.py): f32 sums over B*H*W in another order;
  * bf16 inputs: 1e-3 of the result's scale; both sides widen the bf16
    values to f32 exactly and sum in f32, in another order;
  * the op's forward is ``F.conv2d`` itself: equal bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from viewfusion_tpu.ops.conv_wgrad import conv3x3 as jax_conv3x3
from viewfusion_tpu.ops.conv_wgrad import conv3x3_wgrad as jax_wgrad
from viewfusion_tpu_torch.ops.conv_wgrad import (conv3x3, conv3x3_wgrad,
                                                 conv3x3_wgrad_reference)

torch.set_num_threads(2)
torch.backends.cudnn.allow_tf32 = False

# (B, H, W, Cin, Cout): tests/test_conv_wgrad.py's shapes plus the UNet's
# ragged first conv (Cin = 6)
SHAPES = [(2, 8, 8, 4, 8), (3, 5, 7, 6, 4), (1, 16, 16, 8, 8),
          (2, 4, 4, 3, 5), (2, 8, 8, 6, 16)]


def _inputs(shape, seed=0):
    b, h, w, cin, cout = shape
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, w, cin)).astype(np.float32),
            rng.standard_normal((b, h, w, cout)).astype(np.float32))


@pytest.mark.parametrize("shape", SHAPES)
def test_wgrad_matches_jax_and_the_torch_oracle(shape):
    x, g = _inputs(shape)
    want = np.asarray(jax_wgrad(jnp.asarray(x), jnp.asarray(g),
                                interpret=True))
    got = conv3x3_wgrad(torch.from_numpy(x), torch.from_numpy(g))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    oracle = torch.nn.grad.conv2d_weight(
        torch.from_numpy(x).permute(0, 3, 1, 2), (shape[4], shape[3], 3, 3),
        torch.from_numpy(g).permute(0, 3, 1, 2), padding=1)
    np.testing.assert_allclose(got.permute(3, 2, 0, 1).numpy(),
                               oracle.numpy(), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("shape", SHAPES)
def test_wgrad_bf16_inputs_match_jax(shape):
    x, g = _inputs(shape, seed=1)
    xb, gb = (torch.from_numpy(a).bfloat16() for a in (x, g))
    want = np.asarray(jax_wgrad(jnp.asarray(x, jnp.bfloat16),
                                jnp.asarray(g, jnp.bfloat16),
                                interpret=True))
    got = conv3x3_wgrad(xb, gb).numpy()
    assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max()
    # the plain version widens first: the same as f32 inputs of equal value
    np.testing.assert_array_equal(
        got, conv3x3_wgrad_reference(xb.float(), gb.float()).numpy())


@pytest.mark.parametrize("impl", ["kernel", "library"])
def test_conv3x3_gradients_match_jax(impl):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    k = (rng.standard_normal((3, 3, 4, 8)) * 0.1).astype(np.float32)
    t = rng.standard_normal((2, 8, 8, 8)).astype(np.float32)

    def f_jax(x_, k_):
        return jnp.sum((jax_conv3x3(x_, k_, "pallas-interpret") - t) ** 2)

    gx_j, gk_j = jax.grad(f_jax, argnums=(0, 1))(jnp.asarray(x),
                                                 jnp.asarray(k))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    wt = torch.from_numpy(k).permute(3, 2, 0, 1).contiguous().requires_grad_()
    out = conv3x3(xt, wt, impl=impl)
    np.testing.assert_array_equal(out.detach().numpy(),
                                  F.conv2d(xt, wt, padding=1).detach().numpy())
    assert out.grad_fn is not None
    before = conv3x3_wgrad.launches
    ((out - torch.from_numpy(t).permute(0, 3, 1, 2)) ** 2).sum().backward()
    assert conv3x3_wgrad.launches == before  # a CPU tensor never launches
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(),
                               np.asarray(gx_j), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(wt.grad.permute(2, 3, 1, 0).numpy(),
                               np.asarray(gk_j), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("channels_last", [False, True])
def test_conv3x3_bias_and_layouts_match_autograd(channels_last):
    """The op with a bias, on either memory format, against autograd of
    F.conv2d; an NCHW-contiguous input and gradient are copied to NHWC
    rows for the weight gradient, and the copies counted."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((2, 5, 6, 7), generator=gen)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    w = torch.randn((4, 5, 3, 3), generator=gen)
    bias = torch.randn((4,), generator=gen)
    up = torch.randn((2, 4, 6, 7), generator=gen)
    if channels_last:
        up = up.contiguous(memory_format=torch.channels_last)
    grads = []
    copies = conv3x3.input_copies, conv3x3.grad_copies
    for fn in (lambda *a: conv3x3(*a, impl="kernel"),
               lambda *a: F.conv2d(*a, padding=1)):
        ts = [t.clone().requires_grad_() for t in (x, w, bias)]
        (fn(*ts) * up).sum().backward()
        grads.append([t.grad for t in ts])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    step = 0 if channels_last else 1
    assert (conv3x3.input_copies, conv3x3.grad_copies) == (
        copies[0] + step, copies[1] + step)


def test_conv3x3_refuses_what_it_does_not_take():
    x = torch.zeros((1, 2, 4, 4))
    with pytest.raises(ValueError, match="impl"):
        conv3x3(x, torch.zeros((2, 2, 3, 3)), impl="pallas")
    with pytest.raises(ValueError, match="weight"):
        conv3x3(x, torch.zeros((2, 2, 1, 1)))
    with pytest.raises(ValueError, match="share B, H, W"):
        conv3x3_wgrad(torch.zeros((1, 4, 4, 2)), torch.zeros((1, 4, 5, 2)))
