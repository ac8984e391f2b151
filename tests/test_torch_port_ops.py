"""The port's kernel ops (viewfusion_tpu_torch.ops) against the JAX ops.

Kernel K1 (GroupNorm+SiLU forward) and kernel K3 (spatial attention) run
their plain PyTorch versions here on the CPU; the same seeded numpy
inputs go through the JAX op on its flax/XLA path and through its Pallas
kernel in interpret mode.  tests/test_torch_port_cuda.py holds the CUDA
kernels themselves against these plain versions on a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viewfusion_tpu.ops.attention import \
    spatial_self_attention as jax_attention
from viewfusion_tpu.ops.groupnorm import _pallas_fwd
from viewfusion_tpu.ops.groupnorm import group_norm_act as jax_gn
from viewfusion_tpu_torch.ops.attention import (
    spatial_self_attention, spatial_self_attention_reference)
from viewfusion_tpu_torch.ops.groupnorm import (group_norm_act,
                                                group_norm_act_reference)

torch.set_num_threads(2)

# (B, H, W, C, G): channels per group 2, 3 and 5, odd spatial sizes
GN_SHAPES = [
    (2, 8, 8, 64, 32),
    (3, 5, 7, 24, 8),
    (2, 4, 4, 40, 8),
    (2, 8, 8, 96, 32),
]


def _bf16_ulp(scale: float) -> float:
    """One bf16 ulp at the output's largest magnitude (8-bit mantissa)."""
    return 2.0 ** (np.floor(np.log2(scale)) - 7)


def _gn_inputs(seed, shape, dtype):
    b, h, w, c, _ = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(0.5, 1.5, (b, h, w, c)).astype(np.float32)
    if dtype == "bfloat16":  # values exactly representable in both
        x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    scale = rng.normal(1.0, 0.5, c).astype(np.float32)
    bias = rng.normal(0.0, 0.5, c).astype(np.float32)
    return x, scale, bias


def _to_torch(a, dtype):
    return torch.from_numpy(np.array(a)).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["none", "silu"])
@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("shape", GN_SHAPES)
def test_group_norm_act_matches_jax(shape, use_pallas, act, dtype):
    """f32: <= 1e-5 abs.  bf16 output: <= 1 bf16 ulp of the output scale
    (both sides round the same f32 value, up to reduction order; the flax
    path also applies SiLU in bf16)."""
    x, scale, bias = _gn_inputs(0, shape, dtype)
    g = shape[-1]
    want = np.asarray(jax_gn(
        jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(scale),
        jnp.asarray(bias), groups=g, eps=1e-5, act=act,
        use_pallas=use_pallas).astype(jnp.float32))
    got = group_norm_act(_to_torch(x, dtype), torch.from_numpy(scale),
                         torch.from_numpy(bias), groups=g, eps=1e-5, act=act)
    assert got.dtype == getattr(torch, dtype) and got.shape == x.shape
    err = np.abs(got.float().numpy() - want).max()
    tol = 1e-5 if dtype == "float32" else _bf16_ulp(np.abs(want).max())
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("act", ["none", "silu"])
@pytest.mark.parametrize("shape", GN_SHAPES)
def test_group_norm_stats_match_pallas(shape, act):
    """mean/rstd (B, G) f32, the statistics K1 saves for the backward,
    against the Pallas forward's (B, 1, G) outputs (interpret mode)."""
    x, scale, bias = _gn_inputs(1, shape, "float32")
    b, h, w, c, g = shape
    _, mean_j, rstd_j = _pallas_fwd(
        jnp.asarray(x.reshape(b, h * w, c)), jnp.asarray(scale),
        jnp.asarray(bias), g, 1e-5, act, True)
    _, mean, rstd = group_norm_act(
        torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias),
        groups=g, act=act, return_stats=True)
    np.testing.assert_allclose(mean.numpy(), np.asarray(mean_j)[:, 0],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(rstd_j)[:, 0],
                               rtol=1e-5, atol=1e-6)


def test_group_norm_cpu_runs_plain_version_without_launch():
    x, scale, bias = _gn_inputs(2, GN_SHAPES[0], "float32")
    before = group_norm_act.launches
    y = group_norm_act(torch.from_numpy(x), torch.from_numpy(scale),
                       torch.from_numpy(bias), groups=32, act="silu")
    ref, _, _ = group_norm_act_reference(
        torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias),
        groups=32, act="silu")
    assert torch.equal(y, ref)
    assert group_norm_act.launches == before
    with pytest.raises(ValueError, match="divisible"):
        group_norm_act(torch.zeros(1, 4, 6), torch.ones(6), torch.zeros(6),
                       groups=4)
    with pytest.raises(ValueError, match="act"):
        group_norm_act(torch.zeros(1, 4, 8), torch.ones(8), torch.zeros(8),
                       groups=4, act="relu")


# (B, S, C): the mid-block token count, non-power-of-two channels
ATTN_SHAPES = [(2, 64, 40), (3, 16, 24), (2, 36, 48)]


def _attn_inputs(seed, shape, dtype, strided):
    b, s, c = shape
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(b, s, 3 * c)).astype(np.float32)
    if dtype == "bfloat16":
        qkv = np.asarray(jnp.asarray(qkv, jnp.bfloat16).astype(jnp.float32))
    t = _to_torch(qkv, dtype)
    if strided:  # column slices of one qkv buffer, row stride 3C
        parts = t[..., :c], t[..., c:2 * c], t[..., 2 * c:]
    else:
        parts = tuple(p.contiguous() for p in
                      (t[..., :c], t[..., c:2 * c], t[..., 2 * c:]))
    return qkv, parts


@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("shape", ATTN_SHAPES)
def test_attention_matches_jax(shape, use_pallas, dtype, strided):
    """f32 math on both sides (bf16 inputs are widened first): <= 1e-5."""
    b, s, c = shape
    qkv, (q, k, v) = _attn_inputs(0, shape, dtype, strided)
    jq, jk, jv = (jnp.asarray(qkv[..., i * c:(i + 1) * c],
                              getattr(jnp, dtype)) for i in range(3))
    scale = 1.0 / np.sqrt(c)
    want = np.asarray(jax_attention(jq, jk, jv, scale, use_pallas))
    got = spatial_self_attention(q, k, v, scale)
    assert got.dtype == torch.float32 and got.shape == (b, s, c)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_attention_cpu_runs_plain_version_without_launch():
    _, (q, k, v) = _attn_inputs(1, ATTN_SHAPES[0], "float32", True)
    before = spatial_self_attention.launches
    out = spatial_self_attention(q, k, v, 0.25)
    assert torch.equal(out, spatial_self_attention_reference(q, k, v, 0.25))
    assert spatial_self_attention.launches == before
    with pytest.raises(ValueError, match="B, S, C"):
        spatial_self_attention(q[0], k[0], v[0], 0.25)
