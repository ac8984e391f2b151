"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda``; those that need a card skip without
one (the kernels have no CPU mode).  The file imports neither JAX nor
the JAX package, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Shapes include ragged ones (channels per group 3 and 5, odd spatial
sizes, token counts that are not a multiple of the 32-token tiles,
channels that are not a multiple of 16) and the paper UNet's widths.
The GroupNorm tests include the paper UNet's largest slices at R = 98
rows, where K2's plan takes a 16-block cluster (bf16) or stages part of
each block's rows (f32).  The backward tests cover kernel K2 and the
autograd Functions on the card, and a tiny UNet's gradients on the card
against the CPU; the conv weight-gradient tests cover kernel K4 (ragged
channels, 5 x 7 images, bf16 and f32) and the ``conv3x3`` op.  The
experiment loop runs ``cli.main -t`` on the card at TINY size and reads
its run dir back on the CPU; the native shard reader is held against
the PNG codec (no card needed).  K3 runs at the DiT's sites (the serving
and training rows of dit-small-tpu-4, three q/k/v layouts), and a tiny
DiT's train steps on the card are held against the CPU, and a host
batch overwritten as soon as ``train_step`` returns trains as an
untouched copy does (the pinned staging buffers' lifetime).  K5, the fused
attention backward for heads of 64, runs at every DiT (R = 98) and ADM
(R = 112) site shape, with an upstream gradient of bf16 values and a
general f32 one, at ragged S, through autograd, and refuses what it does
not take.
"""

import json

import numpy as np
import pytest
import torch

from viewfusion_tpu_torch.config import UNetConfig
from viewfusion_tpu_torch.models.unet import UNet
from viewfusion_tpu_torch.ops.attention import (
    attention_backward, attention_plan, spatial_self_attention,
    spatial_self_attention_backward, spatial_self_attention_reference)
from viewfusion_tpu_torch.ops.conv_wgrad import (conv3x3, conv3x3_wgrad,
                                                 conv3x3_wgrad_reference,
                                                 wgrad_plan)
from viewfusion_tpu_torch.ops.groupnorm import (
    group_norm_act, group_norm_act_backward,
    group_norm_act_backward_reference, group_norm_act_reference)

pytestmark = pytest.mark.cuda

# (B, H, W, C, G)
GN_SHAPES = [
    (2, 8, 8, 64, 32),
    (3, 5, 7, 24, 8),
    (2, 4, 4, 40, 8),
    (5, 64, 64, 192, 32),
    (48, 8, 8, 640, 32),
    (2, 3, 3, 6, 2),
]
# (B, S, C): bf16 with C a multiple of 8 up to 320 takes the tensor-core
# (wgmma) path; C = 20 and C = 400 (and every f32 case) the CUDA-core
# path.  The UNet's two sites at the ancestral (28), serving (48) and
# training (98) rows, key counts that are not a multiple of the 64-key
# tile (70, 33, 5), and one row
ATTN_SHAPES = [(2, 64, 40), (3, 70, 192), (48, 256, 192), (48, 64, 320),
               (1, 5, 8), (2, 33, 20), (2, 40, 400), (2, 33, 64),
               (28, 256, 192), (98, 256, 192), (28, 64, 320),
               (98, 64, 320), (1, 256, 192)]


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _bf16_ulp(scale: float) -> float:
    return 2.0 ** (np.floor(np.log2(scale)) - 7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["none", "silu"])
@pytest.mark.parametrize("shape", GN_SHAPES)
def test_group_norm_kernel_matches_plain(device, shape, act, dtype):
    """y within 1e-5 (f32) or one bf16 ulp of the output scale; the
    saved statistics within rtol 1e-4 (f32 sums in another order)."""
    b, h, w, c, g = shape
    gen = torch.Generator(device=device).manual_seed(0)
    x = (torch.randn((b, h, w, c), generator=gen, device=device) * 1.5
         + 0.5).to(dtype)
    scale = torch.randn((c,), generator=gen, device=device) * 0.5 + 1.0
    bias = torch.randn((c,), generator=gen, device=device) * 0.5
    before = group_norm_act.launches
    y, mean, rstd = group_norm_act(x, scale, bias, groups=g, act=act,
                                   return_stats=True)
    torch.cuda.synchronize()
    assert group_norm_act.launches == before + 1
    y_r, mean_r, rstd_r = group_norm_act_reference(x, scale, bias, groups=g,
                                                   act=act)
    tol = 1e-5 if dtype == torch.float32 else _bf16_ulp(
        y_r.float().abs().max().item())
    assert y.dtype == dtype and y.shape == x.shape
    assert (y.float() - y_r.float()).abs().max().item() <= tol
    torch.testing.assert_close(mean, mean_r, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(rstd, rstd_r, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 3, 3, 6, 2), (3, 5, 7, 24, 8),
                                   (48, 8, 8, 640, 32),
                                   (5, 64, 64, 192, 32)])
def test_group_norm_kernel_is_repeatable(device, shape, dtype):
    """Two K1 calls give equal bits in y, mean and rstd: every block of
    a cluster folds the partials in rank order, no atomics."""
    b, h, w, c, g = shape
    gen = torch.Generator(device=device).manual_seed(2)
    x = (torch.randn((b, h * w, c), generator=gen, device=device) * 1.5
         + 0.5).to(dtype)
    scale = torch.randn((c,), generator=gen, device=device) * 0.5 + 1.0
    bias = torch.randn((c,), generator=gen, device=device) * 0.5
    outs = [group_norm_act(x, scale, bias, groups=g, act="silu",
                           return_stats=True) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b_ in zip(*outs):
        assert torch.equal(a, b_)


def test_group_norm_kernel_rejects_what_it_does_not_take(device):
    x = torch.zeros((2, 4, 8), device=device)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        group_norm_act(x.half(), torch.ones(8, device=device),
                       torch.zeros(8, device=device), groups=4)
    with pytest.raises(ValueError, match="contiguous"):
        group_norm_act(x.transpose(1, 2), torch.ones(4, device=device),
                       torch.zeros(4, device=device), groups=4)
    with pytest.raises(ValueError, match="scale"):
        group_norm_act(x, torch.ones(8), torch.zeros(8, device=device),
                       groups=4)


@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", ATTN_SHAPES)
def test_attention_kernel_matches_plain(device, shape, dtype, strided):
    """f32 math on both sides: within 1e-4 (sums over the keys in
    another order)."""
    b, s, c = shape
    gen = torch.Generator(device=device).manual_seed(1)
    qkv = torch.randn((b, s, 3 * c), generator=gen, device=device).to(dtype)
    q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
    if not strided:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    scale = 1.0 / np.sqrt(c)
    before = spatial_self_attention.launches
    out = spatial_self_attention(q, k, v, scale)
    torch.cuda.synchronize()
    assert spatial_self_attention.launches == before + 1
    ref = spatial_self_attention_reference(q, k, v, scale)
    assert out.dtype == torch.float32 and out.shape == (b, s, c)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("layout", ["contiguous", "columns", "planes"])
@pytest.mark.parametrize("shape", [(288, 256, 64), (588, 256, 64)])
def test_attention_kernel_at_the_dit_sites(device, shape, layout):
    """dit-small-tpu-4's sites, bf16: (48 x 6 heads, 256 tokens, 64) when
    serving and (98 x 6, 256, 64) when training, with q, k and v as
    separate tensors, column slices of one (B, S, 3C) buffer, or the
    planes of one (3, B, S, C) copy (what MHAttention hands over);
    within 1e-4 of the plain version."""
    b, s, c = shape
    gen = torch.Generator(device=device).manual_seed(2)
    if layout == "planes":
        q, k, v = torch.randn((3, b, s, c), generator=gen,
                              device=device).bfloat16()
    else:
        qkv = torch.randn((b, s, 3 * c), generator=gen,
                          device=device).bfloat16()
        q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
        if layout == "contiguous":
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    before = spatial_self_attention.launches
    out = spatial_self_attention(q, k, v, 0.125)
    torch.cuda.synchronize()
    assert spatial_self_attention.launches == before + 1
    ref = spatial_self_attention_reference(q, k, v, 0.125)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-4)


def test_attention_kernel_rejects_mismatched_inputs(device):
    q = torch.zeros((2, 16, 8), device=device)
    with pytest.raises(ValueError, match="match q"):
        spatial_self_attention(q, q.bfloat16(), q, 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros((2, 8, 16), device=device).transpose(1, 2)
        spatial_self_attention(t, t, t, 1.0)


# K5's sites (B x heads, S) at heads of 64: the DiT's at R = 98 (6 heads),
# the ADM's at R = 112 (6, 9 and 12 heads at S = 1024, 256 and 64)
K5_SITES = [(98 * 6, 256), (112 * 6, 1024), (112 * 9, 256), (112 * 12, 64)]


def _k5_inputs(device, b, s, seed, g_kind):
    """q, k, v as the planes of one (3, B, S, 64) bf16 copy (what
    MHAttention hands over) and an upstream gradient: bf16 values held in
    f32 (the gradient of the models' cast after the attention) or a
    general f32 one, whose low bits make K5 run its split-term products."""
    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v = torch.randn((3, b, s, 64), generator=gen,
                          device=device).bfloat16()
    g = torch.randn((b, s, 64), generator=gen, device=device) * 0.01
    if g_kind == "bf16-values":
        g = g.bfloat16().float()
    return q, k, v, g


def _check_k5(q, k, v, g, scale, f64_rows=32):
    """K5 against the closed form (f32 products, TF32 off) and both
    against an f64 closed form on the first ``f64_rows`` rows: K5's error
    no larger than twice the closed form's plus one bf16 ulp of the
    output's scale; K5 within two bf16 ulps of the closed form; two K5
    calls equal bit for bit."""
    before = attention_backward.launches
    got = attention_backward(q, k, v, g, scale)
    again = attention_backward(q, k, v, g, scale)
    torch.cuda.synchronize()
    assert attention_backward.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    closed = spatial_self_attention_backward(q, k, v, g, scale)
    n = f64_rows
    exact = spatial_self_attention_backward(
        q[:n].double(), k[:n].double(), v[:n].double(), g[:n].double(),
        scale)
    for name, a, c, e in zip(("dq", "dk", "dv"), got, closed, exact):
        assert a.dtype == torch.bfloat16 and a.shape == q.shape, name
        top = e.abs().max().item()
        err = (a[:n].double() - e).abs().max().item()
        err_closed = (c[:n].double() - e).abs().max().item()
        assert err <= 2 * err_closed + _bf16_ulp(top), (name, err,
                                                        err_closed)
        top = c.float().abs().max().item()
        assert (a.float() - c.float()).abs().max().item() <= \
            2 * _bf16_ulp(top), name


@pytest.mark.parametrize("g_kind", ["bf16-values", "f32"])
@pytest.mark.parametrize("site", K5_SITES)
def test_attention_backward_kernel_at_the_dit_and_adm_sites(device, site,
                                                           g_kind):
    b, s = site
    _check_k5(*_k5_inputs(device, b, s, b + s, g_kind), 0.125)


@pytest.mark.parametrize("g_kind", ["bf16-values", "f32"])
@pytest.mark.parametrize("shape", [(2, 100, 64), (3, 5, 64), (1, 1, 64),
                                   (2, 65, 64), (4, 127, 64), (2, 1000, 64)])
def test_attention_backward_kernel_at_ragged_s(device, shape, g_kind):
    """S that 64 does not divide: the last tile's rows and keys past S
    are left out of every sum."""
    b, s, _ = shape
    _check_k5(*_k5_inputs(device, b, s, 7 * s, g_kind), 0.125)


def test_attention_backward_kernel_takes_strided_rows(device):
    """q, k, v as column slices of one (B, S, 3 x 64) buffer (row stride
    192): K5 reads the same rows as from contiguous copies."""
    gen = torch.Generator(device=device).manual_seed(5)
    qkv = torch.randn((6, 200, 192), generator=gen, device=device).bfloat16()
    g = torch.randn((6, 200, 64), generator=gen, device=device)
    q, k, v = qkv[..., :64], qkv[..., 64:128], qkv[..., 128:]
    got = attention_backward(q, k, v, g, 0.125)
    want = attention_backward(q.contiguous(), k.contiguous(),
                              v.contiguous(), g, 0.125)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    _check_k5(q, k, v, g, 0.125)


def test_attention_backward_through_autograd_on_the_card(device):
    """A bf16 call with heads of 64 under autograd takes K5 (one launch,
    no closed-form call) and gives the closed form's gradients within two
    bf16 ulps; one with C = 192 (the UNet's) takes the closed form."""
    from viewfusion_tpu_torch.ops.attention import _Attention

    for c, k5, closed in ((64, 1, 0), (192, 0, 1)):
        gen = torch.Generator(device=device).manual_seed(c)
        qkv = torch.randn((3, 12, 256, c), generator=gen,
                          device=device).bfloat16()
        g = torch.randn((12, 256, c), generator=gen,
                        device=device).bfloat16()
        ts = [t.clone().requires_grad_() for t in qkv]
        before = (attention_backward.launches, _Attention.closed_form_calls)
        spatial_self_attention(*ts, c ** -0.5).bfloat16().backward(g)
        torch.cuda.synchronize()
        assert (attention_backward.launches - before[0],
                _Attention.closed_form_calls - before[1]) == (k5, closed)
        want = spatial_self_attention_backward(*qkv, g.float(), c ** -0.5)
        for t, w in zip(ts, want):
            top = w.float().abs().max().item()
            assert (t.grad.float() - w.float()).abs().max().item() <= \
                2 * _bf16_ulp(top)


def test_attention_backward_kernel_rejects_mismatched_inputs(device):
    q = torch.zeros((2, 16, 64), device=device, dtype=torch.bfloat16)
    g = torch.zeros((2, 16, 64), device=device)
    with pytest.raises(ValueError, match="match q"):
        attention_backward(q, q.float(), q, g, 1.0)
    with pytest.raises(ValueError, match="match q"):
        attention_backward(q, q, q.cpu(), g, 1.0)
    with pytest.raises(ValueError, match="g must be"):
        attention_backward(q, q, q, g[:, 1:], 1.0)
    with pytest.raises(ValueError, match="bfloat16"):
        attention_backward(q.float(), q.float(), q.float(), g, 1.0)
    with pytest.raises(ValueError, match="heads of 64"):
        t = torch.zeros((2, 16, 128), device=device, dtype=torch.bfloat16)
        attention_backward(t, t, t, torch.zeros_like(t, dtype=torch.float32),
                           1.0)
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros((2, 64, 16), device=device,
                        dtype=torch.bfloat16).transpose(1, 2)
        attention_backward(t, t, t, g, 1.0)
    with pytest.raises(ValueError, match="multiples of 8"):
        t = torch.zeros((2, 16, 196), device=device,
                        dtype=torch.bfloat16)[..., :64]
        attention_backward(t, t, t, g, 1.0)


# (B, H, W, C, G): the forward's shapes plus paper sites at R = 98, among
# them the two largest slices (4096 x 192 and 4096 x 128)
GN_BWD_SHAPES = GN_SHAPES + [(98, 64, 64, 64, 32), (98, 8, 8, 640, 32),
                             (98, 64, 64, 192, 32), (98, 64, 64, 128, 32)]


def _gn_bwd_inputs(device, shape, act, dtype, seed=3):
    b, h, w, c, g = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    x = (torch.randn((b, h * w, c), generator=gen, device=device) * 1.5
         + 0.5).to(dtype)
    gy = torch.randn((b, h * w, c), generator=gen, device=device).to(dtype)
    scale = torch.randn((c,), generator=gen, device=device) * 0.5 + 1.0
    bias = torch.randn((c,), generator=gen, device=device) * 0.5
    _, mean, rstd = group_norm_act(x, scale, bias, groups=g, act=act,
                                   return_stats=True)
    return x, gy, scale, bias, mean, rstd


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["none", "silu"])
@pytest.mark.parametrize("shape", GN_BWD_SHAPES)
def test_group_norm_backward_kernel_matches_plain(device, shape, act, dtype):
    """K2 against its plain version from the same statistics: dx within
    1e-5 of its scale (f32) or one bf16 ulp of its scale (both round one
    f32 value once; the sums run in another order); the per-sample
    partials within 1e-4 of their scale (f32 sums of L terms in another
    order).  Two calls give equal bits (no atomics)."""
    args = _gn_bwd_inputs(device, shape, act, dtype)
    kw = dict(groups=shape[-1], act=act)
    before = group_norm_act_backward.launches
    out = group_norm_act_backward(*args, **kw)
    again = group_norm_act_backward(*args, **kw)
    torch.cuda.synchronize()
    assert group_norm_act_backward.launches == before + 2
    ref = group_norm_act_backward_reference(*args, **kw)
    dx, dx_r = out[0].float(), ref[0].float()
    assert out[0].dtype == dtype and out[0].shape == args[0].shape
    scale_dx = dx_r.abs().max().item()
    tol = 1e-5 * scale_dx if dtype == torch.float32 else _bf16_ulp(scale_dx)
    assert (dx - dx_r).abs().max().item() <= tol
    for got, want in zip(out[1:], ref[1:]):
        assert got.shape == (shape[0], shape[3])
        assert got.dtype == torch.float32
        assert (got - want).abs().max().item() <= \
            1e-4 * want.abs().max().item()
    for a, b in zip(out, again):
        assert torch.equal(a, b)


def test_group_norm_backward_kernel_rejects_what_it_does_not_take(device):
    x, gy, scale, bias, mean, rstd = _gn_bwd_inputs(
        device, (2, 4, 4, 8, 4), "none", torch.float32)
    kw = dict(groups=4)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        group_norm_act_backward(x.half(), gy.half(), scale, bias, mean,
                                rstd, **kw)
    with pytest.raises(ValueError, match="match x"):
        group_norm_act_backward(x, gy.bfloat16(), scale, bias, mean, rstd,
                                **kw)
    with pytest.raises(ValueError, match="contiguous"):
        t = x.transpose(1, 2).contiguous().transpose(1, 2)
        group_norm_act_backward(t, gy, scale, bias, mean, rstd, **kw)
    with pytest.raises(ValueError, match="mean"):
        group_norm_act_backward(x, gy, scale, bias, mean[:1], rstd, **kw)
    with pytest.raises(ValueError, match="scale"):
        group_norm_act_backward(x, gy, scale.cpu(), bias, mean, rstd, **kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_ops_stay_on_the_graph(device, dtype):
    """Outputs of K1 and K3 carry a grad_fn when an input requires grad;
    the gradients through the Functions match autograd through the plain
    versions, and an upstream gradient in another layout is copied to
    contiguous rows (counted) before K2."""
    x, gy, scale, bias, _, _ = _gn_bwd_inputs(
        device, (3, 6, 6, 40, 8), "silu", dtype)
    xs = [x.clone().requires_grad_(), x.clone().requires_grad_()]
    ps = [(scale.clone().requires_grad_(), bias.clone().requires_grad_())
          for _ in range(2)]
    w = torch.randn(x.shape[::-1][:2], device=device)  # (C, L)
    k2, copies = (group_norm_act_backward.launches,
                  group_norm_act_backward.grad_copies)
    y = group_norm_act(xs[0], *ps[0], groups=8, act="silu")
    assert y.grad_fn is not None
    y_r = group_norm_act_reference(xs[1], *ps[1], groups=8, act="silu")[0]
    for out, xx, (s, b) in ((y, xs[0], ps[0]), (y_r, xs[1], ps[1])):
        # the transpose hands the Function a non-contiguous gradient
        (out.float().transpose(1, 2) * w).sum().backward()
    torch.cuda.synchronize()
    assert group_norm_act_backward.launches == k2 + 1
    assert group_norm_act_backward.grad_copies == copies + 1
    for got, want in ((xs[0].grad, xs[1].grad), (ps[0][0].grad, ps[1][0].grad),
                      (ps[0][1].grad, ps[1][1].grad)):
        scale_g = want.float().abs().max().item()
        tol = 1e-4 * scale_g if dtype == torch.float32 else \
            2 * _bf16_ulp(scale_g)
        assert (got.float() - want.float()).abs().max().item() <= tol

    qkv = torch.randn((2, 64, 3 * 40), device=device).to(dtype)
    t = qkv.clone().requires_grad_()
    out = spatial_self_attention(t[..., :40], t[..., 40:80], t[..., 80:],
                                 0.15)
    assert out.grad_fn is not None
    g = torch.randn_like(out)
    out.backward(g)
    t_r = qkv.clone().requires_grad_()
    spatial_self_attention_reference(t_r[..., :40], t_r[..., 40:80],
                                     t_r[..., 80:], 0.15).backward(g)
    scale_g = t_r.grad.float().abs().max().item()
    tol = 1e-4 * scale_g if dtype == torch.float32 else \
        2 * _bf16_ulp(scale_g)
    assert (t.grad.float() - t_r.grad.float()).abs().max().item() <= tol


def test_unet_backward_on_the_card_matches_the_cpu(device):
    """A tiny f32 UNet: every parameter gradient on the card (K1, K2, K3)
    within 1e-4 of the largest gradient of the same step on the CPU
    (plain versions); TF32 is off."""
    cfg = UNetConfig(image_size=8, in_channel=6, out_channel=6,
                     inner_channel=8, norm_groups=4, res_blocks=1,
                     attn_res=(4,), channel_mults=(1, 2))
    torch.manual_seed(0)
    state = UNet(cfg).state_dict()
    rng = np.random.default_rng(0)
    inputs = [torch.from_numpy(a) for a in (
        rng.normal(size=(3, 8, 8, 6)).astype(np.float32),
        rng.uniform(0, 6, 3).astype(np.float32),
        rng.uniform(0, 1, 3).astype(np.float32))]
    w = torch.from_numpy(rng.normal(size=(3, 8, 8, 6)).astype(np.float32))
    grads = []
    for dev in ("cpu", device):
        unet = UNet(cfg)
        unet.load_state_dict(state)
        unet.to(dev)
        (unet(*(a.to(dev) for a in inputs)) * w.to(dev)).sum().backward()
        grads.append({k: p.grad.cpu() for k, p in unet.named_parameters()})
    gmax = max(g.abs().max().item() for g in grads[0].values())
    for k, g in grads[0].items():
        assert (grads[1][k] - g).abs().max().item() <= 1e-4 * gmax, k


def test_dit_train_step_on_the_card_matches_the_cpu(device):
    """A tiny f32 DiT (perturbed: a fresh one is the zero map), two packed
    Trainer steps: losses, parameters and every gradient on the card
    (K3 per head) within 1e-4 of the same steps on the CPU."""
    import copy

    from viewfusion_tpu_torch.config import Config
    from viewfusion_tpu_torch.models.view_fusion import ViewFusion
    from viewfusion_tpu_torch.training.trainer import (Trainer,
                                                       global_packed_counts)

    raw = copy.deepcopy(TINY_RAW)
    raw["model"]["denoise_net"] = "dit"
    raw["model"]["denoise_net_params"] = {
        "image_size": 8, "in_channel": 6, "out_channel": 6,
        "patch_size": 2, "hidden_size": 32, "depth": 2, "num_heads": 2}
    raw["tpu"].update(packed_views=True, lr_warmup=1, peak_lr=1e-5)
    cfg = Config.from_dict(raw)
    torch.manual_seed(0)
    gen = torch.Generator().manual_seed(1)
    state = {k: v + 0.1 * torch.randn(v.shape, generator=gen) for k, v in
             ViewFusion.from_config(cfg).unet.state_dict().items()}
    rng = np.random.default_rng(2)
    batches = []
    for it in range(2):
        counts, si, vi = global_packed_counts(0, it, 4, 3)
        batches.append((dict(
            target=rng.integers(0, 256, (4, 8, 8, 3), np.uint8),
            cond=rng.integers(0, 256, (4, 3, 8, 8, 3), np.uint8),
            angle=rng.uniform(0, 6, 4).astype(np.float32),
            view_count=counts.astype(np.int32), sample_idx=si,
            view_idx=vi), rng.normal(size=(4, 8, 8, 3)).astype(np.float32),
            rng.uniform(0.05, 0.95, 4).astype(np.float32)))
    runs = []
    for dev in ("cpu", device):
        tr = Trainer(cfg, device=dev, state_dict=state)
        losses = [tr.train_step(b, noise=n, sample_gammas=g).item()
                  for b, n, g in batches]
        runs.append((losses, [p.detach().cpu() for p in tr.params],
                     [p.grad.cpu() for p in tr.params]))
    (l_c, p_c, g_c), (l_d, p_d, g_d) = runs
    assert max(abs(a - b) / abs(a) for a, b in zip(l_c, l_d)) <= 1e-4
    gmax = max(g.abs().max().item() for g in g_c)
    for a, b in zip(p_c, p_d):
        assert (a - b).abs().max().item() <= 1e-4
    for a, b in zip(g_c, g_d):
        assert (a - b).abs().max().item() <= 1e-4 * gmax


@pytest.mark.parametrize("kind", ["numpy", "cpu_tensor"])
def test_host_batch_may_be_overwritten_once_train_step_returns(device,
                                                               kind):
    """``train_step`` copies a host batch (numpy arrays, or CPU tensors
    over them) through pinned staging buffers with non-blocking copies:
    the caller may overwrite its arrays as soon as the step returns,
    while the copy still waits behind a busy stream.  Two tiny f32 UNet
    trainers on the card take the same two steps, one from batches
    overwritten right after each call, one from untouched copies: losses
    and parameters are equal (cuDNN deterministic)."""
    import copy

    from viewfusion_tpu_torch.config import Config
    from viewfusion_tpu_torch.training.trainer import (Trainer,
                                                       global_packed_counts)

    raw = copy.deepcopy(TINY_RAW)
    raw["tpu"].update(lr_warmup=0, peak_lr=1e-3)
    cfg = Config.from_dict(raw)
    rng = np.random.default_rng(5)
    batches = []
    for it in range(2):
        counts, si, vi = global_packed_counts(0, it, 4, 3)
        batches.append((dict(
            target=rng.integers(0, 256, (4, 8, 8, 3), np.uint8),
            cond=rng.integers(0, 256, (4, 3, 8, 8, 3), np.uint8),
            angle=rng.uniform(0, 6, 4).astype(np.float32),
            view_count=counts.astype(np.int32), sample_idx=si,
            view_idx=vi), rng.normal(size=(4, 8, 8, 3)).astype(np.float32),
            rng.uniform(0.05, 0.95, 4).astype(np.float32)))
    kept = copy.deepcopy(batches)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = []
        for overwrite in (True, False):
            tr = Trainer(cfg, device=device, seed=0)
            losses = []
            for b, n, g in (batches if overwrite else kept):
                torch.cuda._sleep(50_000_000)  # the copies queue behind it
                given = (b, n, g) if kind == "numpy" else (
                    {k: torch.from_numpy(v) for k, v in b.items()},
                    torch.from_numpy(n), torch.from_numpy(g))
                losses.append(tr.train_step(given[0], noise=given[1],
                                            sample_gammas=given[2]))
                if overwrite:
                    b["target"][...] = 255 - b["target"]
                    b["cond"][...] = 0
                    b["angle"][...] += 1.0
                    n[...] = -n
                    g[...] = 0.5
            runs.append(([x.item() for x in losses],
                         [p.detach().cpu() for p in tr.params]))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (l_o, p_o), (l_k, p_k) = runs
    assert l_o == l_k
    for a, b in zip(p_o, p_k):
        assert torch.equal(a, b)


# (B, H, W, Cin, Cout): ragged channels (6, 3, 5), odd images (5 x 7),
# widths over the 64-pixel chunk, several output tiles, heights that are
# not a multiple of the chunk rows (9 and 13), one image, and paper sites
# at R = 98 (the largest 64 px one, the two ragged ones, two 8 px ones)
WGRAD_SHAPES = [(2, 8, 8, 4, 8), (3, 5, 7, 6, 4), (2, 4, 4, 3, 5),
                (2, 16, 16, 6, 64), (2, 16, 16, 64, 6), (1, 9, 70, 40, 24),
                (4, 32, 32, 128, 96), (98, 64, 64, 192, 64),
                (98, 8, 8, 640, 320), (2, 13, 24, 64, 64),
                (1, 16, 16, 128, 64), (98, 8, 8, 320, 320),
                (98, 64, 64, 6, 64), (98, 64, 64, 64, 6)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", WGRAD_SHAPES)
def test_conv_wgrad_kernel_matches_plain(device, shape, dtype):
    """K4 against its plain version on the same inputs: both widen to f32
    and sum in f32 (bf16 products are exact), in another order: within
    1e-5 of the result's scale, times sqrt(B*H*W / 4096) above 4096
    summed pixels.
    Two calls give equal bits (no atomics), one launch each."""
    b, h, w, cin, cout = shape
    gen = torch.Generator(device=device).manual_seed(4)
    x = torch.randn((b, h, w, cin), generator=gen, device=device).to(dtype)
    g = torch.randn((b, h, w, cout), generator=gen, device=device).to(dtype)
    before = conv3x3_wgrad.launches
    out = conv3x3_wgrad(x, g)
    again = conv3x3_wgrad(x, g)
    torch.cuda.synchronize()
    assert conv3x3_wgrad.launches == before + 2
    ref = conv3x3_wgrad_reference(x, g)
    assert out.dtype == torch.float32 and out.shape == (3, 3, cin, cout)
    rel = 1e-5 * max(1.0, (b * h * w / 4096) ** 0.5)
    assert (out - ref).abs().max().item() <= rel * ref.abs().max().item()
    assert torch.equal(out, again)


def test_tensor_core_paths_at_main_path_shapes(device):
    """bf16 K3 at the 16 px site of a served forward (q, k, v strided
    slices of one qkv buffer) and bf16 K4 at the largest 64 px site of a
    training step: the plans pick the wgmma paths, each call launches
    once, and the results are within their tolerances (K3 1e-4; K4 1e-5
    of the scale times sqrt(R*H*W / 4096))."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    gen = torch.Generator(device=device).manual_seed(6)
    qkv = torch.randn((48, 256, 576), generator=gen,
                      device=device).bfloat16()
    q, k, v = qkv[..., :192], qkv[..., 192:384], qkv[..., 384:]
    assert attention_plan(48, 256, 192)["parts"] == 1
    before = spatial_self_attention.launches
    out = spatial_self_attention(q, k, v, 0.125)
    torch.cuda.synchronize()
    assert spatial_self_attention.launches == before + 1
    ref = spatial_self_attention_reference(q, k, v, 0.125)
    assert (out - ref).abs().max().item() <= 1e-4

    x = torch.randn((98, 64, 64, 64), generator=gen, device=device).bfloat16()
    g = torch.randn((98, 64, 64, 64), generator=gen, device=device).bfloat16()
    assert wgrad_plan(98, 64, 64, 64, 64, torch.bfloat16,
                      sms)["path"] == "wgmma"
    before = conv3x3_wgrad.launches
    dw = conv3x3_wgrad(x, g)
    torch.cuda.synchronize()
    assert conv3x3_wgrad.launches == before + 1
    ref = conv3x3_wgrad_reference(x, g)
    tol = 1e-5 * (98 * 64 * 64 / 4096) ** 0.5 * ref.abs().max().item()
    assert (dw - ref).abs().max().item() <= tol


def test_conv3x3_op_on_the_card(device):
    """The op's output carries a grad_fn; one backward launches K4 once
    (a channels_last input and gradient need no copy), and its gradients
    match autograd of F.conv2d; a CPU tensor never launches."""
    gen = torch.Generator(device=device).manual_seed(5)
    x = torch.randn((3, 16, 10, 12), generator=gen, device=device)
    x = x.contiguous(memory_format=torch.channels_last)
    w = torch.randn((24, 16, 3, 3), generator=gen, device=device) * 0.1
    bias = torch.randn((24,), generator=gen, device=device)
    up = torch.randn((3, 24, 10, 12), generator=gen, device=device)
    up = up.contiguous(memory_format=torch.channels_last)
    grads = []
    for fn in (lambda *a: conv3x3(*a, impl="kernel"),
               lambda *a: torch.nn.functional.conv2d(*a, padding=1)):
        ts = [t.clone().requires_grad_() for t in (x, w, bias)]
        out = fn(*ts)
        assert out.grad_fn is not None
        before = conv3x3_wgrad.launches
        copies = conv3x3.input_copies, conv3x3.grad_copies
        (out * up).sum().backward()
        torch.cuda.synchronize()
        grads.append([t.grad for t in ts])
    assert conv3x3_wgrad.launches == before  # the F.conv2d run
    for got, want in zip(*grads):
        scale = want.abs().max().item()
        assert (got - want).abs().max().item() <= 1e-4 * scale
    ts = [t.clone().requires_grad_() for t in (x, w, bias)]
    before = conv3x3_wgrad.launches
    (conv3x3(*ts, impl="kernel") * up).sum().backward()
    torch.cuda.synchronize()
    assert conv3x3_wgrad.launches == before + 1
    assert (conv3x3.input_copies, conv3x3.grad_copies) == copies
    cpu = [t.detach().cpu().requires_grad_() for t in (x, w, bias)]
    (conv3x3(*cpu, impl="kernel") * up.cpu()).sum().backward()
    assert conv3x3_wgrad.launches == before + 1


def test_conv_wgrad_kernel_rejects_what_it_does_not_take(device):
    x = torch.zeros((2, 4, 4, 8), device=device)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        conv3x3_wgrad(x.half(), x.half())
    with pytest.raises(ValueError, match="match x"):
        conv3x3_wgrad(x, x.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        t = x.permute(0, 2, 1, 3)
        conv3x3_wgrad(t, t)


# the CLI at TINY_CONFIG's sizes (tests/conftest.py), kept here because
# this file imports no JAX
TINY_RAW = {
    "model": {
        "denoise_net": "unet", "max_it": 4, "validate_every": 4,
        "validate_from": 4, "checkpoint_every": 2, "log_every": 2,
        "view_fusion_params": {"beta_schedule": {
            phase: {"schedule": "linear", "num_timesteps": 8,
                    "linear_start": 1e-4, "linear_end": 0.09}
            for phase in ("train", "test")}},
        "denoise_net_params": {
            "image_size": 8, "in_channel": 6, "out_channel": 6,
            "inner_channel": 8, "norm_groups": 4, "res_blocks": 1,
            "attn_res": [4], "channel_mults": [1, 2]},
    },
    "data": {"params": {
        "num_workers": 1, "max_views": 3, "batch_size": 4,
        "train": {"params": {"start_shard": 0, "end_shard": 0,
                             "path": "data", "mode": "train"}},
        "test": {"params": {"start_shard": 0, "end_shard": 0,
                            "path": "data", "mode": "test", "size": 4}}}},
    "tpu": {"compute_dtype": "float32", "seed": 0, "sample_num": 4,
            "packed_views": True, "ema_decay": 0.9, "lr_warmup": 1},
}


def test_cli_on_the_card_and_its_run_dir_on_the_cpu(device, tmp_path,
                                                    monkeypatch):
    """``cli.main -t`` on the card (the default device) at TINY size; the
    run dir reads back on the CPU: the saved state equals the card's
    exactly, and ``-e --device cpu`` evaluates it."""
    from viewfusion_tpu_torch import cli
    from viewfusion_tpu_torch.config import dump_yaml
    from viewfusion_tpu_torch.data.synthetic import make_synthetic_shards
    from viewfusion_tpu_torch.training.checkpoint import Checkpoint
    from viewfusion_tpu_torch.training.trainer import Trainer
    from viewfusion_tpu_torch.utils.convert import load_trainer_state

    monkeypatch.chdir(tmp_path)
    for mode in ("train", "test"):
        make_synthetic_shards("data", mode, num_objects=8, image_size=8)
    with open("tiny.yaml", "w") as f:
        f.write(dump_yaml(TINY_RAW))
    exp = cli.main(["-c", "tiny.yaml", "-t"])
    assert exp.device.type == "cuda" and exp.it == 4
    run = exp.out_dir
    for name in ("model.msgpack", "best_model_all.msgpack", "output-4.png"):
        assert (tmp_path / run / name).exists(), name
    cpu = Trainer(exp.config, device="cpu")
    state, extra = Checkpoint(run).load(
        "model.msgpack", dict.fromkeys(["params", "opt_state", "step",
                                        "ema_params"]))
    load_trainer_state(cpu, state)
    assert extra["it"] == 4 and cpu.step == exp.trainer.step == 5
    for a, b in zip(cpu.params, exp.trainer.params):
        assert torch.equal(a, b.cpu())
    for a, b in zip(cpu.ema, exp.trainer.ema):
        assert torch.equal(a, b.cpu())
    for p, q in zip(cpu.params, exp.trainer.params):
        mine, theirs = cpu.optimizer.state[p], exp.trainer.optimizer.state[q]
        assert torch.equal(mine["exp_avg"], theirs["exp_avg"].cpu())
        assert torch.equal(mine["exp_avg_sq"], theirs["exp_avg_sq"].cpu())
    cli.main(["-s", run, "-e", "--device", "cpu"])
    with open(tmp_path / run / "metrics.jsonl") as f:
        last = json.loads(f.readlines()[-1])
    assert -1.0 <= last["ssim"] <= 1.0 and np.isfinite(last["psnr"])


def test_native_reader_agrees_with_the_codec(tmp_path):
    """The native loader (``native/vfloader.cpp``, built with g++ at first
    use) and the port's PNG codec decode the same shard to equal views."""
    from viewfusion_tpu_torch.data import native_loader
    from viewfusion_tpu_torch.data.nmr import decode_views_u8
    from viewfusion_tpu_torch.data.synthetic import make_synthetic_shards
    from viewfusion_tpu_torch.data.tario import iter_tar_samples

    if not native_loader.native_available():
        pytest.skip(f"the native loader did not build: "
                    f"{native_loader.build_error()}")
    shard, = make_synthetic_shards(str(tmp_path), "train", num_objects=6,
                                   image_size=16, family="shaded")
    reader = native_loader.NativeShardReader([shard], n_threads=3,
                                             resample=False)
    native = {key: views for views, key in reader}
    reader.close()
    codec = {s["__key__"]: decode_views_u8(s)
             for s in iter_tar_samples(shard)}
    assert native.keys() == codec.keys() and len(codec) == 6
    for key, views in codec.items():
        assert np.array_equal(native[key], views), key


# ---------------------------------------------------------------------
# the denoiser's forward replayed as a CUDA graph (models/graphed.py)

def _paper_model(device, net="unet"):
    """ViewFusion at configs/small-tpu-4.yaml's (or dit-small-tpu-4's)
    widths on the card, weights seeded and cast as the server casts them
    (a DiT's zero-init layers perturbed: a fresh one is the zero map)."""
    from pathlib import Path

    from viewfusion_tpu_torch.config import load_config
    from viewfusion_tpu_torch.models.unet import cast_matmul_weights_
    from viewfusion_tpu_torch.models.view_fusion import ViewFusion

    name = "small-tpu-4.yaml" if net == "unet" else "dit-small-tpu-4.yaml"
    cfg = load_config(str(Path(__file__).resolve().parents[1] / "configs"
                          / name))
    torch.manual_seed(0)
    model = ViewFusion.from_config(cfg)
    if net == "dit":
        gen = torch.Generator().manual_seed(1)
        model.unet.load_state_dict({
            k: v + 0.02 * torch.randn(v.shape, generator=gen)
            for k, v in model.unet.state_dict().items()})
    model.unet.to(device).eval()
    cast_matmul_weights_(model.unet, model.unet.dtype)
    return model, cfg


def _views(device, b, n, hw, seed=3):
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.rand((b, n, hw, hw, 3), generator=g, device=device) * 2
            - 1).to(torch.bfloat16), \
        torch.randn((b, hw, hw, 3), generator=g, device=device), \
        torch.rand((b,), generator=g, device=device), \
        torch.rand((b,), generator=g, device=device) * 6.28


def _eager(model, y_cond, y_t, level, angle, packed_idx=None):
    """The same call with the graph runner out of the way."""
    runner = model.graphs
    model.graphs = lambda m, x, a, lvl, **kw: (m(x, a, lvl), False)
    try:
        return model._denoise_views(y_cond, y_t, level, angle, packed_idx)
    finally:
        model.graphs = runner


def _calls(model, args, n, packed_idx=None):
    """``n`` calls through the runner: (outputs, graphed flags)."""
    from viewfusion_tpu_torch import tracing

    mark = tracing.mark()
    outs = [model._denoise_views(*args, packed_idx) for _ in range(n)]
    flags = [s.attrs["graphed"]
             for s in tracing.spans("unet.forward", after=mark)]
    return outs, flags


@pytest.mark.parametrize("case", ["unet_48_dense", "unet_28_packed",
                                  "dit_48_dense"])
def test_graphed_forward_equals_the_eager_one(device, case):
    """First call eager, second the side-stream warm-up and capture,
    third and fourth replays: each equal to the eager forward bit for
    bit, at the served 8 x 6 rows and the ancestral chain's 28 packed
    rows; one capture, two replays."""
    from viewfusion_tpu_torch import tracing
    from viewfusion_tpu_torch.training.trainer import packed_indices

    model, cfg = _paper_model(device, case.split("_")[0])
    hw = cfg.denoiser.image_size
    args = _views(device, 8, 6, hw)
    packed_idx = None
    if case == "unet_28_packed":
        counts = np.array([1, 2, 3, 4, 5, 6, 4, 3])
        packed_idx = tuple(torch.from_numpy(a).long().to(device)
                           for a in packed_indices(counts))
    before = tracing.counters()
    with torch.inference_mode():
        want = _eager(model, *args, packed_idx)
        outs, flags = _calls(model, args, 4, packed_idx)
    after = tracing.counters()
    assert flags == [False, False, True, True]
    for out in outs:
        assert torch.equal(out, want)
    assert outs[2].data_ptr() != outs[3].data_ptr()  # clones, not the buffer
    for name, rise in (("unet.graph_captures", 1), ("unet.graph_replays", 2)):
        assert after[name] - before.get(name, 0) == rise


def test_a_replay_reads_weights_loaded_in_place(device):
    from viewfusion_tpu_torch import tracing

    model, cfg = _paper_model(device)
    args = _views(device, 8, 6, cfg.denoiser.image_size)
    with torch.inference_mode():
        first, _ = _calls(model, args, 3)
    captures = tracing.counters()["unet.graph_captures"]
    gen = torch.Generator().manual_seed(7)
    model.unet.load_state_dict({
        k: (v.float().cpu() + 0.01 * torch.randn(v.shape, generator=gen))
        for k, v in model.unet.state_dict().items()})
    with torch.inference_mode():
        want = _eager(model, *args)
        outs, flags = _calls(model, args, 1)
    assert flags == [True]
    assert tracing.counters()["unet.graph_captures"] == captures
    assert torch.equal(outs[0], want) and not torch.equal(want, first[0])


def test_a_parameter_given_new_storage_is_captured_anew(device):
    from viewfusion_tpu_torch import tracing

    model, cfg = _paper_model(device)
    args = _views(device, 8, 6, cfg.denoiser.image_size)
    with torch.inference_mode():
        _calls(model, args, 3)
    captures = tracing.counters()["unet.graph_captures"]
    conv = model.unet.downs[0]
    conv.weight = torch.nn.Parameter(conv.weight.detach() * 1.5)
    with torch.inference_mode():
        want = _eager(model, *args)
        outs, flags = _calls(model, args, 3)
    assert flags == [False, False, True]
    assert tracing.counters()["unet.graph_captures"] == captures + 1
    for out in outs:
        assert torch.equal(out, want)


def test_graphed_ddim_chain_equals_the_eager_chain(device):
    """generate_ddim, 50 steps at 8 x 6 rows from a seeded generator:
    the graphed chain (48 replays) equals the eager one bit for bit."""
    from viewfusion_tpu_torch import tracing

    model, cfg = _paper_model(device)
    y_cond, _, _, angle = _views(device, 8, 6, cfg.denoiser.image_size)
    counts = torch.tensor([1, 2, 3, 4, 5, 6, 6, 6], device=device)

    def chain():
        g = torch.Generator(device=device).manual_seed(11)
        return model.generate_ddim(y_cond.float(), counts, angle,
                                   num_steps=50, generator=g)

    runner = model.graphs
    model.graphs = lambda m, x, a, lvl, **kw: (m(x, a, lvl), False)
    want = chain()
    model.graphs = runner
    before = tracing.counters().get("unet.graph_replays", 0)
    got = chain()
    assert tracing.counters()["unet.graph_replays"] - before == 48
    assert torch.equal(got, want)


def test_replays_count_each_kernel_launch(device):
    """K1 and K3's counters rise by the paper UNet's 69 and 8 launches for
    every forward, replayed or not, and not for the capture."""
    model, cfg = _paper_model(device)
    args = _views(device, 8, 6, cfg.denoiser.image_size)
    group_norm_act.launches = spatial_self_attention.launches = 0
    with torch.inference_mode():
        _, flags = _calls(model, args, 5)
    assert flags == [False, False, True, True, True]
    assert (group_norm_act.launches, spatial_self_attention.launches) == (
        69 * 5, 8 * 5)
