"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips without a CUDA device (the
kernels have no CPU mode).  The file imports neither JAX nor the JAX
package, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Shapes include ragged ones (channels per group 3 and 5, odd spatial
sizes, token counts that are not a multiple of the 32-token tiles,
channels that are not a multiple of 16) and the paper UNet's widths.
"""

import numpy as np
import pytest
import torch

from viewfusion_tpu_torch.ops.attention import (
    spatial_self_attention, spatial_self_attention_reference)
from viewfusion_tpu_torch.ops.groupnorm import (group_norm_act,
                                                group_norm_act_reference)

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
# path; C = 20 and C = 400 (and every f32 case) the CUDA-core path
ATTN_SHAPES = [(2, 64, 40), (3, 70, 192), (48, 256, 192), (48, 64, 320),
               (1, 5, 8), (2, 33, 20), (2, 40, 400)]


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


def test_attention_kernel_rejects_mismatched_inputs(device):
    q = torch.zeros((2, 16, 8), device=device)
    with pytest.raises(ValueError, match="match q"):
        spatial_self_attention(q, q.bfloat16(), q, 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros((2, 8, 16), device=device).transpose(1, 2)
        spatial_self_attention(t, t, t, 1.0)
