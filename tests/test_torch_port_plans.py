"""The host-side work plans of the port's tensor-core kernels, on the CPU.

``attention_plan`` (K3) and ``wgrad_plan`` (K4) decide the blocks the
kernels launch.  At every main-path site of the paper UNet (found by
hooks on the model, as ``chip_smoke.py`` finds them) and at the card
tests' edge shapes, the plans must cover each query and output channel,
or each pixel, exactly once, keep the shapes the kernels take, and fill
the card's 132 SMs as their notes say.  Plain arithmetic: no card.
"""

from collections import Counter

import numpy as np
import pytest
import torch

from viewfusion_tpu_torch.config import Config
from viewfusion_tpu_torch.models import unet as unet_module
from viewfusion_tpu_torch.models.unet import SelfAttention, UNet
from viewfusion_tpu_torch.ops.attention import attention_plan
from viewfusion_tpu_torch.ops.conv_wgrad import wgrad_plan

H100_SMS = 132
ROWS = (28, 48, 98)  # ancestral chain, serving batch, training batch
PAPER_UNET = {"image_size": 64, "in_channel": 6, "out_channel": 6,
              "inner_channel": 64, "res_blocks": 3, "attn_res": [16],
              "channel_mults": [1, 2, 3, 5]}


@pytest.fixture(scope="module")
def paper_sites():
    """(S, C) attention sites and (H, W, Cin, Cout) stride-1 3x3 conv
    sites of one paper-UNet forward, with their counts."""
    cfg = Config.from_dict({"model": {"denoise_net_params": PAPER_UNET}})
    torch.manual_seed(0)
    unet = UNet(cfg.unet).eval()
    attn, convs = Counter(), Counter()
    hooks = [m.register_forward_pre_hook(
        lambda m, a: attn.update([(a[0].shape[2] * a[0].shape[3],
                                   a[0].shape[1])]))
        for m in unet.modules() if isinstance(m, SelfAttention)]
    hooks += [m.register_forward_pre_hook(
        lambda m, a: convs.update([(a[0].shape[2], a[0].shape[3],
                                    a[0].shape[1], m.out_channels)]))
        for m in unet.modules()
        if isinstance(m, unet_module.Conv2d) and m.kernel_size == (3, 3)
        and m.stride == (1, 1)]
    with torch.inference_mode():
        unet(torch.zeros((1, 64, 64, 6)), torch.zeros(1), torch.zeros(1))
    for h in hooks:
        h.remove()
    return attn, convs


def _attention_coverage(b, s, c, plan):
    """How often each (row, query, channel) output is written by the
    blocks of ``plan``, with the kernel's own index arithmetic."""
    hits = np.zeros((b, s, c), dtype=np.int32)
    w = plan["part_width"]
    for qt in range(plan["q_tiles"]):
        for part in range(plan["parts"]):
            q0, n0 = 64 * qt, part * w
            hits[:, q0:min(s, q0 + 64), n0:min(c, n0 + w)] += 1
    return hits


def test_attention_plan_at_the_paper_sites(paper_sites):
    attn, _ = paper_sites
    assert attn == Counter({(256, 192): 7, (64, 320): 1})
    blocks = {}
    for rows in ROWS:
        for (s, c) in attn:
            plan = attention_plan(rows, s, c)
            assert (_attention_coverage(2, s, c, plan) == 1).all()
            assert plan["part_width"] % 8 == 0
            assert plan["part_width"] <= 192  # the O accumulator's width
            blocks[rows, s, c] = plan["blocks"]
    # the unit counts written in csrc/attention.cu's note
    assert blocks == {(48, 256, 192): 192, (98, 256, 192): 392,
                      (28, 256, 192): 112, (48, 64, 320): 96,
                      (98, 64, 320): 196, (28, 64, 320): 56}


@pytest.mark.parametrize("shape", [(2, 70, 192), (2, 33, 40), (1, 5, 8),
                                   (3, 64, 320), (1, 256, 192),
                                   (2, 129, 128), (4, 100, 256)])
def test_attention_plan_covers_edge_shapes(shape):
    plan = attention_plan(*shape)
    assert (_attention_coverage(*shape, plan) == 1).all()
    assert plan["part_width"] % 8 == 0 and plan["part_width"] <= 192


def _check_wgrad_plan(b, h, w, cin, cout, dtype):
    plan = wgrad_plan(b, h, w, cin, cout, dtype, H100_SMS)
    tr, tw, per = plan["tr"], plan["tw"], plan["per_split"]
    n_rt, n_ct = -(-h // tr), -(-w // tw)
    assert plan["n_chunks"] == b * n_rt * n_ct
    # each chunk in exactly one split, no split empty
    owner = [c // per for c in range(plan["n_chunks"])]
    assert sorted(set(owner)) == list(range(plan["splits"]))
    # each pixel in exactly one chunk (chunk = (image, row tile, col tile))
    hits = np.zeros((h, w), dtype=np.int32)
    for rt in range(n_rt):
        for ct in range(n_ct):
            hits[rt * tr:(rt + 1) * tr, ct * tw:(ct + 1) * tw] += 1
    assert (hits == 1).all()
    if plan["path"] == "wgmma":  # 16-pixel k-slices within image rows
        assert (tw == 8 and tr % 2 == 0) or tw % 16 == 0
        # four stages of x and g tiles, 128 bytes a pixel in 1 KB atoms
        pixels = ((tr + 2) * (tw + 2), tr * tw)
        stage = sum(-(-n // 8) * 1024 for n in pixels)
        assert 4 * stage <= 227 * 1024
    else:
        assert tw % 8 == 0 and (tr * tw) % 16 == 0
    return plan


def test_wgrad_plan_at_the_paper_sites(paper_sites):
    _, convs = paper_sites
    assert sum(convs.values()) == 65 and len(convs) == 22
    for (h, w, cin, cout) in convs:
        plan = _check_wgrad_plan(98, h, w, cin, cout, torch.bfloat16)
        ragged = cin % 8 or cout % 8
        assert plan["path"] == ("mma" if ragged else "wgmma")
        if not ragged:  # one wave: at most one block per SM
            assert plan["tiles"] * plan["splits"] <= H100_SMS
    # the unit counts written in csrc/conv_wgrad.cu's note
    assert wgrad_plan(98, 64, 64, 64, 64, torch.bfloat16, H100_SMS)[
        "splits"] == 131
    big = wgrad_plan(98, 8, 8, 320, 320, torch.bfloat16, H100_SMS)
    assert (big["tiles"], big["splits"]) == (25, 5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(2, 8, 8, 4, 8), (3, 5, 7, 6, 4),
                                   (1, 9, 70, 40, 24), (1, 13, 24, 64, 64),
                                   (1, 7, 8, 320, 320), (2, 16, 16, 6, 64),
                                   (2, 16, 16, 64, 6)])
def test_wgrad_plan_covers_edge_shapes(shape, dtype):
    plan = _check_wgrad_plan(*shape, dtype)
    if dtype == torch.float32:
        assert plan["path"] == "f32"
