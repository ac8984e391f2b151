"""The host-side work plans of the port's kernels, on the CPU.

``attention_plan`` (K3), ``wgrad_plan`` (K4) and ``group_norm_plan`` (K1
and K2) decide the blocks the kernels launch.  At every main-path site
of the paper UNet (found by hooks on the model, as ``chip_smoke.py``
finds them) and at the card tests' edge shapes, the plans must cover
each query and output channel, each pixel, or each row of a sample
exactly once, keep the shapes the kernels take, fit a block's shared
memory, and fill the card's 132 SMs as their notes say.  Plain
arithmetic: no card.
"""

from collections import Counter

import numpy as np
import pytest
import torch

from viewfusion_tpu_torch.config import Config
from viewfusion_tpu_torch.models import unet as unet_module
from viewfusion_tpu_torch.models.unet import GroupNormAct, SelfAttention, UNet
from viewfusion_tpu_torch.ops.attention import attention_plan
from viewfusion_tpu_torch.ops.conv_wgrad import wgrad_plan
from viewfusion_tpu_torch.ops.groupnorm import group_norm_plan

H100_SMS = 132
ROWS = (28, 48, 98)  # ancestral chain, serving batch, training batch
PAPER_UNET = {"image_size": 64, "in_channel": 6, "out_channel": 6,
              "inner_channel": 64, "res_blocks": 3, "attn_res": [16],
              "channel_mults": [1, 2, 3, 5]}


@pytest.fixture(scope="module")
def paper_sites():
    """(S, C) attention sites, (H, W, Cin, Cout) stride-1 3x3 conv sites
    and (L, C) GroupNorm sites of one paper-UNet forward, with their
    counts."""
    cfg = Config.from_dict({"model": {"denoise_net_params": PAPER_UNET}})
    torch.manual_seed(0)
    unet = UNet(cfg.unet).eval()
    attn, convs, norms = Counter(), Counter(), Counter()
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
    hooks += [m.register_forward_pre_hook(
        lambda m, a: norms.update([(a[0].shape[2] * a[0].shape[3],
                                    a[0].shape[1])]))
        for m in unet.modules() if isinstance(m, GroupNormAct)]
    with torch.inference_mode():
        unet(torch.zeros((1, 64, 64, 6)), torch.zeros(1), torch.zeros(1))
    for h in hooks:
        h.remove()
    return attn, convs, norms


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
    attn, _, _ = paper_sites
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


def test_attention_plan_at_the_dit_sites(monkeypatch):
    """dit-small-tpu-4 (hidden 384, 6 heads of 64, 256 tokens): K3 runs
    once per block on (rows * 6, 256, 64), one channel part, so each
    block owns one head's 64 queries: 288 rows serving 48, 588 training
    R = 98, 168 on the 28-row chain."""
    import os

    from viewfusion_tpu_torch.config import load_config
    from viewfusion_tpu_torch.models import dit as dit_module
    from viewfusion_tpu_torch.models.view_fusion import ViewFusion

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config(os.path.join(root, "configs", "dit-small-tpu-4.yaml"))
    torch.manual_seed(0)
    dit = ViewFusion.from_config(cfg, dtype=torch.float32).unet.eval()
    sites = Counter()
    attend = dit_module.spatial_self_attention

    def record(q, k, v, scale):
        sites.update([tuple(q.shape)])
        assert q.stride() == k.stride() == v.stride() and q.stride(-1) == 1
        assert scale == 1 / 8
        return attend(q, k, v, scale)

    monkeypatch.setattr(dit_module, "spatial_self_attention", record)
    with torch.inference_mode():
        dit(torch.zeros((1, 64, 64, 6)), torch.zeros(1), torch.zeros(1))
    assert sites == Counter({(6, 256, 64): 12})
    for rows, blocks in ((48, 1152), (98, 2352), (28, 672)):
        plan = attention_plan(rows * 6, 256, 64)
        assert plan == {"q_tiles": 4, "parts": 1, "part_width": 64,
                        "blocks": blocks}
        assert (_attention_coverage(2, 256, 64, plan) == 1).all()


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
    _, convs, _ = paper_sites
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


def _check_group_norm_plan(b, l, c, itemsize, n_tensors, align=16):
    """K1's (one tensor) or K2's (x and g) plan for (B, L, C): every row
    of a sample in exactly one block, staged chunks of whole sweeps of
    the block's threads, one mbarrier per chunk, and the staged rows, the
    threads' sums and the partials within a block's shared memory
    (csrc/gn_cluster.cuh's layout)."""
    plan = group_norm_plan(b, l, c, itemsize, n_tensors, H100_SMS, align)
    hits = np.zeros(l, dtype=np.int32)
    for rank in range(plan.cluster):
        hits[rank * plan.rows_per_block:
             (rank + 1) * plan.rows_per_block] += 1
    assert (hits == 1).all()
    assert plan.cluster in (1, 2, 4, 8, 16)  # 16 with the non-portable flag
    assert plan.vec * itemsize <= 16 and c % plan.vec == 0
    assert align % (plan.vec * itemsize) == 0
    assert plan.bulk == (plan.vec * itemsize == 16)
    nv = c // plan.vec
    assert plan.threads % nv == 0 and plan.threads <= max(256, nv)
    assert 0 <= plan.rows_staged <= plan.rows_per_block
    assert plan.chunk_rows % (plan.threads // nv) == 0
    assert -(-plan.rows_staged // plan.chunk_rows) <= 16
    staged = -(-plan.rows_staged * c * itemsize * n_tensors // 16) * 16
    need = (128 + staged + 4 * plan.threads * plan.vec
            + 8 * c * (plan.cluster + 2))
    assert need <= plan.smem <= 232_448
    # blocks for at least half the SMs, unless a cluster of 8 is not
    # enough
    assert 2 * b * plan.cluster >= H100_SMS or plan.cluster >= min(8, l)
    return plan


@pytest.mark.parametrize("n_tensors", [1, 2], ids=["K1", "K2"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows", ROWS)
def test_group_norm_plan_at_the_paper_sites(paper_sites, rows, dtype,
                                            n_tensors):
    _, _, norms = paper_sites
    assert sum(norms.values()) == 69 and len(norms) == 17
    itemsize = torch.tensor([], dtype=dtype).element_size()
    for (l, c) in norms:
        plan = _check_group_norm_plan(rows, l, c, itemsize, n_tensors)
        if dtype == torch.bfloat16:  # the whole slice on chip
            assert plan.rows_staged == plan.rows_per_block
            assert plan.bulk
    # the clusters written in csrc/groupnorm.cu's and groupnorm_bwd.cu's
    # notes: the largest slices (1.5 MiB for K1, 3 MiB for K2 in bf16)
    big = group_norm_plan(rows, 4096, 192, itemsize, n_tensors, H100_SMS)
    if dtype == torch.bfloat16:
        assert big.cluster == (8 if n_tensors == 1 else 16)


# the card tests' GroupNorm shapes (tests/test_torch_port_cuda.py
# GN_SHAPES and GN_BWD_SHAPES), (B, H, W, C)
GN_EDGE_SHAPES = [(2, 8, 8, 64), (3, 5, 7, 24), (2, 4, 4, 40),
                  (5, 64, 64, 192), (48, 8, 8, 640), (2, 3, 3, 6),
                  (98, 64, 64, 64), (98, 8, 8, 640), (98, 64, 64, 192),
                  (98, 64, 64, 128)]


@pytest.mark.parametrize("n_tensors", [1, 2], ids=["K1", "K2"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", GN_EDGE_SHAPES)
def test_group_norm_plan_covers_edge_shapes(shape, dtype, n_tensors):
    b, h, w, c = shape
    itemsize = torch.tensor([], dtype=dtype).element_size()
    plan = _check_group_norm_plan(b, h * w, c, itemsize, n_tensors)
    if (c * itemsize) % 16:  # rows of 12 or 24 bytes: no bulk copies
        assert not plan.bulk


@pytest.mark.parametrize("align", [2, 4, 8])
def test_group_norm_plan_narrows_vectors_for_misaligned_data(align):
    """An x that is not 16-byte aligned (a view at an odd offset) takes
    vectors the alignment allows, and the threads stage its rows."""
    plan = _check_group_norm_plan(4, 1024, 128, 2, 1, align=align)
    assert plan.vec == align // 2 and not plan.bulk
    assert plan.rows_staged == plan.rows_per_block
