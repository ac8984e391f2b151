"""The work counts: the UNet's FLOPs at the paper configuration as
``bench.py``'s walker gives them, the GroupNorm, attention and DiT
counts against counts worked by hand at a tiny size, and the kernels'
per-site bytes and bounds (``work/kernels.py``)."""

from collections import Counter

from bench_h100.work import dit, h100, kernels, unet

PAPER = {"image_size": 64, "in_channel": 6, "out_channel": 6,
         "inner_channel": 64, "res_blocks": 3, "attn_res": [16],
         "channel_mults": [1, 2, 3, 5]}
# 8 px, inner 8, mults 1/2, one res block, attention at 4 px
TINY = {"image_size": 8, "in_channel": 6, "out_channel": 6,
        "inner_channel": 8, "res_blocks": 1, "attn_res": [4],
        "channel_mults": [1, 2]}


def test_unet_flops_at_the_paper_config():
    assert unet.flops_per_row(PAPER) == 20_993_540_096


def test_paper_sites_match_the_kernels_launches():
    assert sum(unet.groupnorm_sites(PAPER).values()) == 69
    assert sum(unet.attention_sites(PAPER).values()) == 8


def test_tiny_sites_by_hand():
    # downs: stem 8px c8; block 8px 8->8; down to 4px c8; block 4px 8->16
    # (attn); mid 4px 16 (attn), 16; ups at 4px: 16+16->16, 16+8->16
    # (both attn), upsample to 8px; at 8px: 16+8->8, 8+8->8; final 8.
    gn = Counter({(64, 8, "silu"): 2,                      # down block 8px
                  (16, 8, "silu"): 1, (16, 16, "silu"): 1,  # down 4px
                  (16, 16, "none"): 1})
    gn += Counter({(16, 16, "silu"): 4, (16, 16, "none"): 1})  # mid
    gn += Counter({(16, 32, "silu"): 1, (16, 16, "silu"): 2,
                   (16, 16, "none"): 2, (16, 24, "silu"): 1})  # ups 4px
    gn += Counter({(64, 24, "silu"): 1, (64, 8, "silu"): 2,
                   (64, 16, "silu"): 1})                   # ups 8px
    gn += Counter({(64, 8, "silu"): 1})                    # final block
    assert unet.groupnorm_sites(TINY) == gn
    assert unet.attention_sites(TINY) == Counter({(16, 16, 1): 4})


def test_tiny_flops_by_hand():
    def conv(h, cin, cout, k=3):
        return 2 * k * k * cin * cout * h * h

    def attn(h, c):
        return conv(h, c, 3 * c, 1) + 4 * (h * h) ** 2 * c + conv(h, c, c, 1)

    f = conv(8, 6, 8)                                       # stem
    f += conv(8, 8, 8) * 2                                  # block 8px
    f += conv(4, 8, 8)                                      # down
    f += conv(4, 8, 16) + conv(4, 16, 16) + conv(4, 8, 16, 1) + attn(4, 16)
    f += 2 * conv(4, 16, 16) + attn(4, 16)                  # mid 0
    f += 2 * conv(4, 16, 16)                                # mid 1
    f += conv(4, 32, 16) + conv(4, 16, 16) + conv(4, 32, 16, 1) + attn(4, 16)
    f += conv(4, 24, 16) + conv(4, 16, 16) + conv(4, 24, 16, 1) + attn(4, 16)
    f += conv(8, 16, 16)                                    # upsample conv
    f += conv(8, 24, 8) + conv(8, 8, 8) + conv(8, 24, 8, 1)
    f += conv(8, 16, 8) + conv(8, 8, 8) + conv(8, 16, 8, 1)
    f += conv(8, 8, 6)                                      # head
    assert unet.flops_per_row(TINY) == f


def test_bytes_by_hand():
    # 2 rows of (L=16, C=8) in bf16: x read + y written, 2*16*8*2 bytes
    # a row, plus mean and rstd (32 groups x 4 bytes x 2) a row, plus
    # scale and bias (8 x 4 x 2)
    assert kernels.groupnorm_fwd_bytes(2, 16, 8) == 2 * (512 + 256) + 64
    assert kernels.groupnorm_bwd_bytes(2, 16, 8) == 2 * (768 + 256) + 128
    # q, k, v in bf16 and the f32 output: 16 x 8 x (6 + 4) a row
    assert kernels.attention_bytes(3, 16, 8) == 3 * 16 * 8 * 10
    assert kernels.attention_flops(3, 16, 8) == 3 * 4 * 16 * 16 * 8


def test_dit_by_hand():
    cfg = {"image_size": 16, "in_channel": 6, "out_channel": 6,
           "patch_size": 4, "hidden_size": 32, "depth": 2, "num_heads": 2}
    s, d = 16, 32
    block = (2 * s * d * 3 * d + 4 * s * s * d + 2 * s * d * d
             + 2 * s * d * 4 * d * 2 + 2 * d * 6 * d)
    f = (2 * s * d * 16 * 6 + 2 * (d * 4 * d + 4 * d * d) + 2 * block
         + 2 * d * 2 * d + 2 * s * d * 16 * 6)
    assert dit.flops_per_row(cfg) == f
    assert dit.attention_sites(cfg) == Counter({(16, 16, 2): 2})


def test_bound_takes_the_larger_term():
    assert h100.bound_s(3.35e12, 0, "bfloat16") == 1.0
    assert h100.bound_s(0, 989e12, "bfloat16") == 1.0
    assert h100.bound_s(0, 67e12, "float32") == 1.0


def test_site_bounds_add_up_the_sites():
    gn = Counter({(16, 8, "silu"): 2, (64, 4, "none"): 1})
    assert kernels.groupnorm_bound_s(gn, 3, "bfloat16") == (
        2 * kernels.groupnorm_fwd_bytes(3, 16, 8)
        + kernels.groupnorm_fwd_bytes(3, 64, 4)) / 3.35e12
    assert kernels.groupnorm_bound_s(gn, 3, "bfloat16", backward=True) == (
        2 * kernels.groupnorm_bwd_bytes(3, 16, 8)
        + kernels.groupnorm_bwd_bytes(3, 64, 4)) / 3.35e12
    # a site of 2 heads runs one call on twice the rows; this one is
    # bound by its bytes in bf16 and by its FLOPs in f32
    at = Counter({(256, 8, 2): 3})
    assert kernels.attention_bound_s(at, 5, "bfloat16") == \
        3 * kernels.attention_bytes(10, 256, 8) / 3.35e12
    assert kernels.attention_bound_s(at, 5, "float32") == \
        3 * kernels.attention_flops(10, 256, 8) / 67e12
