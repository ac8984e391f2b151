"""Forward FLOPs of the ViewFusion UNet and the work of its GroupNorm and
attention sites, from the configuration's widths alone.

``flops_per_row`` is a frozen copy of ``bench.py:unet_flops_per_row``
(repo commit f80e7a7): convs, residual, qkv and output projections and
the attention products walked over the UNet topology; norms, activations,
bias adds and the noise-level MLP are left out (<1%).  At the paper
configuration (64 px, inner 64, mults 1/2/3/5, 3 res blocks, attention at
16 px) it gives 20,993,540,096 FLOPs per row.

``groupnorm_sites`` and ``attention_sites`` list each site's shape and
count per forward, walked over the same topology (rewritten from the
hooks of ``chip_smoke.py:sites`` as arithmetic on the widths), in the
shapes ``work/kernels.py`` reads.
"""

from __future__ import annotations

from collections import Counter


def _walk(cfg):
    """Yield ("conv", h, cin, cout, k, stride_out_h) and ("block", h, cin,
    cout, attn) items in forward order."""
    inner = cfg["inner_channel"]
    now = cfg["image_size"]
    mults = cfg["channel_mults"]
    attn_res = cfg["attn_res"]
    yield ("conv", now, cfg["in_channel"], inner, 3)
    skips, pre = [inner], inner
    for ind, m in enumerate(mults):
        cm = inner * m
        for _ in range(cfg["res_blocks"]):
            yield ("block", now, pre, cm, now in attn_res)
            pre = cm
            skips.append(cm)
        if ind != len(mults) - 1:
            now //= 2
            yield ("conv", now, pre, pre, 3)      # stride-2, output at now
            skips.append(pre)
    yield ("block", now, pre, pre, True)          # mid 0
    yield ("block", now, pre, pre, False)         # mid 1
    for ind in reversed(range(len(mults))):
        cm = inner * mults[ind]
        for _ in range(cfg["res_blocks"] + 1):
            yield ("block", now, pre + skips.pop(), cm, now in attn_res)
            pre = cm
        if ind >= 1:
            now *= 2
            yield ("conv", now, pre, pre, 3)      # after the 2x upsample
    yield ("final", now, pre, cfg["out_channel"], 3)


def _conv(h, cin, cout, k=3):
    return 2.0 * k * k * cin * cout * h * h


def flops_per_row(cfg) -> float:
    """Analytic forward FLOPs of one UNet row (one (H, W, in) input)."""
    total = 0.0
    for item in _walk(cfg):
        if item[0] in ("conv", "final"):
            _, h, cin, cout, k = item
            total += _conv(h, cin, cout, k)
            continue
        _, h, cin, cout, attn = item
        total += _conv(h, cin, cout) + _conv(h, cout, cout)
        if cin != cout:
            total += _conv(h, cin, cout, k=1)
        if attn:
            s = h * h
            total += _conv(h, cout, 3 * cout, k=1)
            total += 2.0 * s * s * cout * 2
            total += _conv(h, cout, cout, k=1)
    return total


def groupnorm_sites(cfg) -> Counter:
    """Counter of (L, C, act) per forward: L = H*W rows of C channels of
    one sample; act is "silu" (the Blocks) or "none" (attention's norm)."""
    sites = Counter()
    for item in _walk(cfg):
        if item[0] == "final":
            _, h, cin, _, _ = item
            sites[(h * h, cin, "silu")] += 1
        if item[0] != "block":
            continue
        _, h, cin, cout, attn = item
        sites[(h * h, cin, "silu")] += 1      # block1's norm
        sites[(h * h, cout, "silu")] += 1     # block2's norm
        if attn:
            sites[(h * h, cout, "none")] += 1
    return sites


def attention_sites(cfg) -> Counter:
    """Counter of (S, C, 1) per forward: single-head attention over
    S = H*W tokens of C channels."""
    sites = Counter()
    for item in _walk(cfg):
        if item[0] == "block" and item[4]:
            _, h, _, cout, _ = item
            sites[(h * h, cout, 1)] += 1
    return sites
