"""Forward FLOPs of the ADM denoiser and the work of its GroupNorm and
attention sites, from the configuration's widths, walked over the same
topology as the plain reference (``reference/adm.py``).

``flops_per_row`` counts the convolutions (stem, each ResBlock's two 3x3
convs and its 1x1 skip, the output conv), the attention blocks' ``qkv``
and ``proj`` and their two products a head, and the linears of the
conditioning (``time_embed``, each ResBlock's ``emb_layers``); norms,
activations, pooling, upsampling and adds are left out.  At the 64x64
flags (192 channels, mults 1/2/3/4, 3 ResBlocks a level, attention at
32, 16 and 8 px with heads of 64) it gives 219.4 GFLOP a row.

``groupnorm_sites`` lists every GroupNorm (K1 forward, K2 backward):
each ResBlock's first norm (``silu``) and its AdaGN (counted ``silu``:
the scale-shift is folded into the affine), each attention block's norm
(``none``) and the output's (``silu``; the program runs this one in
f32, as ADM does, which ``work/kernels.py``'s bf16 bytes undercount).
``attention_sites`` lists (S, head width, heads).
"""

from __future__ import annotations

from collections import Counter

from bench_h100.reference.adm import topology


def _layers(cfg):
    """(kind, H, H out, cin, cout, extra) per layer in forward order: the
    layer's input and output resolutions."""
    stages, _ = topology(cfg)
    res = cfg["image_size"]
    for _, layers in stages:
        for _, kind, cin, cout, extra in layers:
            out = {"down": res // 2, "up": res * 2}.get(extra, res) \
                if kind == "res" else res
            yield kind, res, out, cin, cout, extra
            res = out


def _conv(h, cin, cout, k=3):
    return 2.0 * k * k * cin * cout * h * h


def flops_per_row(cfg) -> float:
    """Analytic forward FLOPs of one ADM row (one (H, W, in) input)."""
    mc = cfg["model_channels"]
    emb = 4 * mc
    total = 2.0 * (mc * emb + emb * emb)                  # time_embed
    for kind, h, out, cin, cout, _ in _layers(cfg):
        if kind == "stem":
            total += _conv(h, cin, cout)
        elif kind == "res":
            total += _conv(out, cin, cout) + _conv(out, cout, cout)
            total += 2.0 * emb * 2 * cout                  # emb_layers
            if cin != cout:
                total += _conv(out, cin, cout, k=1)
        else:
            s = h * h
            total += 2.0 * s * cin * 3 * cin + 2.0 * s * cin * cin
            total += 4.0 * s * s * cin                     # q k^T, p v
    total += _conv(cfg["image_size"], mc * cfg["channel_mult"][0],
                   cfg["out_channel"])
    return total


def groupnorm_sites(cfg) -> Counter:
    """Counter of (L, C, act) per forward, L = H*W rows of one sample."""
    sites = Counter()
    for kind, h, out, cin, cout, _ in _layers(cfg):
        if kind == "res":
            sites[(h * h, cin, "silu")] += 1
            sites[(out * out, cout, "silu")] += 1        # AdaGN
        elif kind == "attn":
            sites[(h * h, cin, "none")] += 1
    sites[(cfg["image_size"] ** 2, cfg["model_channels"]
           * cfg["channel_mult"][0], "silu")] += 1
    return sites


def attention_sites(cfg) -> Counter:
    """Counter of (S, head width, heads) per forward."""
    return Counter((h * h, cin // heads, heads)
                   for kind, h, _, cin, _, heads in _layers(cfg)
                   if kind == "attn")
