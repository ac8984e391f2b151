"""Forward FLOPs of the DiT denoiser and its attention sites, from the
configuration's widths (Peebles & Xie, arXiv 2212.09748: the patchify
conv, per block qkv, the attention products, the projection, the MLP and
the adaLN linears, then the final adaLN and the unpatchify linear).
LayerNorms, modulations, GELU and residual adds are left out."""

from __future__ import annotations

from collections import Counter


def tokens(cfg) -> int:
    return (cfg["image_size"] // cfg["patch_size"]) ** 2


def flops_per_row(cfg) -> float:
    d, p, s = cfg["hidden_size"], cfg["patch_size"], tokens(cfg)
    mlp = cfg.get("mlp_ratio", 4) * d
    total = 2.0 * s * d * p * p * cfg["in_channel"]          # patchify
    total += 2.0 * (d * 4 * d + 4 * d * d)                     # cond MLP
    per_block = (2.0 * s * d * 3 * d                           # qkv
                 + 4.0 * s * s * d                              # q k^T, p v
                 + 2.0 * s * d * d                              # proj
                 + 2.0 * s * d * mlp * 2                        # fc1, fc2
                 + 2.0 * d * 6 * d)                             # adaLN
    total += cfg["depth"] * per_block
    total += 2.0 * d * 2 * d                                   # final adaLN
    total += 2.0 * s * d * p * p * cfg["out_channel"]          # unpatchify
    return total


def attention_sites(cfg) -> Counter:
    """Counter of (S, hd, heads) per forward; each site runs once per row
    and head."""
    hd = cfg["hidden_size"] // cfg["num_heads"]
    return Counter({(tokens(cfg), hd, cfg["num_heads"]): cfg["depth"]})
