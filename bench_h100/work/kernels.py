"""The work of one call of the program's hand-written kernels at one
site, whatever the model family: K1 (GroupNorm + SiLU forward), K2 (its
backward) and K3 (attention).  A site's bytes read every input once and
write every output once.

A family's ``work/<denoiser>.py`` lists its sites per forward: for K1
and K2 ``groupnorm_sites(widths)``, a Counter of (L, C, act) (L = H*W
rows of C channels of one sample; act "silu" or "none"); for K3
``attention_sites(widths)``, a Counter of (S, head width, heads).  The
bounds below add the sites up for ``rows`` samples."""

from __future__ import annotations

from bench_h100.work import h100


def groupnorm_fwd_bytes(rows: int, L: int, C: int, act_bytes: int = 2
                        ) -> float:
    """K1 at one site for ``rows`` samples: x read, y written (the
    compute dtype), scale and bias read (f32), mean and rstd written
    (f32, one per group of 32 groups)."""
    return rows * (2 * L * C * act_bytes + 2 * 32 * 4) + 2 * C * 4


def groupnorm_bwd_bytes(rows: int, L: int, C: int, act_bytes: int = 2
                        ) -> float:
    """K2 at one site: x and dy read, dx written (the compute dtype);
    scale, bias, mean and rstd read; dscale and dbias written (f32)."""
    return rows * (3 * L * C * act_bytes + 2 * 32 * 4) + 4 * C * 4


def attention_bytes(rows: int, S: int, C: int, act_bytes: int = 2) -> float:
    """K3 at one site: q, k, v read (the compute dtype), the f32 output
    written."""
    return rows * S * C * (3 * act_bytes + 4)


def attention_flops(rows: int, S: int, C: int) -> float:
    """q k^T and p v: 2 * S * S * C FLOPs each."""
    return rows * 4.0 * S * S * C


def groupnorm_bound_s(sites, rows, dtype: str, backward: bool = False
                      ) -> float:
    """The byte bound of K1 (K2 where ``backward``) over ``sites`` at
    ``rows`` samples."""
    nbytes = groupnorm_bwd_bytes if backward else groupnorm_fwd_bytes
    return sum(n * h100.bound_s(nbytes(rows, L, C), 0.0, dtype)
               for (L, C, _), n in sites.items())


def attention_bound_s(sites, rows, dtype: str) -> float:
    """The bound of K3 over ``sites`` at ``rows`` samples: one call on
    (rows x heads, S, head width) a site, the larger of its bytes and
    its FLOPs term."""
    return sum(n * h100.bound_s(attention_bytes(rows * heads, S, hd),
                                attention_flops(rows * heads, S, hd), dtype)
               for (S, hd, heads), n in sites.items())
