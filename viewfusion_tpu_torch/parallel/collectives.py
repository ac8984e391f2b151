"""Collectives over the process group (counterpart of
``viewfusion_tpu/parallel/collectives.py``, the reference's
``utils/dist.py`` surface).

In JAX these are mostly reductions over global arrays that XLA lowers to
collectives; here each is a ``torch.distributed`` call.  Every function
is a no-op (or the identity) in one process, and takes an explicit group
where the JAX version takes a mesh axis name.  Under gloo, CUDA tensors
go through ``all_reduce``, ``broadcast`` and ``all_gather`` staged via
host memory; nothing here uses ``reduce_scatter``, which gloo lacks.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.distributed as dist

__all__ = ["get_rank", "get_world_size", "reduce_dict", "gather_all",
           "psum_dict", "all_gather"]


def get_rank() -> int:
    """This process's rank (reference: utils/dist.py:52-55)."""
    return dist.get_rank() if dist.is_initialized() else 0


def get_world_size() -> int:
    """The number of processes (reference: utils/dist.py:46-49)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def _group_size(group) -> int:
    if not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


def reduce_dict(input_dict: Dict[str, torch.Tensor],
                average: bool = True) -> Dict[str, torch.Tensor]:
    """All-reduce each value over every process, the mean or the sum, in
    sorted key order (reference: utils/dist.py:69-91): one all_reduce of
    the values laid end to end."""
    keys = sorted(input_dict)
    if get_world_size() == 1:
        return {k: input_dict[k] for k in keys}
    values = [torch.as_tensor(input_dict[k]) for k in keys]
    flat = torch.cat([v.reshape(-1) for v in values])
    dist.all_reduce(flat)
    if average:
        flat /= get_world_size()
    out, off = {}, 0
    for k, v in zip(keys, values):
        out[k] = flat[off:off + v.numel()].view(v.shape)
        off += v.numel()
    return out


def gather_all(x: torch.Tensor, group=None) -> List[torch.Tensor]:
    """One tensor per rank of ``group`` (all ranks by default), in rank
    order (reference: utils/dist.py:58-66).  Every rank passes a tensor
    of the same shape."""
    n = _group_size(group)
    if n == 1:
        return [x]
    x = x.contiguous()
    out = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(out, x, group=group)
    return out


def psum_dict(d: Dict[str, torch.Tensor], group=None,
              average: bool = True) -> Dict[str, torch.Tensor]:
    """Sum (or mean) every value over ``group``, in place; returns ``d``."""
    n = _group_size(group)
    if n > 1:
        for k in sorted(d):
            dist.all_reduce(d[k], group=group)
            if average:
                d[k] /= n
    return d


class _AllGather(torch.autograd.Function):
    """Concatenate every rank's rows along dim 0; the backward sums the
    ranks' gradients of this rank's rows (an all_reduce, then the slice:
    gloo has no reduce_scatter)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.rows = group, x.shape[0]
        return torch.cat(gather_all(x, group))

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        dist.all_reduce(grad, group=ctx.group)
        lo = dist.get_rank(ctx.group) * ctx.rows
        return grad[lo:lo + ctx.rows], None


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) concatenated along dim 0, in rank
    order, with autograd: the gradient of this rank's rows is the sum of
    every rank's gradient of them."""
    if _group_size(group) == 1:
        return x
    return _AllGather.apply(x, group)
