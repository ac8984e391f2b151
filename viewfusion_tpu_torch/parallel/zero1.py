"""ZeRO-1 for ``tpu.shard_opt_state``: Adam's m and v partitioned over
the data group (counterpart of JAX's ``zero1_shard_specs`` and the
sharding constraints of ``Experiment._apply_update``).

Each parameter is split as JAX splits its leaf: along the largest dim of
the leaf's JAX layout that ``data`` divides (``zero1_split_dim``), or not
at all.  A rank keeps m and v of its slice only, and ``torch.optim.Adam``
updates that slice in place (the slice is a view of the parameter).  The
updated slices then reach every rank of the data group in one
``all_gather`` of one flat buffer.  Parameters that no dim splits keep
whole m and v on every rank and are updated in full everywhere, from the
same averaged gradient.  The ranks of a view group hold the same
partition.  Adam is elementwise, so the update equals the replicated one.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from viewfusion_tpu_torch.parallel.collectives import gather_all
from viewfusion_tpu_torch.parallel.mesh import RankGrid, zero1_split_dim

__all__ = ["Zero1Adam"]


class Zero1Adam:
    """``torch.optim.Adam`` (b1, b2, eps as given) over this rank's
    slices of ``named_params``; ``jax_axes`` maps a name to the
    permutation from the torch layout to the JAX one (None: the same).
    ``self.leaves`` lists (name, param, dim or None, slice view)."""

    def __init__(self, named_params: Sequence[Tuple[str, torch.nn.Parameter]],
                 jax_axes: Dict[str, Optional[Tuple[int, ...]]],
                 grid: RankGrid, betas=(0.9, 0.999), eps: float = 1e-8):
        self.grid = grid
        n, r = grid.data, grid.data_rank
        self.leaves: List[Tuple[str, torch.nn.Parameter, Optional[int],
                                torch.Tensor]] = []
        for name, p in named_params:
            axes = jax_axes.get(name) or tuple(range(p.dim()))
            jd = zero1_split_dim([p.shape[a] for a in axes], n)
            dim = None if jd is None or n == 1 else axes[jd]
            if dim is None:
                view = p.detach()
            else:
                k = p.shape[dim] // n
                view = p.detach().narrow(dim, r * k, k)
            self.leaves.append((name, p, dim, view))
        self.optimizer = torch.optim.Adam([v for *_, v in self.leaves],
                                          lr=0.0, betas=betas, eps=eps)

    def moment_bytes(self) -> int:
        """Bytes of m and v this rank holds."""
        return sum(t.numel() * t.element_size()
                   for st in self.optimizer.state.values()
                   for key, t in st.items() if key != "step")

    @torch.no_grad()
    def step(self, lr: float) -> None:
        """One Adam update from the parameters' (averaged) ``.grad``, then
        every rank's updated slices to every rank of the data group."""
        for _, p, dim, view in self.leaves:
            view.grad = p.grad if dim is None else p.grad.narrow(
                dim, self.grid.data_rank * view.shape[dim], view.shape[dim])
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        for *_, view in self.leaves:
            view.grad = None
        self._gather([(p.detach(), dim, v) for _, p, dim, v in self.leaves
                      if dim is not None])

    def _gather(self, items) -> None:
        """Fill each full tensor's other slices from the other ranks:
        ``items`` are (full tensor, dim, this rank's slice)."""
        if not items:
            return
        flat = torch.cat([v.reshape(-1) for _, _, v in items])
        for r, part in enumerate(gather_all(flat, self.grid.data_group)):
            if r == self.grid.data_rank:
                continue
            off = 0
            for full, dim, v in items:
                k = v.shape[dim]
                full.narrow(dim, r * k, k).copy_(
                    part[off:off + v.numel()].view(v.shape))
                off += v.numel()

    @torch.no_grad()
    def full_moments(self) -> Tuple[Dict[str, torch.Tensor],
                                    Dict[str, torch.Tensor]]:
        """Whole m and v per parameter name (zeros before the first
        update), gathered over the data group: every rank must call it."""
        state = self.optimizer.state
        mu, nu, items = {}, {}, []
        for name, p, dim, view in self.leaves:
            st = state.get(view)
            m = st["exp_avg"] if st else torch.zeros_like(view)
            v = st["exp_avg_sq"] if st else torch.zeros_like(view)
            if dim is None:
                mu[name], nu[name] = m, v
                continue
            mu[name], nu[name] = torch.empty_like(p), torch.empty_like(p)
            lo = self.grid.data_rank * view.shape[dim]
            for full, mine in ((mu[name], m), (nu[name], v)):
                full.narrow(dim, lo, view.shape[dim]).copy_(mine)
                items.append((full, dim, mine))
        self._gather(items)
        return mu, nu

    @torch.no_grad()
    def load_moments(self, count: int, mu: Dict[str, torch.Tensor],
                     nu: Dict[str, torch.Tensor]) -> None:
        """Keep this rank's slices of whole m and v after ``count``
        updates (``count`` 0: a fresh state)."""
        state = self.optimizer.state
        state.clear()
        if count <= 0:
            return
        for name, p, dim, view in self.leaves:
            def mine(full):
                full = full.to(p.device)
                if dim is not None:
                    full = full.narrow(dim, self.grid.data_rank
                                       * view.shape[dim], view.shape[dim])
                return full.contiguous().clone()

            state[view] = {"step": torch.tensor(float(count)),
                           "exp_avg": mine(mu[name]),
                           "exp_avg_sq": mine(nu[name])}
