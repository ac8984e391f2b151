"""The (data, view) rank grid of the port (counterpart of
``viewfusion_tpu/parallel/mesh.py``).

JAX runs one process per host with many devices and lets XLA insert the
collectives over a device mesh.  The port runs one process per device,
as the reference did (``torchrun``, DDP over NCCL): the ranks rendezvous
through the torchrun environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), and the mesh is a grid
of ranks:

  * ``view = max(1, tpu.mesh_view)`` and ``data = tpu.mesh_data`` if it
    is above 0, else ``world // view``; ``data * view`` must equal the
    world size.  JAX may leave devices idle and say so; a launched rank
    cannot idle, so the port raises with the numbers;
  * rank r sits at ``(r // view, r % view)``: the ranks of one data index
    form a view group, the ranks of one view index a data group.

The batch layout (``_BATCH_SPECS``, JAX's per-key shardings) is the rule
that picks a rank's rows of a host batch: a key split on B over ``data``
keeps the rank's slice of B, a replicated key is kept whole, and
``accum=True`` shifts every spec right by one axis (the microbatch axis).
``cond`` is split on B alone: where the JAX mesh splits its view axis
over ``view``, the port splits the UNet rows built from it (the
``Trainer``'s view split), so the ranks of a view group hold the same
samples.

``zero1_split_dim`` is the ZeRO-1 rule of ``zero1_shard_specs``: a leaf
is split along its largest dim that ``data`` divides, or replicated.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["MeshSpec", "RankGrid", "make_mesh", "batch_spec",
           "shard_batch", "zero1_split_dim", "initialize_distributed",
           "num_hosts_env", "host_id", "num_hosts", "DATA_AXIS"]

DATA_AXIS = "data"


@dataclass(frozen=True)
class MeshSpec:
    """How many ways to split each axis; ``data`` <= 0 takes the ranks
    that ``view`` leaves."""

    data: int = -1
    view: int = 1


@dataclass(frozen=True)
class RankGrid:
    """This process's place in the ``data x view`` grid, with the groups
    its collectives run over: ``data_group`` (the ranks of this view
    index; ZeRO-1 and the eval sums), ``view_group`` (the ranks of this
    data index; the view split's gather) and ``host_group`` (a gloo group
    of all ranks for host-side values: the stop flag, the run dir's
    name).  Each group is None where it would hold this rank alone; all
    three are None in one process."""

    data: int = 1
    view: int = 1
    rank: int = 0
    data_group: Any = None
    view_group: Any = None
    host_group: Any = None

    @property
    def world(self) -> int:
        return self.data * self.view

    @property
    def data_rank(self) -> int:
        return self.rank // self.view

    @property
    def view_rank(self) -> int:
        return self.rank % self.view

    @property
    def is_host0(self) -> bool:
        return self.rank == 0


def make_mesh(spec: MeshSpec = MeshSpec(),
              batch_rows: Optional[int] = None) -> RankGrid:
    """The rank grid of this process over the initialised process group
    (one process without one).  ``batch_rows`` (the global rows of one
    microbatch, ``batch_size // grad_accum``) must split evenly over
    ``data``.  Every rank creates every subgroup, in one order."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    view = max(1, spec.view)
    data = spec.data if spec.data > 0 else world // view
    if data * view != world:
        raise ValueError(
            f"mesh {data}x{view} (tpu.mesh_data={spec.data}, "
            f"tpu.mesh_view={spec.view}) != {world} processes: every "
            "launched rank must hold a place in the grid")
    if batch_rows is not None and batch_rows % data:
        raise ValueError(
            f"the batch of {batch_rows} rows per microbatch "
            f"(data.batch_size // tpu.grad_accum) does not split over "
            f"data={data} ranks")
    if world == 1:
        return RankGrid()
    data_group = view_group = None
    for v in range(view):  # data groups: one view index each
        g = dist.new_group([d * view + v for d in range(data)])
        if rank % view == v and data > 1:
            data_group = g
    for d in range(data):  # view groups: one data index each
        g = dist.new_group([d * view + v for v in range(view)])
        if rank // view == d and view > 1:
            view_group = g
    host_group = (dist.new_group(backend="gloo")
                  if dist.get_backend() != "gloo" else dist.group.WORLD)
    return RankGrid(data, view, rank, data_group, view_group, host_group)


# the JAX batch shardings, per key: "data" on the axes split over data
_BATCH_SPECS: Dict[str, Tuple[Optional[str], ...]] = {
    "target": (DATA_AXIS,),
    "cond": (DATA_AXIS,),
    "relative_cond": (DATA_AXIS,),
    "all_views": (DATA_AXIS,),
    "angle": (DATA_AXIS,),
    "relative_angle": (DATA_AXIS,),
    "view_count": (DATA_AXIS,),
    "noise": (DATA_AXIS,),
    "eval_mask": (DATA_AXIS,),
    # packed-row indices gather across samples: replicated in JAX; a
    # rank builds its own from its samples' counts
    "sample_idx": (),
    "view_idx": (),
    # the fused feed (training/fused_feed.py)
    "img": (DATA_AXIS,),
    "meta_b": (DATA_AXIS,),
    "meta_r": (),
}


def batch_spec(key: str, accum: bool = False) -> Tuple[Optional[str], ...]:
    """The layout of one batch key: per axis, ``"data"`` or None
    (replicated).  ``accum=True``: a leading microbatch axis, unsplit."""
    spec = _BATCH_SPECS.get(key, (DATA_AXIS,))
    return ((None,) + spec) if accum else spec


def shard_batch(batch: Dict[str, Any], grid: RankGrid,
                accum: bool = False) -> Dict[str, Any]:
    """This rank's part of a host batch (numpy arrays or tensors) under
    :func:`batch_spec`: each axis split over ``data`` keeps the rank's
    slice, the rest is kept whole."""
    out = {}
    for key, v in batch.items():
        index = []
        for ax, name in enumerate(batch_spec(key, accum)):
            if name == DATA_AXIS:
                n = v.shape[ax] // grid.data
                if n * grid.data != v.shape[ax]:
                    raise ValueError(f"{key}: axis {ax} of {v.shape[ax]} "
                                     f"does not split over data="
                                     f"{grid.data}")
                index.append(slice(grid.data_rank * n,
                                   (grid.data_rank + 1) * n))
            else:
                index.append(slice(None))
        out[key] = v[tuple(index)]
    return out


def zero1_split_dim(shape: Sequence[int], n: int) -> Optional[int]:
    """The ZeRO-1 rule of JAX's ``zero1_shard_specs``: the largest dim
    that ``n`` divides (the first of equals), or None (replicated)."""
    best = None
    for ax, d in enumerate(shape):
        if d >= n and d % n == 0 and (best is None or d > shape[best]):
            best = ax
    return best


def num_hosts_env() -> int:
    """The world size a launcher announced (torchrun's ``WORLD_SIZE``),
    1 without one."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def host_id() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def num_hosts() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def initialize_distributed(device="cuda") -> torch.device:
    """Join the process group a launcher set up, once, and return the
    device this rank runs on.  Without a launcher (no ``WORLD_SIZE``) it
    does nothing and returns ``device``.

    ``cuda`` means ``cuda:LOCAL_RANK`` (modulo the cards the process
    sees, so that ranks may share a card); an explicit ``cuda:N`` is used
    as given.  The backend is NCCL when every rank of the host can have a
    card of its own, and gloo on the CPU or when ranks share a card
    (NCCL refuses two ranks on one device).  A failed init raises."""
    device = torch.device(device)
    if "WORLD_SIZE" not in os.environ:
        return device
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    backend = "gloo"
    if device.type == "cuda":
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("initialize_distributed: no CUDA device; "
                               "pass device='cpu' to run on the CPU")
        if device.index is None:
            device = torch.device("cuda", local_rank % count)
        torch.cuda.set_device(device)
        if local_world <= count:
            backend = "nccl"
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://",
                                world_size=num_hosts_env(),
                                rank=int(os.environ["RANK"]))
        if dist.get_rank() == 0:
            print(f"process group: {dist.get_world_size()} ranks, backend "
                  f"{dist.get_backend()}, rank 0 on {device}", flush=True)
    return device

