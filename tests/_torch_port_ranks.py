"""Rank bodies of the port's multi-process tests on the CPU.

``spawn(body, world, tmp, *args)`` starts ``world`` ranks with
``torch.multiprocessing.spawn``; each joins a gloo process group through
a ``file://`` rendezvous in ``tmp`` (a free TCP port would race between
test workers), runs ``body(rank, tmp, *args)`` and saves what the test
compares with ``torch.save`` under ``tmp``.  This module imports torch
and the port only, so the ranks start without JAX.
"""

import os
import signal
import uuid

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from viewfusion_tpu_torch.config import Config
from viewfusion_tpu_torch.parallel import collectives
from viewfusion_tpu_torch.parallel.mesh import shard_batch
from viewfusion_tpu_torch.training.trainer import (Experiment,
                                                   ExperimentArgs, Trainer,
                                                   packed_indices)


def spawn(body, world: int, tmp: str, *args) -> None:
    rdv = os.path.join(tmp, f"rdv-{uuid.uuid4().hex}")
    mp.spawn(_entry, args=(world, rdv, body, tmp, args), nprocs=world,
             join=True)


def _entry(rank, world, rdv, body, tmp, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdv}",
                            rank=rank, world_size=world)
    try:
        body(rank, tmp, *args)
    finally:
        dist.destroy_process_group()


def sequence_body(rank, tmp, calls):
    """Run several bodies, ``calls`` = [(body, args), ...], in one spawn
    (each spawn pays the ranks' start)."""
    for body, args in calls:
        body(rank, tmp, *args)


def _save(obj, tmp, name, rank):
    torch.save(obj, os.path.join(tmp, f"{name}-{rank}.pt"))


def load(tmp, name, rank=0):
    return torch.load(os.path.join(tmp, f"{name}-{rank}.pt"),
                      weights_only=False)


# ---------------------------------------------------------------------
def collectives_body(rank, tmp):
    """reduce_dict, gather_all and the autograd all_gather at W ranks."""
    world = dist.get_world_size()
    d = {"b": torch.tensor([rank + 1.0, 2.0 * rank]),
         "a": torch.tensor(10.0 * (rank + 1))}
    mean, total = collectives.reduce_dict(d), collectives.reduce_dict(
        d, average=False)
    gathered = collectives.gather_all(torch.arange(3.0) + 10 * rank)
    psum = collectives.psum_dict({"s": torch.tensor([rank + 1.0])},
                                 average=False)["s"]
    x = torch.full((2, 3), float(rank + 1), requires_grad=True)
    y = collectives.all_gather(x)
    # each rank weighs the gathered rows by its own rank + 1
    (y * (rank + 1) * torch.arange(1.0, 2 * world + 1)[:, None]).sum() \
        .backward()
    _save(dict(mean=mean, total=total, gathered=gathered, y=y.detach(),
               grad=x.grad, psum=psum), tmp, "coll", rank)


def local_batch(batch, mesh, accum: bool):
    """This rank's rows of a global host batch and its own packed rows
    (a list of the microbatches' under ``accum``)."""
    local = shard_batch({k: v for k, v in batch.items()
                         if k not in ("sample_idx", "view_idx")}, mesh,
                        accum=accum)
    counts = local["view_count"]
    if "sample_idx" in batch:
        if accum:
            rows = [packed_indices(c) for c in counts]
            local["sample_idx"] = [r[0] for r in rows]
            local["view_idx"] = [r[1] for r in rows]
        else:
            local["sample_idx"], local["view_idx"] = packed_indices(counts)
    return local


def train_body(rank, tmp, cases):
    """Each case: (name, raw config, state_dict of numpy arrays, steps);
    a step is (global batch, global (noise, sample_gammas) or None).
    Records per step the loss, every gradient and every parameter after
    the update, then the whole Adam moments and this rank's bytes of
    them."""
    for name, raw, sd, steps in cases:
        cfg = Config.from_dict(raw)
        tr = Trainer(cfg, device="cpu", state_dict={
            k: torch.from_numpy(np.array(v)) for k, v in sd.items()})
        accum = cfg.train.grad_accum > 1
        named = list(tr.model.unet.named_parameters())
        rec = {"loss": [], "grads": [], "params": []}
        for batch, draws in steps:
            kw = {}
            if draws is not None:
                d = shard_batch({"noise": draws[0], "gammas": draws[1]},
                                tr.mesh, accum=accum)
                kw = dict(noise=d["noise"], sample_gammas=d["gammas"])
            loss = tr.train_step(local_batch(batch, tr.mesh, accum), **kw)
            rec["loss"].append(float(loss))
            rec["grads"].append({n: p.grad.clone() for n, p in named})
            rec["params"].append({n: p.detach().clone() for n, p in named})
        rec["adam"] = tr.adam_moments()
        rec["moment_bytes"] = (tr.zero1.moment_bytes() if tr.zero1 else
                               sum(t.numel() * t.element_size()
                                   for st in tr.optimizer.state.values()
                                   for k, t in st.items() if k != "step"))
        rec["mesh"] = (tr.mesh.data, tr.mesh.view, tr.mesh.data_rank,
                       tr.mesh.view_rank)
        _save(rec, tmp, name, rank)


def _trainer_state(tr):
    named = list(tr.model.unet.named_parameters())
    mu, nu = tr.adam_moments()
    return {"params": {n: p.detach().clone() for n, p in named},
            "mu": mu, "nu": nu, "step": tr.step,
            "ema": [e.clone() for e in tr.ema] if tr.ema else None}


def experiment_body(rank, tmp, config_path, log_root):
    """-t with gated evals and best saves, the state each rank holds at
    the end, then -r -t from the run dir: the state each rank loaded and
    the run's next step."""
    exp = Experiment(ExperimentArgs(config=config_path, train=True,
                                    device="cpu"), log_root=log_root)
    exp.train()
    held = _trainer_state(exp.trainer)
    rec = {"out_dir": exp.out_dir, "held": held, "it": exp.it,
           "mesh": (exp.mesh.data, exp.mesh.view),
           "local_batch": exp.local_batch_size,
           "moment_bytes": exp.trainer.zero1.moment_bytes()
           if exp.trainer.zero1 else None}
    del exp
    exp = Experiment(ExperimentArgs(src=rec["out_dir"], resume=True,
                                    train=True, device="cpu"),
                     log_root=log_root)
    rec["loaded"] = _trainer_state(exp.trainer)
    exp.train()
    rec["resumed_it"], rec["resumed_step"] = exp.it, exp.trainer.step
    _save(rec, tmp, "exp", rank)


def knob_body(rank, tmp, config_path, log_root, name):
    """The Experiment of ``config_path`` builds and trains to max_it."""
    exp = Experiment(ExperimentArgs(config=config_path, train=True,
                                    device="cpu"), log_root=log_root)
    exp.train()
    _save({"it": exp.it, "step": exp.trainer.step,
           "mesh": (exp.mesh.data, exp.mesh.view),
           "out_dir": exp.out_dir}, tmp, name, rank)


def stop_body(rank, tmp, config_path, log_root):
    """SIGTERM reaches rank 1 alone at its third step: both ranks stop
    at the same step and the stop save's gather completes."""
    exp = Experiment(ExperimentArgs(config=config_path, train=True,
                                    device="cpu"), log_root=log_root)
    step = exp.trainer.train_step
    calls = []

    def counted(*a, **kw):
        calls.append(1)
        if rank == 1 and len(calls) == 3:
            os.kill(os.getpid(), signal.SIGTERM)
        return step(*a, **kw)

    exp.trainer.train_step = counted
    exp.train()
    _save({"it": exp.it, "calls": len(calls), "out_dir": exp.out_dir},
          tmp, "stop", rank)


def refusal_body(rank, tmp, cases):
    """Each case (name, config path, log root) must raise ValueError at
    construction; records the messages."""
    out = {}
    for name, path, log_root in cases:
        try:
            Experiment(ExperimentArgs(config=path, train=True, device="cpu"),
                       log_root=log_root)
        except ValueError as e:
            out[name] = str(e)
        else:
            out[name] = None
    _save(out, tmp, "refusals", rank)
