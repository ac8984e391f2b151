"""A closed loop of the program's training step (``Trainer.train_step``)
on host batches made at set-up.

The cell's ``traffic`` block: ``batch`` (samples a card), ``cycle`` (host
batches made at set-up and fed in turn; each runs once in set-up),
``check_steps`` (the first steps, which the reference follows) and
``profile_steps`` (the steps profiled after the window of a traced run).
A batch holds seeded uint8 images, angles in [0, 2 pi) and view counts
from the stratified multiset of the batch (``traffic/counts.py``)
shuffled by the seed, so every step runs the same number of packed rows.

End to end: ``train_samples_per_s``, the samples of the optimizer
updates made in the window over the window (the window ends when the
last update enqueued in it has run); ``setup_s``.

``correct``: set-up builds the one ``Trainer`` that the window drives and
runs its first ``check_steps`` updates through ``train_step`` on the
first batches of the cycle; the float32 reference follows them from the
same weights, batches and draws (the program's draw order: t, u, then
the noise, from one generator on the device seeded as the Trainer's).
Compared: each step's loss; each leaf's gradient norm at step 1, as
Adam's first moment gives it; each leaf's change over the checked steps.
A norm's gap is taken against the reference's norm of that leaf or of
the median leaf, whichever is larger; leaves whose reference gradient is
under a thousandth of the median leaf's are left out of the change.
"""

from __future__ import annotations

import gc
import time

import numpy as np

from bench_h100 import harness
from bench_h100 import trace as tracing
from bench_h100.reference import adam, diffusion, precision
from bench_h100.traffic import counts as count_rule


def make_batches(seed: int, n: int, b: int, max_views: int, size: int):
    rng = np.random.default_rng([seed % (2 ** 64), 5])
    out = []
    for _ in range(n):
        counts = count_rule.stratified_count_multiset(b, max_views)
        rng.shuffle(counts)
        si, vi = count_rule.packed_indices(counts)
        out.append({
            "target": rng.integers(0, 256, (b, size, size, 3), np.uint8),
            "cond": rng.integers(0, 256, (b, max_views, size, size, 3),
                                 np.uint8),
            "angle": rng.uniform(0, 2 * np.pi, b).astype(np.float32),
            "view_count": counts.astype(np.int32),
            "sample_idx": si, "view_idx": vi})
    return out


def leaf_gaps(prog: dict, ref: dict, keep=None) -> float:
    """The worst leaf's |prog norm - ref norm| / max(ref norm, median ref
    norm) over the leaves in ``keep`` (all where None)."""
    names = [k for k in ref if keep is None or k in keep]
    if not names:
        return float("inf")
    med = float(np.median([ref[k] for k in ref]))
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
               for k in names)


def reference_steps(cell, params, batches, gen_seed, steps, device,
                    prec=precision.FLOAT32, block: int = 20,
                    fault: str = ""):
    """The reference's first ``steps`` updates: (losses, first gradient
    norms, change norms) by leaf name.  ``fault`` plants one:
    ``half_batch``, each step's loss over the first half of its samples
    alone; ``no_exchange:<W>``, the update from the gradient of the first
    of W equal shares of the batch (rank 0's, with no all-reduce), the
    loss still the mean over all of them."""
    import torch

    precision.no_tf32()
    cfgj = cell.config
    mod = cell.reference()
    widths = cfgj["widths"]
    sched = diffusion.Schedule(**cfgj["schedule"])
    opt_cfg = cfgj["optimizer"]
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    p0 = {k: v.detach().clone() for k, v in params.items()}
    opt = adam.Adam(p)
    gen = torch.Generator(device=device).manual_seed(gen_seed)
    losses, grad_norms = [], None
    for s in range(steps):
        bt = batches[s]
        b = bt["target"].shape[0]
        y0 = torch.from_numpy(bt["target"]).to(device).float() / 255.0
        cond = torch.from_numpy(bt["cond"]).to(device).float() / 255.0
        counts = torch.from_numpy(bt["view_count"]).to(device).long()
        angle = torch.from_numpy(bt["angle"]).to(device).float()
        gammas, noise = diffusion.training_draws(sched, b, y0.shape[1:], gen,
                                                 device)
        for v in p.values():
            v.grad = None
        total = 0.0

        def denoiser(x, a, lv):
            return mod.forward(p, widths, x, a, lv, prec)

        used = b // 2 if fault == "half_batch" else b
        grad_to = (b // int(fault.split(":")[1])
                   if fault.startswith("no_exchange") else used)
        for lo in range(0, used, block):
            hi = min(used, lo + block)
            with torch.set_grad_enabled(lo < grad_to):
                loss = diffusion.packed_loss(
                    denoiser, y0[lo:hi], cond[lo:hi], counts[lo:hi],
                    angle[lo:hi], gammas[lo:hi], noise[lo:hi])
            if lo < grad_to:
                if hi > grad_to:
                    raise ValueError("the block must divide the shares")
                (loss * ((hi - lo) / grad_to)).backward()
            total += float(loss.detach()) * (hi - lo) / used
        losses.append(total)
        grads = {k: v.grad for k, v in p.items()}
        if s == 0:
            grad_norms = {k: float(g.norm()) for k, g in grads.items()}
        lr = adam.lr_at(s, opt_cfg["peak_lr"], opt_cfg["lr_warmup"],
                        opt_cfg["decay_rate"], opt_cfg["decay_it"])
        opt.update(grads, lr)
    change = {k: float((p[k].detach() - p0[k]).norm()) for k in p}
    return losses, grad_norms, change


def moving_leaves(ref_grad: dict) -> set:
    """Leaves whose reference gradient at step 1 is at least a thousandth
    of the median leaf's: the others move under Adam by round-off."""
    med = float(np.median(list(ref_grad.values())))
    return {k for k, v in ref_grad.items() if v >= 1e-3 * med}


def gaps(side, ref):
    """(loss gap, gradient norm gap, change norm gap) of ``side`` against
    ``ref``, each a (losses, grad norms, change norms) triple."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(side[0], ref[0]))
    return (loss_gap, leaf_gaps(side[1], ref[1]),
            leaf_gaps(side[2], ref[2], moving_leaves(ref[1])))


def local_batch(batch: dict, rank: int, b: int) -> dict:
    """Rank ``rank``'s samples [rank * b, (rank + 1) * b) of a global
    batch, with the packed row indices of those samples."""
    out = {k: batch[k][rank * b:(rank + 1) * b]
           for k in ("target", "cond", "angle", "view_count")}
    out["sample_idx"], out["view_idx"] = count_rule.packed_indices(
        out["view_count"])
    return out


class Program:
    """The program's Trainer, its first updates read as the check needs
    them, and the host batches of the cycle.  Under a process group of
    ``world`` ranks each rank feeds its ``batch`` samples of the global
    batch of ``batch * world``."""

    def __init__(self, cell, seed: int, device: str, world: int = 1,
                 rank: int = 0):
        from viewfusion_tpu_torch.config import Config, parse_yaml
        from viewfusion_tpu_torch.training.trainer import Trainer

        tr = cell.workload["traffic"]
        cfgj = cell.config
        b = int(tr["batch"])
        self.widths = widths = cfgj["widths"]
        raw = parse_yaml(cell.yaml_path.read_text())
        raw["data"]["params"]["batch_size"] = b * world
        config = Config.from_dict(raw)
        harness.check_widths(config, widths, cell.yaml_path)
        if not config.train.packed_views:
            raise ValueError("the training driver feeds packed batches")
        self.params = harness.make_params(
            cell.reference().param_specs(widths), harness.sub_seed(seed, 2),
            device)
        self.gen_seed = harness.sub_seed(seed, 4)
        self.trainer = Trainer(config, device=device,
                               state_dict=self.params, seed=self.gen_seed)
        self.global_batches = make_batches(
            seed, int(tr["cycle"]), b * world, cfgj["max_views"],
            widths["image_size"])
        self.batches = [local_batch(g, rank, b) if world > 1 else g
                        for g in self.global_batches]
        self.rows = int(self.global_batches[0]["view_count"].sum())
        self.device = device

    def first_steps(self, n_check: int):
        """Run every batch of the cycle once; returns the first
        ``n_check`` losses, the leaves' gradient norms at step 1 (Adam's
        first moment / (1 - b1)) and their change over ``n_check``
        steps, as this rank holds them."""
        import torch

        t = self.trainer
        named = list(t.model.unet.named_parameters())
        p0 = {k: v.detach().clone() for k, v in named}
        losses, grad_norms, change = [], None, None
        for i, batch in enumerate(self.batches):
            loss = t.train_step(batch)
            if i < n_check:
                losses.append(loss)
            if i == 0:   # Adam's first moment after one step is 0.1 g
                st = t.optimizer.state
                grad_norms = {k: (st[v]["exp_avg"] / 0.1).norm()
                              if v in st else torch.zeros(())
                              for k, v in named}
            if i == n_check - 1:
                change = {k: (v.detach() - p0[k]).norm() for k, v in named}
        if self.device != "cpu":
            torch.cuda.synchronize()
        del p0
        return ([float(x) for x in losses],
                {k: float(v) for k, v in grad_norms.items()},
                {k: float(v) for k, v in change.items()})

    def step(self, i: int):
        return self.trainer.train_step(self.batches[i % len(self.batches)])

    def local_rows(self, i: int) -> int:
        return int(self.batches[i % len(self.batches)]["view_count"].sum())


def _agree_to_stop(host_group, over: bool) -> bool:
    """True where any rank's window is over (a host-side all-reduce over
    the gloo group of all ranks; the device's queue is not drained)."""
    import torch
    import torch.distributed as dist

    flag = torch.tensor([1 if over else 0])
    dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=host_group)
    return bool(flag.item())


def run(cell, seed: int, seconds: float, trace: int, device: str,
        t0: float) -> harness.Outcome:
    import os

    import torch

    tr = cell.workload["traffic"]
    n_check = int(tr["check_steps"])
    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = 0
    if world > 1:
        import torch.distributed as dist

        from viewfusion_tpu_torch.parallel.mesh import initialize_distributed

        device = str(initialize_distributed(device))
        rank = dist.get_rank()
    prog = Program(cell, seed, device, world, rank)
    host_group = prog.trainer.mesh.host_group if world > 1 else None
    losses, grad_norms, change = prog.first_steps(n_check)
    on_card = device != "cpu"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    sync()
    if world > 1:
        dist.barrier()
    start = time.perf_counter()
    setup_s = time.monotonic() - t0
    steps = 0
    while True:
        prog.step(steps)
        steps += 1
        over = time.perf_counter() - start >= seconds
        if host_group is None:
            if over:
                break
        elif steps % 4 == 0 and _agree_to_stop(host_group, over):
            break
    sync()
    if world > 1:
        dist.barrier()
    elapsed = time.perf_counter() - start
    b = int(tr["batch"])
    e2e = {"train_samples_per_s": steps * b * world / elapsed,
           "setup_s": setup_s}
    record = {"kind": "train", "widths": cell.config["widths"],
              "denoiser": cell.config["denoiser"], "rows": prog.rows,
              "chips": world,
              "dtype": cell.config["compute_dtype"],
              "window_steps": steps, "window_elapsed_s": elapsed}
    outcome_extra = {}
    if trace and on_card:
        n = int(tr["profile_steps"])
        prof = tracing.Profiled() if rank == 0 else None
        if prof:
            prof.start()
        for i in range(n):
            prog.step(steps + i)
        if prof:
            prof.stop()
            record.update(device_ops=prof.device, busy_s=tracing.busy_s(
                prof.device), profile_steps=n,
                rank_rows=sum(prog.local_rows(steps + i) for i in range(n))
                / n)
            outcome_extra = dict(
                busy_s=record["busy_s"], window_s=prof.window_s,
                breakdown={"device_ops": tracing.device_ops(prof.device),
                           "idle_gaps": tracing.idle_gaps(prof.device,
                                                          prof.host)})
        sync()
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    params, batches, gen_seed = prog.params, prog.global_batches, prog.gen_seed
    del prog
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    ranks_read = [(grad_norms, change, memory_peak)]
    if world > 1:
        gathered = [None] * world
        dist.all_gather_object(gathered, ranks_read[0], group=host_group)
        ranks_read = gathered
        if rank != 0:
            dist.barrier()
            return None
        memory_peak = max(m for _, _, m in ranks_read)

    ref = reference_steps(cell, params, batches, gen_seed, n_check, device)
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, ref[0]))
    grad_gap = max(gaps((losses, g, c), ref)[1] for g, c, _ in ranks_read)
    change_gap = max(gaps((losses, g, c), ref)[2] for g, c, _ in ranks_read)
    moving = moving_leaves(ref[1])
    # the cell's limits name the numbers compared (PERF.md says why a
    # number without a limit is read and not compared)
    lim = cell.workload["limits"]
    read = {"loss_gap": loss_gap, "grad_norm_gap": grad_gap,
            "change_norm_gap": change_gap}
    checks = [(k, read[k], lim[k]) for k in read if k in lim]
    correct = all(v <= limit for _, v, limit in checks)
    notes = [f"steps in the window {steps} in {elapsed:.3f} s, rows a step "
             f"{record['rows']} over {world} rank(s), losses {losses} "
             f"against {ref[0]}, leaves {len(ref[1])} / moving "
             f"{len(moving)}"] + [f"read, not compared: {k} = {v!r}"
                                  for k, v in read.items() if k not in lim]
    if world > 1:
        dist.barrier()
    return harness.Outcome(
        correct=correct, attempted=steps, failed=0, end_to_end=e2e,
        record=record, checks=checks, memory_peak_bytes=memory_peak,
        notes=notes, **outcome_extra)
