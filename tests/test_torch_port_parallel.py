"""More than one process in the port (``viewfusion_tpu_torch/parallel``,
the multi-process ``Trainer``) against the JAX package, on the CPU.

The ranks are started with ``torch.multiprocessing.spawn`` over gloo
(``tests/_torch_port_ranks.py``; no JAX in them).  The JAX side is one
process: its layout rules on the 8-device CPU mesh of
``tests/conftest.py``, and its plain step at the global batch.  Every
comparison with JAX feeds the port JAX's own draws (``noise=`` and
``sample_gammas=``, each rank its rows).

Tolerances (tests/test_torch_port_train.py's, and why):
  * the first step's loss <= 1e-6 relative and every gradient <= 1e-4
    of the largest (f32; the ranks sum their rows' gradients in another
    order, and DDP averages them);
  * the 3-step loss trajectory <= 1e-5 relative, parameters within the
    learning rate (Adam scales rounding-noise gradients to +-lr);
  * the ranks hold equal parameters after every update, bit for bit;
  * ZeRO-1 against the replicated optimizer at the same world size:
    parameters and whole moments <= 1e-6 of their scale (Adam is
    elementwise: only the slicing differs);
  * W ranks drawing from the Trainer's generator against one process
    drawing from it: losses <= 1e-6 relative, gradients <= 1e-6 of the
    largest and parameters <= 1e-6 of the largest parameter (summation
    order only; at lr 1e-6 Adam's +-lr steps on rounding-noise
    gradients, measured 2.2e-7 on the logit channels' output bias, stay
    below that bound).
"""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from tests import _torch_port_ranks as ranks
from tests.conftest import TINY_CONFIG
from tests.test_dit import CFG as DIT_CFG
from tests.test_torch_port_dit import _perturbed, _raw as _dit_raw
from tests.test_torch_port_train import _batch, _jax_draws, _raw, jax_setup
from viewfusion_tpu.config import Config as JaxConfig
from viewfusion_tpu.data.synthetic import make_synthetic_shards
from viewfusion_tpu.models.dit import DiT as JaxDiT
from viewfusion_tpu.models.view_fusion import ViewFusion as JaxViewFusion
from viewfusion_tpu.parallel import collectives as jax_collectives
from viewfusion_tpu.parallel import mesh as jax_mesh
from viewfusion_tpu.training.trainer import Experiment as JaxExperiment
from viewfusion_tpu.training.trainer import ExperimentArgs as JaxArgs
from viewfusion_tpu_torch.config import Config, dump_yaml
from viewfusion_tpu_torch.parallel.mesh import (MeshSpec, RankGrid,
                                                batch_spec, make_mesh,
                                                shard_batch, zero1_split_dim)
from viewfusion_tpu_torch.parallel.zero1 import Zero1Adam
from viewfusion_tpu_torch.training.checkpoint import Checkpoint
from viewfusion_tpu_torch.training.trainer import Trainer
from viewfusion_tpu_torch.utils.convert import (jax_layout_axes,
                                                load_trainer_state,
                                                unet_params_to_jax,
                                                unet_state_dict_from_jax)

torch.set_num_threads(2)
GB, N, HW = 8, 3, 8     # the global batch, max_views, image size
STEPS = 3
FIELDS = ["params", "opt_state", "step", "ema_params"]


# ---------------------------------------------------------------------
# layout rules against viewfusion_tpu.parallel.mesh
# ---------------------------------------------------------------------
def _host_batch(rng, accum):
    lead = (2,) if accum else ()
    return {
        "target": rng.normal(size=lead + (GB, HW, HW, 3)).astype(np.float32),
        "cond": rng.normal(size=lead + (GB, 4, HW, HW, 3)).astype(np.float32),
        "angle": rng.normal(size=lead + (GB,)).astype(np.float32),
        "view_count": rng.integers(1, 4, lead + (GB,)).astype(np.int32),
        "noise": rng.normal(size=lead + (GB, HW, HW, 3)).astype(np.float32),
        "sample_idx": rng.integers(0, GB, lead + (13,)).astype(np.int32),
        "view_idx": rng.integers(0, 3, lead + (13,)).astype(np.int32),
        "img": rng.integers(0, 255, lead + (GB, 5, HW, HW, 3)).astype(
            np.uint8),
        "meta_b": rng.integers(0, 9, lead + (GB, 2)).astype(np.int32),
        "meta_r": rng.integers(0, 9, lead + (2, 13)).astype(np.int32),
    }


@pytest.mark.parametrize("accum", [False, True])
@pytest.mark.parametrize("data,view", [(2, 1), (4, 1), (2, 2), (4, 2)])
def test_rank_rows_match_the_jax_batch_layout(data, view, accum):
    """Each rank's rows of every batch key are the rows JAX's
    ``shard_batch`` puts on the device at the rank's place in the mesh;
    ``cond``'s view axis, which JAX splits over ``view``, stays whole
    (the port splits the UNet rows instead), so the view group's JAX
    shards make up the rank's."""
    batch = _host_batch(np.random.default_rng(data * 10 + view), accum)
    mesh = jax_mesh.make_mesh(jax_mesh.MeshSpec(data=data, view=view),
                              devices=jax.devices()[:data * view])
    placed = jax_mesh.shard_batch(batch, mesh, accum=accum)
    for rank in range(data * view):
        grid = RankGrid(data=data, view=view, rank=rank)
        mine = shard_batch(batch, grid, accum=accum)
        dev = mesh.devices[grid.data_rank, grid.view_rank]
        for key, arr in placed.items():
            index = next(s.index for s in arr.addressable_shards
                         if s.device == dev)
            spec = jax_mesh.batch_sharding(mesh, key, accum).spec
            assert len(batch_spec(key, accum)) <= len(batch[key].shape)
            index = tuple(slice(None) if ax < len(spec)
                          and spec[ax] == jax_mesh.VIEW_AXIS else sl
                          for ax, sl in enumerate(index))
            np.testing.assert_array_equal(mine[key], batch[key][index],
                                          err_msg=f"{key} rank {rank}")


def test_zero1_split_matches_zero1_shard_specs(jax_setup):
    """Each rank's slice of every UNet parameter holds exactly the
    elements of its device's shard under ``zero1_shard_specs`` (4-way
    data mesh), and the rule itself agrees on every JAX leaf shape."""
    jcfg, _, params, _ = jax_setup
    sd = unet_state_dict_from_jax(params)
    # unique values, so a slice names its elements
    sd = {k: torch.arange(v.numel(), dtype=torch.float32).reshape(v.shape)
          + 1e6 * i for i, (k, v) in enumerate(sorted(sd.items()))}
    jtree = unet_params_to_jax(sd)
    data = 4
    mesh = jax_mesh.make_mesh(jax_mesh.MeshSpec(data=data, view=1),
                              devices=jax.devices()[:data])
    specs = jax_mesh.zero1_shard_specs(jtree, mesh)
    for leaf, spec in zip(jax.tree_util.tree_leaves(jtree),
                          jax.tree_util.tree_leaves(
                              specs, is_leaf=lambda x: isinstance(
                                  x, NamedSharding))):
        dim = zero1_split_dim(leaf.shape, data)
        split = [ax for ax, s in enumerate(spec.spec) if s is not None]
        assert split == ([] if dim is None else [dim])
    placed = jax.tree_util.tree_leaves(jax.device_put(jtree, specs))
    shards = {float(np.asarray(a).min()): a for a in placed}
    params_t = {k: torch.nn.Parameter(v.clone()) for k, v in sd.items()}
    axes = jax_layout_axes(list(params_t))
    for rank in range(data):
        opt = Zero1Adam(list(params_t.items()), axes,
                        RankGrid(data=data, view=1, rank=rank))
        for name, p, dim, view in opt.leaves:
            arr = shards[float(p.detach().min())]
            dev = mesh.devices[rank, 0]
            want = np.asarray(next(s.data for s in arr.addressable_shards
                                   if s.device == dev))
            assert np.array_equal(np.sort(view.numpy().ravel()),
                                  np.sort(want.ravel())), name


def test_mesh_that_does_not_fit_the_world_raises():
    with pytest.raises(ValueError, match=r"mesh 2x1 .* != 1 processes"):
        make_mesh(MeshSpec(data=2, view=1))
    with pytest.raises(ValueError, match=r"mesh 0x2 .* != 1 processes"):
        make_mesh(MeshSpec(data=-1, view=2))
    raw = _raw(mesh_view=2)
    with pytest.raises(ValueError, match="1 processes"):
        Trainer(Config.from_dict(raw), device="cpu")


def test_collectives_match_jax_at_two_ranks(runs):
    """reduce_dict (mean, sum; sorted keys), gather_all and the autograd
    all_gather at W = 2 against JAX's on the same per-rank values;
    psum_dict sums over the group."""
    got = runs["collectives"]
    assert [float(g["psum"]) for g in got] == [3.0, 3.0]
    mesh = jax_mesh.make_mesh(jax_mesh.MeshSpec(data=2, view=1),
                              devices=jax.devices()[:2])
    per_rank = {"b": np.stack([[r + 1.0, 2.0 * r] for r in range(2)]),
                "a": np.stack([10.0 * (r + 1) for r in range(2)])}
    placed = jax_mesh.shard_batch(
        {k: v.astype(np.float32) for k, v in per_rank.items()}, mesh)
    for average, key in ((True, "mean"), (False, "total")):
        want = jax_collectives.reduce_dict(placed, average=average)
        for g in got:
            assert list(g[key]) == sorted(want)
            for k in want:
                np.testing.assert_allclose(g[key][k].numpy(),
                                           np.asarray(want[k]), rtol=1e-7)
    x = jax.device_put(np.stack([np.arange(3.0) + 10 * r for r in range(2)])
                       .astype(np.float32), NamedSharding(
                           mesh, jax.sharding.PartitionSpec("data")))
    want = [np.asarray(a).reshape(-1) for a in jax_collectives.gather_all(x)]
    for g in got:
        for a, w in zip(g["gathered"], want):
            np.testing.assert_array_equal(a.numpy(), w)
    # autograd all_gather: rows of rank r are r + 1; the gradient of a
    # rank's rows sums every rank's weights (r + 1) * row number
    weights = np.arange(1.0, 5.0)
    for r, g in enumerate(got):
        np.testing.assert_array_equal(
            g["y"].numpy(), np.repeat([1.0, 1.0, 2.0, 2.0], 3).reshape(4, 3))
        np.testing.assert_array_equal(
            g["grad"].numpy(),
            np.repeat(3.0 * weights[2 * r:2 * r + 2], 3).reshape(2, 3))


# ---------------------------------------------------------------------
# train steps at W ranks against JAX's one-process step
# ---------------------------------------------------------------------
W2 = {"packed": {}, "accum": {"grad_accum": 2}, "zero1":
      {"shard_opt_state": True}, "dit": {}, "generator": {"peak_lr": 1e-6}}
W4 = {"packed": {}, "view2": {"mesh_view": 2, "shard_opt_state": True},
      "zero1": {"shard_opt_state": True}}


def _global_step_batch(step, accum):
    """The global batch of a step; under ``accum`` two microbatches of
    GB (JAX then compiles one loss shape for every case)."""
    if not accum:
        return _batch(100 + step, salt=step, b=GB)
    micro = [_batch(200 + 2 * step + k, salt=2 * step + k, b=GB)
             for k in range(2)]
    return {k: [m[k] for m in micro] if k in ("sample_idx", "view_idx")
            else np.stack([m[k] for m in micro]) for k in micro[0]}


@pytest.fixture(scope="module")
def dit_setup():
    raw = _dit_raw()
    model = JaxViewFusion.from_config(JaxConfig.from_dict(raw))
    p = jax.jit(JaxDiT(config=DIT_CFG).init)(
        jax.random.PRNGKey(0), np.zeros((1, HW, HW, 6), np.float32),
        np.zeros(1, np.float32), np.ones(1, np.float32))
    return raw, model, _perturbed(p, 0)


def _jax_reference(loss_grad, model, params, steps, update, init, accum):
    """JAX's one-process steps at the global batch: per step the loss,
    the gradients and the parameters after optax + EMA; and the port's
    draws (each microbatch's) for every step."""
    p, opt, ema = params, init(params), params
    out = {"loss": [], "grads": [], "params": [], "draws": []}
    for i, batch in enumerate(steps):
        micro = ([{k: v[m] for k, v in batch.items()} for m in range(2)]
                 if accum else [batch])
        losses, grads, draws = [], [], []
        for m, mb in enumerate(micro):
            key = jax.random.PRNGKey(500 + 10 * i + m)
            loss, g = loss_grad(p, key, mb)
            gammas, noise = _jax_draws(model, key, b=len(mb["angle"]))
            losses.append(float(loss))
            grads.append(g)
            draws.append((noise, gammas))
        g = jax.tree_util.tree_map(lambda *a: sum(a) / len(a), *grads)
        p, opt, ema = update(p, opt, ema, g)
        out["loss"].append(float(np.mean(losses)))
        out["grads"].append(jax.tree_util.tree_map(np.asarray, g))
        out["params"].append(jax.tree_util.tree_map(np.asarray, p))
        out["draws"].append(
            (np.stack([d[0] for d in draws]), np.stack([d[1] for d in draws]))
            if accum else draws[0])
    return out


def _optax(raw):
    import optax

    from viewfusion_tpu.training.schedulers import lr_schedule as jax_lr
    t = JaxConfig.from_dict(raw).train
    tx = optax.adam(jax_lr(peak_lr=t.peak_lr, peak_it=t.lr_warmup,
                           decay_rate=t.decay_rate, decay_it=t.decay_it),
                    b1=0.9, b2=0.999, eps=1e-8)

    def update(params, opt, ema, grads):
        upd, opt = tx.update(grads, opt, params)
        params = optax.apply_updates(params, upd)
        ema = jax.tree_util.tree_map(
            lambda e, q: t.ema_decay * e + (1.0 - t.ema_decay) * q, ema,
            params)
        return params, opt, ema

    return tx.init, jax.jit(update)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, jax_setup, dit_setup):
    """JAX's references, then one spawn of 2 ranks and one of 4 over all
    their cases; returns {(world, case): (reference, [rank records])}."""
    _, unet_model, unet_params, _ = jax_setup
    tmp = str(tmp_path_factory.mktemp("ranks"))
    refs, out, jitted = {}, {}, {}

    def loss_grad(model):
        if id(model) not in jitted:
            jitted[id(model)] = jax.jit(lambda p, key, b: jax.value_and_grad(
                lambda q: model.loss_packed(
                    q, key, b["target"], b["cond"], b["view_count"],
                    b["angle"], b["sample_idx"], b["view_idx"]))(p))
        return jitted[id(model)]

    for world, cases in ((2, W2), (4, W4)):
        specs = []
        for case, tpu in cases.items():
            if case == "dit":
                raw, model, params = dit_setup
                raw = copy.deepcopy(raw)
            else:
                raw, model, params = _raw(**tpu), unet_model, unet_params
            accum = raw["tpu"].get("grad_accum", 1) > 1
            raw["data"]["params"]["batch_size"] = GB * (2 if accum else 1)
            steps = [_global_step_batch(i, accum) for i in range(STEPS)]
            # the knobs of the mesh and ZeRO-1 do not change JAX's step
            kind = case if case in ("dit", "accum", "generator") else "unet"
            if kind not in refs and kind != "generator":
                init, update = _optax(raw)
                refs[kind] = _jax_reference(loss_grad(model), model, params,
                                            steps, update, init, accum)
            ref = refs.get(kind)
            sd = {k: v.numpy() for k, v in
                  unet_state_dict_from_jax(params).items()}
            draws = ([None] * STEPS if case == "generator"
                     else ref["draws"])
            specs.append((case, raw, sd, list(zip(steps, draws))))
            out[(world, case)] = [ref, None, raw, sd, steps]
        calls = [(ranks.train_body, (specs,))]
        if world == 2:
            calls.append((ranks.collectives_body, ()))
        ranks.spawn(ranks.sequence_body, world, tmp, calls)
        for case in cases:
            out[(world, case)][1] = [ranks.load(tmp, case, r)
                                     for r in range(world)]
    out["collectives"] = [ranks.load(tmp, "coll", r) for r in range(2)]
    return out


def _tree(named):
    return unet_params_to_jax(named)


def _max_err(a, b):
    return max(float(np.abs(np.asarray(x) - np.asarray(y)).max())
               for x, y in zip(jax.tree_util.tree_leaves(a),
                               jax.tree_util.tree_leaves(b)))


def _max_abs(a):
    return max(float(np.abs(np.asarray(x)).max())
               for x in jax.tree_util.tree_leaves(a))


@pytest.mark.parametrize("world,case", [
    (2, "packed"), (2, "accum"), (2, "zero1"), (2, "dit"), (4, "packed"),
    (4, "view2"), (4, "zero1")])
def test_rank_steps_match_the_jax_step_at_the_global_batch(runs, world,
                                                           case):
    ref, recs, raw, _, _ = runs[(world, case)]
    tpu = {**W2, **W4}[case]
    data = world // tpu.get("mesh_view", 1)
    assert [r["mesh"][:2] for r in recs] == [(data, world // data)] * world
    rec = recs[0]
    want = ref["loss"]
    assert abs(rec["loss"][0] - want[0]) <= 1e-6 * abs(want[0])
    for got, w in zip(rec["loss"], want):
        assert abs(got - w) <= 1e-5 * abs(w)
    grads = _tree(rec["grads"][0])
    assert _max_err(grads, ref["grads"][0]) <= 1e-4 * _max_abs(
        ref["grads"][0])
    assert _max_err(_tree(rec["params"][-1]), ref["params"][-1]) \
        <= raw["tpu"]["peak_lr"]
    for other in recs[1:]:  # every rank holds the same model
        assert other["loss"] == rec["loss"]
        for a, b in zip(rec["params"], other["params"]):
            assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("world", [2, 4])
def test_zero1_update_equals_the_replicated_one(runs, world):
    """ZeRO-1 at W ranks against Adam replicated at the same W: the same
    parameters after every update and the same whole moments; each rank
    holds its share of m and v as zero1_shard_specs splits them."""
    _, zero, _, sd, _ = runs[(world, "zero1")]
    _, full, _, _, _ = runs[(world, "packed")]
    for z, f in zip(zero[0]["params"], full[0]["params"]):
        for k in f:
            scale = float(f[k].abs().max()) or 1.0
            assert float((z[k] - f[k]).abs().max()) <= 1e-6 * scale, k
    for zm, fm in zip(zero[0]["adam"], full[0]["adam"]):
        for k in fm:
            scale = float(fm[k].abs().max()) or 1.0
            assert float((zm[k] - fm[k]).abs().max()) <= 1e-6 * scale, k
    # bytes of m and v per rank: each leaf's share under the JAX rule
    axes = jax_layout_axes(list(sd))
    want = 0
    for name, a in sd.items():
        shape = [a.shape[i] for i in (axes[name] or range(a.ndim))]
        split = zero1_split_dim(shape, world) is not None
        want += 2 * 4 * a.size // (world if split else 1)
    assert [r["moment_bytes"] for r in zero] == [want] * world
    assert full[0]["moment_bytes"] == 2 * 4 * sum(a.size for a in sd.values())
    assert want < full[0]["moment_bytes"] / world * 1.25


def test_ranks_drawing_from_the_generator_match_one_process(runs):
    """W = 2 ranks drawing t, u and the noise from the Trainer's generator
    (the global batch's draws, each its rows) against one process at the
    global batch with the same seed."""
    _, recs, raw, sd, steps = runs[(2, "generator")]
    one = Trainer(Config.from_dict(raw), device="cpu", state_dict={
        k: torch.from_numpy(v) for k, v in sd.items()})
    named = list(one.model.unet.named_parameters())
    for i, batch in enumerate(steps):
        loss = one.train_step(batch).item()
        assert abs(recs[0]["loss"][i] - loss) <= 1e-6 * abs(loss)
        gscale = max(float(p.grad.abs().max()) for _, p in named)
        scale = max(float(p.detach().abs().max()) for _, p in named)
        for name, p in named:
            assert float((recs[0]["grads"][i][name] - p.grad).abs().max()) \
                <= 1e-6 * gscale, name
            assert float((recs[0]["params"][i][name] - p.detach()).abs()
                         .max()) <= 1e-6 * scale, name


# ---------------------------------------------------------------------
# the two-rank Experiment: ZeRO-1, async checkpoints, evals, resume
# ---------------------------------------------------------------------
def _exp_raw(data_dir, **tpu):
    raw = copy.deepcopy(TINY_CONFIG)
    for split in ("train", "test"):
        raw["data"]["params"][split]["params"].update(
            path=data_dir, end_shard=1)
    raw["data"]["params"]["test"]["params"]["size"] = 4
    raw["data"]["params"]["batch_size"] = 4
    raw["model"].update(max_it=4, checkpoint_every=2, log_every=1,
                        validate_every=2, validate_from=2)
    raw["tpu"].update({"packed_views": True, "ema_decay": 0.9,
                       "lr_warmup": 1, "native_loader": False,
                       "shard_opt_state": True, "async_checkpoint": True,
                       **tpu})
    return raw


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """Two shards per split, so that two data ranks each read one."""
    d = str(tmp_path_factory.mktemp("data2"))
    for mode in ("train", "test"):
        make_synthetic_shards(d, mode, num_objects=8, num_shards=2,
                              image_size=8)
    return d


def _write(tmp, name, raw):
    path = os.path.join(tmp, f"{name}.yaml")
    with open(path, "w") as f:
        f.write(dump_yaml(raw))
    return path


@pytest.fixture(scope="module")
def two_rank_run(tmp_path_factory, data_dir):
    """One spawn of two ranks: the refusals, the ZeRO-1 run with its
    resume, and the SIGTERM run (each in a log root of its own)."""
    tmp = str(tmp_path_factory.mktemp("exp2"))
    root = os.path.join(tmp, "logs")
    bad_batch = _exp_raw(data_dir)
    bad_batch["data"]["params"]["batch_size"] = 3
    refusals = [
        ("exact", _write(tmp, "e", _exp_raw(data_dir,
                                            eval_exact_epoch=True))),
        ("mesh", _write(tmp, "m", _exp_raw(data_dir, mesh_data=4))),
        ("batch", _write(tmp, "b", bad_batch))]
    stop = _exp_raw(data_dir)
    stop["model"].update(max_it=50, validate_every=0, checkpoint_every=0)
    ranks.spawn(ranks.sequence_body, 2, tmp, [
        (ranks.refusal_body, ([(n, p, os.path.join(tmp, "bad"))
                               for n, p in refusals],)),
        (ranks.experiment_body, (_write(tmp, "z", _exp_raw(data_dir)),
                                 root)),
        (ranks.stop_body, (_write(tmp, "s", stop),
                           os.path.join(tmp, "stop")))])
    return {name: [ranks.load(tmp, name, r) for r in range(2)]
            for name in ("exp", "stop", "refusals")}, root


def test_two_rank_experiment_shares_one_run_dir(two_rank_run):
    recs, root = two_rank_run[0]["exp"], two_rank_run[1]
    assert recs[0]["out_dir"] == recs[1]["out_dir"]
    assert os.listdir(root) == [os.path.basename(recs[0]["out_dir"])]
    assert [r["mesh"] for r in recs] == [(2, 1)] * 2
    assert [r["local_batch"] for r in recs] == [2, 2]
    run = recs[0]["out_dir"]
    records = [json.loads(line) for line in open(
        os.path.join(run, "metrics.jsonl"))]
    losses = [r["it"] for r in records if "loss" in r]
    # rank 0 alone logs, one line per step (it 5: the resumed run's)
    assert losses == [0, 1, 2, 3, 4, 5]
    evals = [r["it"] for r in records if "ssim" in r]
    assert evals == [2, 4]
    for name in ("model.msgpack", "best_model_ssim.msgpack",
                 "best_model_psnr.msgpack", "output-2.png", "config.yaml"):
        assert os.path.exists(os.path.join(run, name)), name
    # both ranks held the same model; rank r held half of m and v
    held = [r["held"] for r in recs]
    for k in held[0]["params"]:
        assert torch.equal(held[0]["params"][k], held[1]["params"][k])
    assert recs[0]["moment_bytes"] < sum(
        2 * v.numel() * 4 for v in held[0]["params"].values()) * 0.6


def test_two_rank_checkpoint_loads_in_one_process_and_in_jax(
        two_rank_run, data_dir, tmp_path):
    """model.msgpack of the ZeRO-1 ranks holds the whole Adam tree: one
    port process loads the parameters and moments the ranks held, the
    ranks resumed to them and trained on, and a JAX Experiment resumes
    it into its ZeRO-1 layout."""
    recs = two_rank_run[0]["exp"]
    run = recs[0]["out_dir"]
    held = recs[0]["held"]
    for rec in recs:  # each rank resumed to the state the ranks held
        for key in ("params", "mu", "nu"):
            for k, v in held[key].items():
                assert torch.equal(rec["loaded"][key][k], v), (key, k)
        assert rec["loaded"]["step"] == held["step"] == 5
        assert (rec["resumed_it"], rec["resumed_step"]) == (5, 6)
    # the resumed run's step 5 was saved after the state above was read
    state, extra = Checkpoint(run).load("model.msgpack",
                                        dict.fromkeys(FIELDS))
    assert extra["it"] == 5
    cfg = Config.from_dict(_exp_raw(data_dir))
    one = Trainer(cfg, device="cpu")
    load_trainer_state(one, state)
    assert one.step == 6 and one.zero1 is not None
    # a JAX ZeRO-1 Experiment resumes the port's run dir
    jexp = JaxExperiment(JaxArgs(src=run, resume=True))
    assert jexp.config.train.shard_opt_state
    jstate = jax.tree_util.tree_map(np.asarray, jexp.state)
    mu, nu = one.adam_moments()
    named = dict(one.model.unet.named_parameters())
    for got, want in ((jstate.params, named), (jstate.opt_state[0].mu, mu),
                      (jstate.opt_state[0].nu, nu)):
        want = unet_params_to_jax({k: v.detach() for k, v in want.items()})
        for a, b in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(want)):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    assert int(jstate.step) == 6
    assert any(any(s is not None for s in leaf.sharding.spec)
               for leaf in jax.tree_util.tree_leaves(jexp.state.opt_state)
               if hasattr(leaf, "sharding") and leaf.ndim > 0)


def test_two_ranks_stop_together_on_one_sigterm(two_rank_run):
    """SIGTERM reaches one rank: both stop at the same step, and the stop
    save (a ZeRO-1 gather) completes with it = 2 (three updates)."""
    recs = two_rank_run[0]["stop"]
    assert [(r["it"], r["calls"]) for r in recs] == [(3, 3), (3, 3)]
    state, extra = Checkpoint(recs[0]["out_dir"]).load(
        "model.msgpack", dict.fromkeys(FIELDS))
    assert extra["it"] == 2 and int(state["step"]) == 3


def test_refusals_at_two_ranks(two_rank_run):
    """eval_exact_epoch with data > 1 raises JAX's message; a mesh that
    does not fit two ranks and a batch that does not split over the data
    ranks raise with their numbers."""
    for got in two_rank_run[0]["refusals"]:
        assert "eval_exact_epoch requires a single process" in got["exact"]
        assert "mesh 4x1" in got["mesh"] and "2 processes" in got["mesh"]
        assert "batch of 3 rows" in got["batch"] and "data=2" in got["batch"]
