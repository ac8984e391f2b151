"""The port's ADM denoiser (``viewfusion_tpu_torch/models/adm.py``) and
the per-sample affine of GroupNorm (AdaGN) against plain float32
references, on the CPU; a few tests need a card (marked ``cuda``).

The JAX package has no ADM, so the reference is ``tests/adm_reference.py``
(plain PyTorch written from ``guided_diffusion/unet.py``).  Weights are
seeded for every parameter, ADM's zero-initialised layers included
(a fresh ADM's residual branches and output are zero, so a test on fresh
weights proves little).  The ADM is tiny: 16 px, channels 32 x (1, 2),
one ResBlock a level, attention at 8 px with heads of 16, up/down
ResBlocks.  The file imports no JAX, so its card tests run with
``python -m pytest --noconftest -m cuda tests/test_torch_port_adm.py``.

Tolerances and why:
  * f32 forward: <= 1e-5 of the output's scale (the same f32 arithmetic
    in another order: the port fuses the AdaGN scale-shift into the
    GroupNorm's affine and takes the variance as E[x^2] - mean^2;
    measured ~1e-6);
  * f32 loss within 1e-5 relative, every parameter gradient within 1e-4
    of the largest gradient (the backward adds the same terms in another
    order through ~30 layers; measured ~1e-6);
  * the GroupNorm plain versions against a by-hand GN(x) (1 + s) + t:
    1e-5 (f32, one fold of the affine);
  * on the card: K1/K2 in bf16 within one bf16 ulp of the output's scale
    and the per-sample partials within 1e-3 relative (f32 sums over the
    rows in another order); a train step's loss within 2e-2 relative
    and its gradient norm within 5% of the f32 reference (bf16 convs).
"""

import importlib.util
import math
import pathlib

import numpy as np
import pytest
import torch

from viewfusion_tpu_torch import tracing
from viewfusion_tpu_torch.config import ADMConfig, Config, load_config
from viewfusion_tpu_torch.models.adm import ADM
from viewfusion_tpu_torch.models.view_fusion import ViewFusion
from viewfusion_tpu_torch.ops.groupnorm import (
    group_norm_act, group_norm_act_backward,
    group_norm_act_backward_reference, group_norm_act_reference)
from viewfusion_tpu_torch.training.trainer import (Trainer, packed_indices,
                                                   stratified_count_multiset)

REPO = pathlib.Path(__file__).resolve().parents[1]
# by path: on a machine without this repo's conftest another package may
# answer to ``tests``
_SPEC = importlib.util.spec_from_file_location(
    "adm_reference", REPO / "tests" / "adm_reference.py")
ref = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(ref)
YAML = REPO / "viewfusion_tpu_torch" / "configs" / "adm-imagenet-64.yaml"
TINY = {"image_size": 16, "in_channel": 6, "out_channel": 6,
        "model_channels": 32, "channel_mult": [1, 2], "num_res_blocks": 1,
        "attention_resolutions": [8], "num_head_channels": 16}


def _raw(dtype="float32", dropout=0.0, remat=False):
    return {
        "model": {"denoise_net": "adm",
                  "denoise_net_params": dict(TINY, dropout=dropout),
                  "view_fusion_params": {"beta_schedule": {"train": {
                      "schedule": "linear", "num_timesteps": 20,
                      "linear_start": 1e-4, "linear_end": 0.05}}}},
        "data": {"params": {"max_views": 3, "batch_size": 4}},
        "tpu": {"compute_dtype": dtype, "packed_views": True,
                "remat": remat, "peak_lr": 3e-4, "lr_warmup": 1},
    }


def _params(seed, device="cpu"):
    """Seeded f32 weights for every parameter: kernels N(0, 1/fan_in),
    norms 1 + N(0, 0.1^2), biases and the zero-init layers N(0, 0.05^2)."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, shape, kind in ref.param_specs(TINY):
        v = torch.randn(shape, generator=g)
        if kind == "kernel":
            v = v / math.sqrt(math.prod(shape[1:]))
        elif kind == "norm":
            v = 1.0 + 0.1 * v
        else:
            v = 0.05 * v
        out[name] = v.to(device)
    return out


def _adm(params, remat=False, dropout=0.0, device="cpu"):
    cfg = ADMConfig(**{k: tuple(v) if isinstance(v, list) else v
                       for k, v in TINY.items()}, dropout=dropout)
    model = ADM(cfg, remat=remat)
    model.load_state_dict(params)
    return model.to(device)


def _inputs(seed, b=5, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((b, 16, 16, 6), generator=g)
    angle = torch.rand((b,), generator=g) * 2 * math.pi
    level = torch.rand((b,), generator=g)
    return x.to(device), angle.to(device), level.to(device)


@pytest.mark.parametrize("seed", [1, 2])
def test_adm_forward_matches_reference(seed):
    params = _params(seed)
    x, angle, level = _inputs(seed + 10)
    got = _adm(params)(x, angle, level)
    want = ref.forward(params, TINY, x, angle, level)
    assert got.dtype == torch.float32 and got.shape == (5, 16, 16, 6)
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


def test_adm_state_dict_names_are_the_references():
    model = ADM(ADMConfig(**{k: tuple(v) if isinstance(v, list) else v
                             for k, v in TINY.items()}))
    names = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert names == {n: s for n, s, _ in ref.param_specs(TINY)}


def test_fresh_adm_is_the_zero_map():
    """ADM zero-initialises each ResBlock's last conv, the attention
    ``proj`` and the output conv: a fresh model outputs zeros."""
    model = ADM(ADMConfig(**{k: tuple(v) if isinstance(v, list) else v
                             for k, v in TINY.items()}))
    x, angle, level = _inputs(3)
    assert torch.count_nonzero(model(x, angle, level)) == 0


class _Reference(torch.nn.Module):
    """The reference forward as a denoiser for ``loss_packed``."""

    def __init__(self, params):
        super().__init__()
        self.params = params

    def forward(self, x, angle, level):
        return ref.forward(self.params, TINY, x, angle, level)


def _packed_batch(seed, b=4, n=3):
    g = torch.Generator().manual_seed(seed)
    counts = stratified_count_multiset(b, n)
    si, vi = packed_indices(counts)
    return dict(
        y_0=torch.rand((b, 16, 16, 3), generator=g) * 2 - 1,
        y_cond=torch.rand((b, n, 16, 16, 3), generator=g),
        view_count=torch.from_numpy(counts).long(),
        angle=torch.rand((b,), generator=g) * 6.0,
        sample_idx=torch.from_numpy(si).long(),
        view_idx=torch.from_numpy(vi).long(),
        noise=torch.randn((b, 16, 16, 3), generator=g),
        sample_gammas=torch.rand((b,), generator=g) * 0.9 + 0.05)


@pytest.mark.parametrize("remat", [False, True])
def test_adm_loss_packed_and_gradients_match_reference(remat):
    params = _params(4)
    vf = ViewFusion.from_config(Config.from_dict(_raw(remat=remat)))
    vf.unet.load_state_dict(params)
    batch = _packed_batch(5)
    loss = vf.loss_packed(**batch)
    loss.backward()
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    want = vf.loss_packed(**batch, denoiser=_Reference(leaves))
    want.backward()
    assert abs(loss.item() - want.item()) <= 1e-5 * abs(want.item())
    grads = dict(vf.unet.named_parameters())
    top = max(v.grad.abs().max().item() for v in leaves.values())
    for k, v in leaves.items():
        assert (grads[k].grad - v.grad).abs().max().item() <= 1e-4 * top, k


def test_adm_dropout_masks_follow_remat():
    """The dense loss's dropout: one mask a ResBlock, drawn before the
    block runs, so remat's recomputation gives the same gradients; a
    different draw gives a different loss."""
    params = _params(6)
    batch = _packed_batch(7)
    for k in ("sample_idx", "view_idx"):
        batch.pop(k)
    out = {}
    for remat in (False, True):
        vf = ViewFusion.from_config(Config.from_dict(
            _raw(dropout=0.1, remat=remat)))
        vf.unet.load_state_dict(params)
        loss = vf.loss(**batch,
                       dropout=torch.Generator().manual_seed(8))
        loss.backward()
        out[remat] = (loss.item(), {k: p.grad.clone() for k, p in
                                    vf.unet.named_parameters()})
    assert out[False][0] == out[True][0]
    for k, g in out[False][1].items():
        torch.testing.assert_close(out[True][1][k], g, rtol=0, atol=1e-7)
    other = vf.loss(**batch, dropout=torch.Generator().manual_seed(9))
    plain = vf.loss(**batch)
    assert len({out[False][0], other.item(), plain.item()}) == 3


def _by_hand(x, gamma, beta, s, t, groups, act):
    """GN(x) with the GroupNorm's own affine, then (1 + s), t per
    sample, then the activation."""
    b, length, c = x.shape
    xn = torch.nn.functional.group_norm(
        x.transpose(1, 2), groups, gamma, beta, eps=1e-5).transpose(1, 2)
    z = xn * (1 + s[:, None, :]) + t[:, None, :]
    return torch.nn.functional.silu(z) if act == "silu" else z


@pytest.mark.parametrize("act", ["silu", "none"])
@pytest.mark.parametrize("per_sample", [True, False])
def test_group_norm_affine_per_sample_matches_by_hand(per_sample, act):
    """The plain forward and backward with a (B, C) affine (the folded
    AdaGN) or a (C,) one, against autograd through the by-hand norm;
    the backward's affine gradients are shaped like the affine."""
    g = torch.Generator().manual_seed(11)
    b, length, c, groups = 3, 20, 16, 4
    x = (torch.randn((b, length, c), generator=g) * 1.5 + 0.3)
    gamma = 1 + 0.2 * torch.randn((c,), generator=g)
    beta = 0.2 * torch.randn((c,), generator=g)
    shape = (b, c) if per_sample else (1, c)
    s = (0.3 * torch.randn(shape, generator=g)).expand(b, c)
    t = (0.3 * torch.randn(shape, generator=g)).expand(b, c)
    scale = (gamma * (1 + s)) if per_sample else gamma * (1 + s[0])
    bias = (beta * (1 + s) + t) if per_sample else beta * (1 + s[0]) + t[0]
    y, mean, rstd = group_norm_act_reference(x, scale, bias, groups=groups,
                                             act=act)
    xl = x.clone().requires_grad_(True)
    want = _by_hand(xl, gamma, beta, s, t, groups, act)
    torch.testing.assert_close(y, want.detach(), rtol=0, atol=1e-5)
    gy = torch.randn((b, length, c), generator=g)
    want.backward(gy)
    dx, dscale_p, dbias_p = group_norm_act_backward_reference(
        x, gy, scale, bias, mean, rstd, groups=groups, act=act)
    torch.testing.assert_close(dx, xl.grad, rtol=0, atol=1e-5)
    # autograd through group_norm_act: gradients shaped like the affine
    sl = scale.clone().requires_grad_(True)
    bl = bias.clone().requires_grad_(True)
    group_norm_act(x, sl, bl, groups=groups, act=act).backward(gy)
    assert sl.grad.shape == scale.shape and bl.grad.shape == bias.shape
    if per_sample:
        torch.testing.assert_close(sl.grad, dscale_p, rtol=0, atol=0)
        torch.testing.assert_close(bl.grad, dbias_p, rtol=0, atol=0)
    else:
        torch.testing.assert_close(sl.grad, dscale_p.sum(0), rtol=0, atol=0)


def test_group_norm_rejects_an_affine_of_another_shape():
    x = torch.zeros((2, 4, 8))
    for sc, bi in ((torch.ones(3, 8), torch.zeros(3, 8)),
                   (torch.ones(2, 8), torch.zeros(8)),
                   (torch.ones(4), torch.zeros(4))):
        with pytest.raises(ValueError, match="scale and bias"):
            group_norm_act(x, sc, bi, groups=4)
        with pytest.raises(ValueError, match="scale and bias"):
            group_norm_act_backward(x, x, sc, bi, torch.zeros(2, 4),
                                    torch.ones(2, 4), groups=4)


def test_adm_yaml_builds_through_from_config():
    """The port's ADM ImageNet-64 YAML loads, names the ADM and builds
    the published 295.1 M parameters (on the meta device: no memory)."""
    cfg = load_config(str(YAML))
    assert cfg.denoise_net == "adm" and cfg.train.peak_lr == 3e-4
    assert cfg.denoiser == ADMConfig()
    with torch.device("meta"):
        vf = ViewFusion.from_config(cfg)
    assert isinstance(vf.unet, ADM) and vf.unet.dtype == torch.bfloat16
    assert sum(p.numel() for p in vf.unet.parameters()) == 295_141_638
    heads = sorted({m.attn.num_heads for m in vf.unet.modules()
                    if hasattr(m, "attn")})
    assert heads == [6, 9, 12]


def test_adm_trainer_steps_on_the_cpu():
    """``Trainer.train_step`` on packed uint8 batches: the loss is finite,
    every parameter moves, one ``unet.forward`` a step, and no kernel is
    launched (the plain versions run on the CPU)."""
    trainer = Trainer(Config.from_dict(_raw()), device="cpu",
                      state_dict=_params(12), seed=3)
    rng = np.random.default_rng(0)
    counts = stratified_count_multiset(4, 3)
    si, vi = packed_indices(counts)
    batch = {"target": rng.integers(0, 256, (4, 16, 16, 3), np.uint8),
             "cond": rng.integers(0, 256, (4, 3, 16, 16, 3), np.uint8),
             "angle": rng.uniform(0, 6, 4).astype(np.float32),
             "view_count": counts.astype(np.int32),
             "sample_idx": si, "view_idx": vi}
    before = {k: v.detach().clone() for k, v in
              trainer.model.unet.named_parameters()}
    launches = tracing.counters()
    mark = tracing.mark()
    losses = [float(trainer.train_step(batch)) for _ in range(2)]
    assert all(np.isfinite(losses))
    assert len(tracing.spans("unet.forward", after=mark)) == 2
    for k, v in trainer.model.unet.named_parameters():
        assert not torch.equal(v.detach(), before[k]), k
    after = tracing.counters()
    for name in ("k1.launches", "k1.affine_launches", "k2.affine_launches"):
        assert after[name] == launches[name]


def test_adm_serves_a_request_on_the_cpu():
    """A tiny ADM behind the port's server: a request of two views
    through DDIM comes back as an image."""
    from viewfusion_tpu_torch.serving import ViewFusionService

    raw = _raw()
    raw["data"]["params"]["max_views"] = 2
    svc = ViewFusionService.from_state_dict(Config.from_dict(raw),
                                            _params(13), batch_size=2,
                                            device="cpu")
    img = svc.submit(np.random.default_rng(1).random((2, 16, 16, 3))
                     .astype(np.float32), 0.5, steps=3)
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()


def test_adm_trains_evaluates_and_serves_through_the_cli(tmp_path,
                                                       monkeypatch):
    """``cli.main -t`` on an 8 px ADM over synthetic shards, then its
    eval, writes a run dir (checkpoints in the JAX file layout, the ADM's
    module paths as the tree); ``-e`` evaluates the run dir, and the
    server serves its weights."""
    from viewfusion_tpu_torch import cli
    from viewfusion_tpu_torch.config import dump_yaml
    from viewfusion_tpu_torch.data.synthetic import make_synthetic_shards
    from viewfusion_tpu_torch.serving import ViewFusionService

    data = str(tmp_path / "data")
    for mode in ("train", "test"):
        make_synthetic_shards(data, mode, num_objects=8, image_size=8)
    raw = _raw()
    raw["model"].update(max_it=3, checkpoint_every=0, log_every=2,
                        validate_every=0, validate_from=0)
    raw["model"]["denoise_net_params"].update(image_size=8,
                                              attention_resolutions=[4])
    split = {"start_shard": 0, "end_shard": 0, "path": data}
    raw["data"]["params"].update(
        num_workers=1, batch_size=4,
        train={"params": dict(split, mode="train")},
        test={"params": dict(split, mode="test", size=4)})
    raw["tpu"].update(native_loader=False, sample_num=2, seed=0)
    monkeypatch.chdir(tmp_path)
    (tmp_path / "tiny.yaml").write_text(dump_yaml(raw))
    exp = cli.main(["-c", "tiny.yaml", "-t", "--device", "cpu"])
    assert exp.it == 3 and isinstance(exp.trainer.model.unet, ADM)
    exp.eval()                          # writes the best-model files
    run = str(tmp_path / exp.out_dir)
    trained = {k: v.detach().clone() for k, v in
               exp.trainer.model.unet.state_dict().items()}
    exp = cli.main(["-s", run, "-e", "--device", "cpu"])
    svc = ViewFusionService(run, batch_size=2, device="cpu")
    for k, v in svc.model.unet.state_dict().items():
        assert torch.equal(v, trained[k]), k
    img = svc.submit(np.random.default_rng(2).random((2, 8, 8, 3))
                     .astype(np.float32), 0.5, steps=2)
    assert img.shape == (8, 8, 3) and np.isfinite(img).all()


# ---------------------------------------------------------------------
# on a card


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("length,c", [(4096, 576), (1024, 960), (64, 1536)])
def test_group_norm_kernels_per_sample_affine(device, length, c):
    """K1 and K2 with a (B, C) affine in bf16 at ADM's sites that do not
    stage whole (and its widest), against the plain versions."""
    b = 6
    g = torch.Generator(device=device).manual_seed(14)
    x = (torch.randn((b, length, c), generator=g, device=device) * 1.5
         + 0.5).bfloat16()
    scale = 1 + 0.3 * torch.randn((b, c), generator=g, device=device)
    bias = 0.3 * torch.randn((b, c), generator=g, device=device)
    gy = torch.randn((b, length, c), generator=g, device=device).bfloat16()
    k1, a1 = group_norm_act.launches, group_norm_act.affine_launches
    y, mean, rstd = group_norm_act(x, scale, bias, groups=32, act="silu",
                                   return_stats=True)
    dx, dsc, dbi = group_norm_act_backward(x, gy, scale, bias, mean, rstd,
                                           groups=32, act="silu")
    torch.cuda.synchronize()
    assert (group_norm_act.launches, group_norm_act.affine_launches) == (
        k1 + 1, a1 + 1)
    y_r, mean_r, rstd_r = group_norm_act_reference(x, scale, bias,
                                                   groups=32, act="silu")
    ulp = 2.0 ** (math.floor(math.log2(y_r.float().abs().max().item())) - 7)
    assert (y.float() - y_r.float()).abs().max().item() <= ulp
    dx_r, dsc_r, dbi_r = group_norm_act_backward_reference(
        x, gy, scale, bias, mean_r, rstd_r, groups=32, act="silu")
    ulp = 2.0 ** (math.floor(math.log2(dx_r.float().abs().max().item())) - 7)
    assert (dx.float() - dx_r.float()).abs().max().item() <= 2 * ulp
    for got, want in ((dsc, dsc_r), (dbi, dbi_r)):
        assert got.shape == (b, c)
        assert (got - want).abs().max().item() <= \
            1e-3 * want.abs().max().item()


@pytest.mark.cuda
def test_adm_train_step_on_the_card_matches_the_reference(device):
    """One bf16 packed loss and its gradients on the card (K1/K2 with
    AdaGN, K3 at 6 x 16 heads) against the f32 reference on the card."""
    params = _params(15, device)
    raw = _raw(dtype="bfloat16")
    vf = ViewFusion.from_config(Config.from_dict(raw))
    vf.unet.load_state_dict(params)
    vf.unet.to(device)
    batch = {k: v.to(device) for k, v in _packed_batch(16).items()}
    a1, a2 = group_norm_act.affine_launches, \
        group_norm_act_backward.affine_launches
    loss = vf.loss_packed(**batch)
    loss.backward()
    torch.cuda.synchronize()
    # every ResBlock's AdaGN fused into K1 and K2
    n_res = sum(1 for n, _, _ in ref.param_specs(TINY)
                if n.endswith("out_layers.0.weight"))
    assert group_norm_act.affine_launches - a1 == n_res
    assert group_norm_act_backward.affine_launches - a2 == n_res
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    want = vf.loss_packed(**batch, denoiser=_Reference(leaves))
    want.backward()
    assert abs(loss.item() - want.item()) <= 2e-2 * abs(want.item())
    got_n = torch.sqrt(sum(p.grad.float().pow(2).sum()
                           for p in vf.unet.parameters()))
    want_n = torch.sqrt(sum(v.grad.pow(2).sum() for v in leaves.values()))
    assert abs(got_n.item() - want_n.item()) <= 0.05 * want_n.item()


@pytest.mark.cuda
def test_adm_graphed_ddim_chain_equals_the_eager_chain(device):
    """A bf16 ADM's 10-step DDIM chain at 4 x 3 rows: replayed as a CUDA
    graph (8 replays, each with its AdaGN K1 launches counted) it equals
    the eager chain bit for bit."""
    cfg = Config.from_dict(_raw(dtype="bfloat16"))
    vf = ViewFusion.from_config(cfg)
    vf.unet.load_state_dict(_params(17))
    vf.unet.to(device).eval()
    g = torch.Generator(device=device).manual_seed(18)
    y_cond = torch.rand((4, 3, 16, 16, 3), generator=g, device=device)
    counts = torch.tensor([1, 2, 3, 3], device=device)
    angle = torch.rand((4,), generator=g, device=device)

    def chain():
        gen = torch.Generator(device=device).manual_seed(19)
        with torch.inference_mode():
            return vf.generate_ddim(y_cond, counts, angle, num_steps=10,
                                    generator=gen)

    runner = vf.graphs
    vf.graphs = lambda m, x, a, lvl, **kw: (m(x, a, lvl), False)
    before = tracing.counters()
    want = chain()
    eager = tracing.counters()["k1.affine_launches"] - \
        before["k1.affine_launches"]
    vf.graphs = runner
    before = tracing.counters()
    got = chain()
    after = tracing.counters()
    assert after["unet.graph_replays"] - before.get(
        "unet.graph_replays", 0) == 8
    assert after["k1.affine_launches"] - before["k1.affine_launches"] == \
        eager
    assert torch.equal(got, want)
