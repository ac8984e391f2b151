#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of ViewFusion on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero without the final line):
  1. device: the card's name and power limit (nvidia-smi); CUDA present;
  2. build: the CUDA kernels from viewfusion_tpu_torch/csrc (nvcc, sm_90a);
  3. K1 GroupNorm(+SiLU) at every GroupNorm site of the paper UNet, found
     by hooks on the model, at the serving batch of 8 x 6 views, against
     its plain version, with times;
  4. K3 attention at every attention site of the paper UNet, the same way;
  5. the full-width paper UNet in bf16 with the kernels against the same
     UNet with the plain versions patched in;
  6. serving, the main path: ViewFusionService at the paper config with
     seeded random weights answers DDIM and DPM requests from threads;
     the kernels' launch counters must rise by exactly the per-forward
     site counts times the UNet forwards served;
  7. a small chain on the card against the same chain on the CPU.
The last lines are the card's name and power limit, one JSON object with
the kernels' numbers, and ``{"ok": true, "device": {...}}``.

Tolerances: bf16 outputs within one bf16 ulp of the output scale (both
sides round one f32 value; the sums run in another order); saved
statistics within rtol 1e-4; f32 attention outputs within 1e-4 abs
(f32 sums over the keys in another order); the bf16 UNet within 2e-2
relative L2 (bf16 rounding flips from the GroupNorm and attention
outputs, carried through ~60 layers); the f32 chain within 1e-4.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
from collections import Counter

import numpy as np
import torch
import torch.nn.functional as F

from viewfusion_tpu_torch import _native
from viewfusion_tpu_torch.config import Config
from viewfusion_tpu_torch.models import unet as unet_module
from viewfusion_tpu_torch.models.unet import GroupNormAct, SelfAttention, UNet
from viewfusion_tpu_torch.models.view_fusion import ViewFusion
from viewfusion_tpu_torch.ops.attention import (
    spatial_self_attention, spatial_self_attention_reference)
from viewfusion_tpu_torch.ops.groupnorm import (group_norm_act,
                                                group_norm_act_reference)
from viewfusion_tpu_torch.serving import ViewFusionService

# configs/small-tpu-4.yaml, the fields the serving path reads (kept in
# code: the card's machine may have no PyYAML)
PAPER_CONFIG = {
    "model": {
        "denoise_net": "unet",
        "view_fusion_params": {"beta_schedule": {
            "train": {"schedule": "linear", "num_timesteps": 2000,
                      "linear_start": 1.0e-06, "linear_end": 0.01},
            "test": {"schedule": "linear", "num_timesteps": 1000,
                     "linear_start": 0.0001, "linear_end": 0.09},
        }},
        "denoise_net_params": {
            "image_size": 64, "in_channel": 6, "out_channel": 6,
            "inner_channel": 64, "res_blocks": 3, "attn_res": [16],
            "channel_mults": [1, 2, 3, 5],
        },
    },
    "data": {"params": {"max_views": 6, "batch_size": 112}},
    "tpu": {"packed_views": True, "compute_dtype": "bfloat16"},
}
# a small config for the card-against-CPU chain (tests/conftest.py sizes)
TINY_UNET = {"image_size": 8, "in_channel": 6, "out_channel": 6,
             "inner_channel": 8, "norm_groups": 4, "res_blocks": 1,
             "attn_res": [4], "channel_mults": [1, 2]}

SEED = 0
BATCH, MAX_VIEWS = 8, 6
ROWS = BATCH * MAX_VIEWS        # UNet rows per serving batch
DDIM_STEPS, DPM_STEPS = 50, 20
HBM_BYTES_PER_S = 3.35e12       # H100 SXM
# peak rate by input type: bf16 on the tensor cores (dense); f32 outside
# them (the f32 math of these kernels)
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}


def say(*parts) -> None:
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, iters: int = 20) -> float:
    """Device time of one call: ``iters`` calls captured into a CUDA graph
    and replayed between CUDA events, so the host's per-call cost
    (Python, allocation, launch) is not in the number.  Inputs that fit
    the 50 MB L2 stay there from one call to the next."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (3 * iters)


def call_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Time of one eager call, host included: CUDA events around
    ``iters`` back-to-back calls (the device idles whenever the host is
    slower than the kernel)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, ops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bf16_ulp(scale: float) -> float:
    return 2.0 ** (np.floor(np.log2(max(scale, 1e-30))) - 7)


def add_site(tot, count, ms, plain_ms, lib_ms, bms, nbytes, err) -> None:
    """Add one site, ``count`` times per forward, to a kernel's totals."""
    if count:
        tot["ms"] += count * ms
        tot["plain_ms"] += count * plain_ms
        tot["library_ms"] += count * lib_ms
        tot["bound_ms"] += count * bms
        tot["bound_bytes_ms"] += count * (nbytes / HBM_BYTES_PER_S * 1e3)
        tot["max_abs_err"] = max(tot["max_abs_err"], err)


def paper_unet(device) -> UNet:
    cfg = Config.from_dict(PAPER_CONFIG)
    torch.manual_seed(SEED)
    unet = UNet(cfg.unet, dtype=torch.bfloat16)
    unet_module.cast_matmul_weights_(unet.to(device).eval(), torch.bfloat16)
    return unet


def unet_inputs(rows: int, cfg, device, seed: int = SEED):
    g = torch.Generator(device=device).manual_seed(seed)
    hw = cfg.image_size
    x = torch.randn((rows, hw, hw, cfg.in_channel), generator=g,
                    device=device)
    angle = torch.rand((rows,), generator=g, device=device) * 6.28
    level = torch.rand((rows,), generator=g, device=device)
    return x, angle, level


def sites(unet: UNet, rows: int, device):
    """(L, C, act) GroupNorm sites and (S, C) attention sites of one
    forward, with their counts, read by hooks on the model."""
    gn, attn = Counter(), Counter()
    hooks = [m.register_forward_pre_hook(
        lambda m, a: gn.update([(a[0].shape[2] * a[0].shape[3],
                                 a[0].shape[1], m.act)]))
        for m in unet.modules() if isinstance(m, GroupNormAct)]
    hooks += [m.register_forward_pre_hook(
        lambda m, a: attn.update([(a[0].shape[2] * a[0].shape[3],
                                   a[0].shape[1])]))
        for m in unet.modules() if isinstance(m, SelfAttention)]
    with torch.inference_mode():
        unet(*unet_inputs(rows, unet.config, device))
    for h in hooks:
        h.remove()
    return gn, attn


def check_group_norm(gn_sites, groups: int, device) -> dict:
    """K1 against its plain version at each site (bf16, plus one f32
    shape); per-forward totals weight each site by its count."""
    g = torch.Generator(device=device).manual_seed(SEED + 1)
    tot = dict.fromkeys(("ms", "plain_ms", "library_ms", "bound_ms",
                         "bound_bytes_ms", "max_abs_err"), 0.0)
    f32_site = max(gn_sites)
    cases = [(site, torch.bfloat16, n) for site, n in sorted(gn_sites.items())]
    cases.append((f32_site, torch.float32, 0))  # checked, not in totals
    for (l, c, act), dtype, count in cases:
        x = (torch.randn((ROWS, l, c), generator=g, device=device) * 1.5
             + 0.5).to(dtype)
        scale = torch.randn((c,), generator=g, device=device) * 0.5 + 1.0
        bias = torch.randn((c,), generator=g, device=device) * 0.5
        kw = dict(groups=groups, act=act)
        y, mean, rstd = group_norm_act(x, scale, bias, return_stats=True,
                                       **kw)
        y_r, mean_r, rstd_r = group_norm_act_reference(x, scale, bias, **kw)
        torch.cuda.synchronize()
        err = (y.float() - y_r.float()).abs().max().item()
        tol = (bf16_ulp(y_r.float().abs().max().item())
               if dtype == torch.bfloat16 else 1e-5)
        if not err <= tol:
            raise AssertionError(f"K1 {(l, c, act)} {dtype}: err {err} > {tol}")
        torch.testing.assert_close(mean, mean_r, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(rstd, rstd_r, rtol=1e-4, atol=1e-5)

        x4 = x.view(ROWS, int(l ** 0.5), -1, c).permute(0, 3, 1, 2)
        w_lib, b_lib = scale.to(dtype), bias.to(dtype)

        def library():
            out = F.group_norm(x4, groups, w_lib, b_lib, 1e-5)
            return F.silu(out) if act == "silu" else out

        ms = device_ms(lambda: group_norm_act(x, scale, bias, **kw))
        eager_ms = call_ms(lambda: group_norm_act(x, scale, bias, **kw))
        plain_ms = device_ms(lambda: group_norm_act_reference(
            x, scale, bias, **kw))
        lib_ms = device_ms(library)
        nbytes = 2 * x.numel() * x.element_size() + 2 * c * 4 \
            + 2 * ROWS * groups * 4
        bms, by = bound_ms(nbytes, 10 * x.numel(), torch.float32)
        say(f"K1 L={l} C={c} act={act} {str(dtype)[6:]} x{count}: "
            f"err {err:.3g} (tol {tol:.3g}) kernel {ms * 1e3:.1f} us "
            f"(eager call {eager_ms * 1e3:.1f} us) plain "
            f"{plain_ms * 1e3:.1f} us library {lib_ms * 1e3:.1f} us "
            f"bound {bms * 1e3:.1f} us ({by}) = {bms / ms:.0%} of bound")
        add_site(tot, count, ms, plain_ms, lib_ms, bms, nbytes, err)
    return tot


def check_attention(attn_sites, device) -> dict:
    """K3 against its plain version at each site: q, k, v column slices
    of one (B, S, 3C) qkv buffer, as the UNet hands them over."""
    g = torch.Generator(device=device).manual_seed(SEED + 2)
    tot = dict.fromkeys(("ms", "plain_ms", "library_ms", "bound_ms",
                         "bound_bytes_ms", "max_abs_err"), 0.0)
    cases = [(site, torch.bfloat16, n) for site, n in sorted(attn_sites.items())]
    cases.append((max(attn_sites), torch.float32, 0))
    for (s, c), dtype, count in cases:
        qkv = torch.randn((ROWS, s, 3 * c), generator=g,
                          device=device).to(dtype)
        q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
        scale = 1.0 / c ** 0.5
        out = spatial_self_attention(q, k, v, scale)
        ref = spatial_self_attention_reference(q, k, v, scale)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        if not err <= 1e-4:
            raise AssertionError(f"K3 {(s, c)} {dtype}: err {err} > 1e-4")
        q4, k4, v4 = (t.view(ROWS, 1, s, c) for t in (q, k, v))
        ms = device_ms(lambda: spatial_self_attention(q, k, v, scale))
        eager_ms = call_ms(lambda: spatial_self_attention(q, k, v, scale))
        plain_ms = device_ms(
            lambda: spatial_self_attention_reference(q, k, v, scale))
        lib_ms = device_ms(
            lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=scale))
        nbytes = 3 * q.numel() * q.element_size() + out.numel() * 4
        bms, by = bound_ms(nbytes, 4 * ROWS * s * s * c, dtype)
        say(f"K3 S={s} C={c} {str(dtype)[6:]} x{count}: err {err:.3g} "
            f"kernel {ms * 1e3:.1f} us (eager call {eager_ms * 1e3:.1f} us) "
            f"plain {plain_ms * 1e3:.1f} us library {lib_ms * 1e3:.1f} us "
            f"bound {bms * 1e3:.1f} us ({by})"
            f" = {bms / ms:.0%} of bound")
        add_site(tot, count, ms, plain_ms, lib_ms, bms, nbytes, err)
    return tot


def check_full_unet(unet: UNet, device) -> None:
    """The paper UNet with the kernels against itself with the plain
    versions patched into the module's namespace."""
    inputs = unet_inputs(ROWS, unet.config, device, seed=SEED + 3)
    with torch.inference_mode():
        t0 = time.perf_counter()
        got = unet(*inputs)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        saved = unet_module.group_norm_act, unet_module.spatial_self_attention
        unet_module.group_norm_act = \
            lambda *a, **kw: group_norm_act_reference(*a, **kw)[0]
        unet_module.spatial_self_attention = spatial_self_attention_reference
        try:
            want = unet(*inputs)
        finally:
            unet_module.group_norm_act, \
                unet_module.spatial_self_attention = saved
    rel = ((got - want).norm() / want.norm()).item()
    say(f"UNet {ROWS}x64x64 bf16, kernels vs plain: rel L2 {rel:.3g}, max "
        f"abs {(got - want).abs().max().item():.3g} of "
        f"{want.abs().max().item():.3g}; forward {ms:.1f} ms (wall)")
    if not (torch.isfinite(got).all() and rel <= 2e-2):
        raise AssertionError(f"full UNet disagrees: rel L2 {rel}")


def profile_forward(unet: UNet, device) -> None:
    """Where one UNet forward at the serving batch spends its time:
    device time by kernel family from torch.profiler, against the wall
    time of the forward (the rest is the device waiting on the host)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    inputs = unet_inputs(ROWS, unet.config, device, seed=SEED + 4)
    with torch.inference_mode():
        unet(*inputs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        unet(*inputs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            unet(*inputs)
            torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) == DeviceType.CUDA]
    dev_us = {e.key: getattr(e, "self_device_time_total", 0) for e in kernels}
    total_ms = sum(dev_us.values()) / 1e3
    if not total_ms:
        say("profile: torch.profiler saw no device time (not measured)")
        return
    fam = Counter()
    for name, us in dev_us.items():
        low = name.lower()
        key = ("K1 groupnorm" if "gn_" in low else
               "K3 attention" if "attn_fwd" in low else
               "conv/gemm" if any(w in low for w in (
                   "conv", "gemm", "xmma", "cutlass", "cudnn", "sm90"))
               else "other")
        fam[key] += us / 1e3
    say(f"profile of one UNet forward at {ROWS} rows: wall {wall_ms:.2f} ms,"
        f" device busy {total_ms:.2f} ms ({total_ms / wall_ms:.0%}), "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in fam.most_common()))
    for name, us in sorted(dev_us.items(), key=lambda kv: -kv[1])[:8]:
        say(f"  {us / 1e3:7.3f} ms  {name[:90]}")


def serve_requests(service: ViewFusionService, rng) -> list:
    """12 DDIM requests with 1-6 views and 2 DPM requests, from threads."""
    hw = service.image_size
    jobs = [(1 + i % 6, DDIM_STEPS, "ddim") for i in range(12)]
    jobs += [(3, DPM_STEPS, "dpm"), (5, DPM_STEPS, "dpm")]
    results = [None] * len(jobs)

    def call(i, n, steps, sampler):
        cond = rng[i].uniform(0, 1, (n, hw, hw, 3)).astype(np.float32)
        t0 = time.perf_counter()
        img = service.submit(cond, angle=0.5 * i, steps=steps,
                             sampler=sampler)
        results[i] = (img, time.perf_counter() - t0, sampler)

    threads = [threading.Thread(target=call, args=(i, *job))
               for i, job in enumerate(jobs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    if any(r is None for r in results):
        raise AssertionError("a request did not complete")
    return results


def check_chain_against_cpu(device) -> None:
    """A small f32 DDIM chain (eta=1, noise fed) through the kernels on
    the card against the plain versions on the CPU."""
    raw = json.loads(json.dumps(PAPER_CONFIG))
    raw["model"]["denoise_net_params"] = TINY_UNET
    raw["model"]["view_fusion_params"]["beta_schedule"]["train"][
        "num_timesteps"] = 20
    raw["tpu"]["compute_dtype"] = "float32"
    cfg = Config.from_dict(raw)
    rng = np.random.default_rng(SEED)
    b, n, hw = 3, 3, 8
    y_cond = torch.from_numpy(rng.uniform(0, 1, (b, n, hw, hw, 3)).astype(
        np.float32))
    counts = torch.tensor([1, 3, 2])
    angle = torch.from_numpy(rng.uniform(0, 6, b).astype(np.float32))
    y_t = torch.from_numpy(rng.normal(size=(b, hw, hw, 3)).astype(np.float32))
    noise = [torch.from_numpy(rng.normal(size=(b, hw, hw, 3)).astype(
        np.float32)) for _ in range(10)]
    outs = []
    for dev in ("cpu", device):
        torch.manual_seed(SEED)
        model = ViewFusion.from_config(cfg)
        model.unet.to(dev).eval()
        outs.append(model.generate_ddim(
            y_cond.to(dev), counts.to(dev), angle.to(dev), num_steps=10,
            y_t=y_t.to(dev), noise=noise).cpu())
    err = (outs[0] - outs[1]).abs().max().item()
    say(f"tiny f32 DDIM chain, card vs CPU: max abs {err:.3g}")
    if not err <= 1e-4:
        raise AssertionError(f"card chain disagrees with the CPU: {err}")


def main() -> int:
    if not torch.cuda.is_available():
        print("CUDA is not available: chip_smoke.py needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")

    # 1. device
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    say(f"device: {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.device_count()} device(s)")

    # 2. build
    t0 = time.perf_counter()
    _native.library()
    say(f"build: {time.perf_counter() - t0:.1f} s")
    print(_native.build_log(), file=sys.stderr, flush=True)

    # 3, 4. kernels at the paper UNet's sites
    cfg = Config.from_dict(PAPER_CONFIG)
    unet = paper_unet(device)
    gn_sites, attn_sites = sites(unet, ROWS, device)
    k1_calls, k3_calls = sum(gn_sites.values()), sum(attn_sites.values())
    say(f"paper UNet sites per forward: {k1_calls} GroupNorm "
        f"({len(gn_sites)} distinct), {k3_calls} attention "
        f"({len(attn_sites)} distinct)")
    k1 = check_group_norm(gn_sites, cfg.unet.norm_groups, device)
    k3 = check_attention(attn_sites, device)

    # 5. full-width UNet, kernels against plain versions
    check_full_unet(unet, device)
    profile_forward(unet, device)
    state_dict = {k: v.float().cpu() for k, v in unet.state_dict().items()}
    del unet
    torch.cuda.empty_cache()

    # 6. serving: the main path
    service = ViewFusionService.from_state_dict(
        cfg, state_dict, batch_size=BATCH, max_views=MAX_VIEWS,
        default_steps=DDIM_STEPS, device=device)
    t0 = time.perf_counter()
    service.warmup([DDIM_STEPS], sampler="ddim")
    service.warmup([DPM_STEPS], sampler="dpm")
    say(f"warmup (ddim {DDIM_STEPS} + dpm {DPM_STEPS} steps): "
        f"{time.perf_counter() - t0:.1f} s")
    service.batch_log.clear()
    group_norm_act.launches = 0
    spatial_self_attention.launches = 0
    service.model.unet_forwards = 0
    t0 = time.perf_counter()
    results = serve_requests(
        service, [np.random.default_rng(SEED + i) for i in range(14)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    forwards = service.model.unet_forwards
    launches = {"k1": group_norm_act.launches,
                "k3": spatial_self_attention.launches}
    for img, _, sampler in results:
        if not (img.shape == (64, 64, 3) and np.isfinite(img).all()
                and img.min() >= 0.0 and img.max() <= 1.0):
            raise AssertionError(f"bad {sampler} output {img.shape}")
    if forwards == 0 or launches != {"k1": k1_calls * forwards,
                                     "k3": k3_calls * forwards}:
        raise AssertionError(
            f"launch counters {launches} != per-forward sites "
            f"({k1_calls}, {k3_calls}) x {forwards} forwards")
    lat = sorted(r[1] for r in results)
    say(f"served {len(results)} requests ({sum(r[2] != 'ddim' for r in results)}"
        f" dpm) in {wall:.2f} s = {len(results) / wall:.2f} views/s, "
        f"request latency p50 {lat[len(lat) // 2]:.2f} s max {lat[-1]:.2f} s"
        f" on {card}")
    for steps, sampler, n, sec in service.batch_log:
        say(f"  batch {sampler} {steps} steps, {n} requests: "
            f"{sec * 1e3:.0f} ms ({sec * 1e3 / steps:.1f} ms per step)")
    say(f"launches on the main path: K1 {launches['k1']}, K3 "
        f"{launches['k3']} over {forwards} UNet forwards")

    # 7. a small chain on the card against the CPU
    check_chain_against_cpu(device)

    kernels = []
    for name, route_src, replaces, tot, key in (
            ("group_norm_act", "viewfusion_tpu_torch/csrc/groupnorm.cu",
             "viewfusion_tpu/ops/groupnorm.py:147", k1, "k1"),
            ("spatial_self_attention",
             "viewfusion_tpu_torch/csrc/attention.cu",
             "viewfusion_tpu/ops/attention.py:47", k3, "k3")):
        kernels.append({
            "name": name, "route": "cuda", "source": route_src,
            "replaces": replaces, "launches": launches[key],
            "max_abs_err": tot["max_abs_err"], "ms": tot["ms"],
            "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": ("bytes" if tot["bound_bytes_ms"] >= tot["bound_ms"]
                         else "operations"),
            "library_ms": tot["library_ms"],
            "per": f"one UNet forward at {ROWS} rows",
        })
    say(card_line())
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
