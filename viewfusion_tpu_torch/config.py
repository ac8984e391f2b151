"""Typed configuration tree (the port's own copy of the JAX package's).

The YAML schema is the reference's ``configs/*.yaml``, so every config
under ``configs/`` loads 1:1.  YAML is read and written as PyYAML's
``safe_load`` and ``dump(default_flow_style=False)`` do, by the port's own
codec (:mod:`viewfusion_tpu_torch.utils.yaml11`: :func:`parse_yaml`,
:func:`dump_yaml`), so the package needs no PyYAML and a run dir's
``config.yaml`` is the JAX package's byte for byte.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from viewfusion_tpu_torch.utils.yaml11 import dump_yaml, parse_yaml

__all__ = ["BetaScheduleConfig", "DiffusionConfig", "UNetConfig",
           "DiTConfig", "ADMConfig", "SplitConfig", "DataConfig",
           "TrainConfig", "Config", "load_config", "parse_yaml",
           "dump_yaml"]


@dataclass(frozen=True)
class BetaScheduleConfig:
    """One noise schedule (reference: model/view_fusion.py:330-362)."""

    schedule: str = "linear"
    num_timesteps: int = 2000
    linear_start: float = 1e-6
    linear_end: float = 1e-2
    cosine_s: float = 8e-3

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "BetaScheduleConfig":
        return cls(**{k: v for k, v in d.items() if k in _field_names(cls)})


@dataclass(frozen=True)
class DiffusionConfig:
    """ViewFusion diffusion wrapper params.  The *train* schedule is the
    active one even for inference (``active_phase``), as in the
    reference (experiment.py:102)."""

    phases: Dict[str, BetaScheduleConfig] = field(
        default_factory=lambda: {
            "train": BetaScheduleConfig(),
            "test": BetaScheduleConfig(
                num_timesteps=1000, linear_start=1e-4, linear_end=0.09
            ),
        }
    )
    weighting_train: bool = True
    weighting_inference: bool = True
    active_phase: str = "train"

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "DiffusionConfig":
        phases = {
            name: BetaScheduleConfig.from_dict(sched)
            for name, sched in d.get("beta_schedule", {}).items()
        }
        return cls(
            phases=phases or cls().phases,
            weighting_train=d.get("weighting_train", True),
            weighting_inference=d.get("weighting_inference", True),
        )


@dataclass(frozen=True)
class UNetConfig:
    """Denoiser UNet hyper-params (reference: model/unet.py:8-21)."""

    image_size: int = 128
    in_channel: int = 6
    out_channel: int = 3
    inner_channel: int = 32
    norm_groups: int = 32
    channel_mults: Tuple[int, ...] = (1, 2, 4, 8, 8)
    attn_res: Tuple[int, ...] = (8,)
    res_blocks: int = 3
    dropout: float = 0.0
    with_noise_level_emb: bool = True

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "UNetConfig":
        d = dict(d)
        for key in ("channel_mults", "attn_res"):
            if key in d:
                d[key] = tuple(d[key])
        return cls(**{k: v for k, v in d.items() if k in _field_names(cls)})


@dataclass(frozen=True)
class DiTConfig:
    """DiT denoiser hyper-params (``models/dit.py``)."""

    image_size: int = 64
    in_channel: int = 6
    out_channel: int = 6
    patch_size: int = 4
    hidden_size: int = 256
    depth: int = 8
    num_heads: int = 4
    mlp_ratio: int = 4

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "DiTConfig":
        return cls(**{k: v for k, v in d.items() if k in _field_names(cls)})


@dataclass(frozen=True)
class ADMConfig:
    """ADM UNet hyper-params (``models/adm.py``; Dhariwal & Nichol's
    ``guided_diffusion/unet.py`` flags: ``model_channels``,
    ``channel_mult``, ``num_res_blocks``, ``attention_resolutions`` as
    pixel sizes, ``num_head_channels``, ``dropout``; scale-shift norm and
    up/down ResBlocks always on)."""

    image_size: int = 64
    in_channel: int = 6
    out_channel: int = 6
    model_channels: int = 192
    channel_mult: Tuple[int, ...] = (1, 2, 3, 4)
    num_res_blocks: int = 3
    attention_resolutions: Tuple[int, ...] = (32, 16, 8)
    num_head_channels: int = 64
    dropout: float = 0.1

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ADMConfig":
        d = dict(d)
        for key in ("channel_mult", "attention_resolutions"):
            if key in d:
                d[key] = tuple(d[key])
        return cls(**{k: v for k, v in d.items() if k in _field_names(cls)})


@dataclass(frozen=True)
class SplitConfig:
    """One dataset split (``data.params.{train,test,validation}``)."""

    path: str = ""
    mode: str = "train"
    start_shard: int = 0
    end_shard: int = 3
    size: int = 8751
    format: str = "auto"

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SplitConfig":
        return cls(**{k: v for k, v in d.items() if k in _field_names(cls)})


@dataclass(frozen=True)
class DataConfig:
    """Data pipeline params (``data.params``)."""

    batch_size: int = 112
    max_views: int = 6
    num_workers: int = 1
    train: SplitConfig = field(default_factory=lambda: SplitConfig(mode="train"))
    test: SplitConfig = field(default_factory=lambda: SplitConfig(mode="test"))
    validation: SplitConfig = field(default_factory=lambda: SplitConfig(mode="val"))
    total_views: int = 24

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "DataConfig":
        params = d.get("params", d)
        kwargs: Dict[str, Any] = {
            k: v
            for k, v in params.items()
            if k in _field_names(cls) and k not in ("train", "test", "validation")
        }
        for split in ("train", "test", "validation"):
            if split in params:
                kwargs[split] = SplitConfig.from_dict(params[split].get("params", {}))
        return cls(**kwargs)


@dataclass(frozen=True)
class TrainConfig:
    """Training-loop and execution knobs (the ``tpu:`` block of a config
    plus the reference's ``.get`` fallbacks).  The fields are the JAX
    package's, so a run dir's config loads unchanged; the port reads
    ``compute_dtype``, ``ema_decay``, ``sampler`` and the sampler step
    counts so far."""

    max_it: int = 1_000_000
    validate_every: int = 5_000
    validate_from: int = 100_000
    checkpoint_every: int = 100
    log_every: int = 100
    peak_lr: float = 1e-4
    lr_warmup: int = 2500
    decay_it: int = 4_000_000
    decay_rate: float = 0.16
    seed: int = 0
    sample_num: int = 8
    compute_dtype: str = "bfloat16"
    remat: bool = False
    mesh_data: int = 0
    mesh_view: int = 1
    profile_from: int = 0
    profile_steps: int = 0
    native_loader: Optional[bool] = None
    native_threads: int = 4
    sampler: str = "ddpm"
    ddim_steps: int = 50
    ddim_eta: float = 1.0
    dpm_steps: int = 20
    ema_decay: float = 0.0
    eval_dump_images: bool = False
    eval_exact_epoch: bool = False
    chain_segments: int = 1
    eval_iid_counts: bool = False
    eval_train_split: bool = False
    packed_views: bool = False
    async_checkpoint: bool = True
    u8_feed: bool = True
    shard_opt_state: bool = False
    grad_accum: int = 1
    fused_feed: bool = False

    def __post_init__(self):
        if self.sampler not in ("ddpm", "ddim", "dpm", "dpm_sde"):
            raise ValueError(
                f"unknown tpu.sampler {self.sampler!r}; options: ddpm "
                "(reference ancestral), ddim, dpm, dpm_sde"
            )
        if self.grad_accum < 1:
            raise ValueError(
                f"tpu.grad_accum must be >= 1, got {self.grad_accum}"
            )


@dataclass(frozen=True)
class Config:
    """Top-level config; loads the reference YAML schema 1:1."""

    unet: UNetConfig = field(default_factory=UNetConfig)
    diffusion: DiffusionConfig = field(default_factory=DiffusionConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    denoise_net: str = "unet"
    relative: bool = False
    raw: Dict[str, Any] = field(default_factory=dict, compare=False)

    @property
    def denoiser(self):
        """Typed params of the active denoiser family."""
        family = {"dit": DiTConfig, "adm": ADMConfig}.get(self.denoise_net)
        if family is not None:
            return family.from_dict(
                self.raw.get("model", {}).get("denoise_net_params", {})
            )
        return self.unet

    @classmethod
    def from_dict(cls, raw: Dict[str, Any]) -> "Config":
        model = raw.get("model", {})
        train_kwargs = dict(
            max_it=model.get("max_it", 1_000_000),
            validate_every=model.get("validate_every", 5_000),
            validate_from=model.get("validate_from", 100_000),
            checkpoint_every=model.get("checkpoint_every", 100),
            log_every=model.get("log_every", 100),
            lr_warmup=raw.get("lr_warmup", 2500),
            decay_it=raw.get("decay_it", 4_000_000),
        )
        train_kwargs.update(
            {
                k: v
                for k, v in raw.get("tpu", {}).items()
                if k in _field_names(TrainConfig)
            }
        )
        return cls(
            unet=UNetConfig.from_dict(model.get("denoise_net_params", {})),
            diffusion=DiffusionConfig.from_dict(model.get("view_fusion_params", {})),
            data=DataConfig.from_dict(raw.get("data", {})),
            train=TrainConfig(**train_kwargs),
            denoise_net=model.get("denoise_net", "unet"),
            relative=model.get("relative", False),
            raw=raw,
        )

    def to_yaml(self) -> str:
        return dump_yaml(self.raw)


def load_config(path: str) -> Config:
    """Load a reference-schema YAML config file."""
    with open(path, "r") as f:
        raw = parse_yaml(f.read())
    return Config.from_dict(raw)


def _field_names(cls) -> List[str]:
    return [f.name for f in dataclasses.fields(cls)]
