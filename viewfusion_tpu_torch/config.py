"""Typed configuration tree (the port's own copy of the JAX package's).

The YAML schema is the reference's ``configs/*.yaml``, so every config
under ``configs/`` loads 1:1.  YAML is read and written by the small
codec at the end of this module (:func:`parse_yaml`, :func:`dump_yaml`),
so the package needs no PyYAML.
"""

from __future__ import annotations

import dataclasses
import math
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


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
        if self.denoise_net == "dit":
            return DiTConfig.from_dict(
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


# ----------------------------------------------------------------------
# YAML: the block subset that the repo's configs and
# ``yaml.dump(raw, default_flow_style=False)`` use
# ----------------------------------------------------------------------
# Nested block mappings and ``- item`` sequences (indented or not), the
# empty ``{}`` and ``[]`` that yaml.dump writes, comments, and scalars
# resolved as PyYAML's safe loader resolves them (YAML 1.1): null, bools
# (true/yes/on ...), decimal and octal ints (``0`` then digits 0-7: an
# unquoted NMR category id such as ``03001627`` is the int 787351, as
# PyYAML reads it), floats such as ``5.0e-05`` or ``.inf``, and plain,
# single- or double-quoted strings.  Anything else (flow collections,
# anchors and aliases, tags, block and multi-line scalars, directives and
# documents, complex keys, binary, hex and sexagesimal ints, timestamps)
# raises a ``ValueError`` that names the construct.

_Y_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_Y_BOOL = {v: b for b, vs in ((True, "yes Yes YES true True TRUE on On ON"),
                              (False, "no No NO false False FALSE off Off "
                                      "OFF")) for v in vs.split()}
_Y_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_Y_OCTAL = re.compile(r"^[-+]?0[0-7_]+$")
_Y_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                      r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                      r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
# what PyYAML would resolve to a type this codec does not take
_Y_OTHER = (
    ("a sexagesimal number",
     re.compile(r"^[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?$")),
    ("a binary or hex int",
     re.compile(r"^[-+]?(?:0b[0-1_]+|0x[0-9a-fA-F_]+)$")),
    ("a timestamp", re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-")),
    ("a merge key", re.compile(r"^<<$")),
    ("a value key", re.compile(r"^=$")),
)


def _yaml_error(what: str, lineno: int, line: str) -> ValueError:
    return ValueError(f"YAML line {lineno}: {what} is not supported by the "
                      f"port's YAML codec: {line.strip()!r}")


def _resolve_plain(text: str, lineno: int, line: str):
    if _Y_NULL.match(text):
        return None
    if text in _Y_BOOL:
        return _Y_BOOL[text]
    if _Y_INT.match(text):
        return int(text.replace("_", ""))
    if _Y_OCTAL.match(text):  # PyYAML's construct_yaml_int
        return int(text.replace("_", ""), 8)
    if _Y_FLOAT.match(text):
        v = text.replace("_", "").lower()
        sign = -1.0 if v.startswith("-") else 1.0
        v = v.lstrip("+-")
        if v == ".inf":
            return sign * math.inf
        if v == ".nan":
            return math.nan
        return sign * float(v)
    for what, pattern in _Y_OTHER:
        if pattern.match(text):
            raise _yaml_error(what, lineno, line)
    return text


_Y_ESCAPES = {"\\": "\\", '"': '"', "/": "/", "n": "\n", "t": "\t",
              "r": "\r", "0": "\0", "a": "\a", "b": "\b", "e": "\x1b",
              " ": " "}


def _scalar(text: str, lineno: int, line: str):
    """One scalar token (a key or a value), comment already stripped."""
    if not text:
        return None
    head = text[0]
    if head == "'":
        if len(text) < 2 or not text.endswith("'"):
            raise _yaml_error("a multi-line or unterminated quoted scalar",
                              lineno, line)
        body = text[1:-1]
        if re.search(r"(?<!')'(?!')", body.replace("''", "")):
            raise _yaml_error("text after a quoted scalar", lineno, line)
        return body.replace("''", "'")
    if head == '"':
        out, i = [], 1
        while i < len(text):
            c = text[i]
            if c == '"':
                if i != len(text) - 1:
                    raise _yaml_error("text after a quoted scalar", lineno,
                                      line)
                return "".join(out)
            if c == "\\":
                nxt = text[i + 1:i + 2]
                width = {"x": 2, "u": 4, "U": 8}.get(nxt)
                if nxt and nxt in _Y_ESCAPES:
                    out.append(_Y_ESCAPES[nxt])
                    i += 2
                elif width and re.fullmatch(r"[0-9a-fA-F]+",
                                            text[i + 2:i + 2 + width] or "-"):
                    out.append(chr(int(text[i + 2:i + 2 + width], 16)))
                    i += 2 + width
                else:
                    raise _yaml_error(f"the escape \\{nxt}", lineno, line)
                continue
            out.append(c)
            i += 1
        raise _yaml_error("a multi-line or unterminated quoted scalar",
                          lineno, line)
    if text == "{}":
        return {}
    if text == "[]":
        return []
    constructs = {"[": "a flow sequence", "{": "a flow mapping",
                  "&": "an anchor", "*": "an alias", "!": "a tag",
                  "|": "a block scalar", ">": "a block scalar",
                  "%": "a directive", "@": "a reserved indicator",
                  "`": "a reserved indicator", "?": "a complex key"}
    if head in constructs:
        raise _yaml_error(constructs[head], lineno, line)
    if ": " in text or text.endswith(":"):
        raise _yaml_error("a nested mapping on one line", lineno, line)
    return _resolve_plain(text, lineno, line)


def _strip_comment(line: str) -> str:
    """The line without its comment (a ``#`` at its start or after a
    space, outside quotes) and trailing spaces."""
    quote = None
    for i, c in enumerate(line):
        if quote:
            if c == quote:
                quote = None
        elif c in "'\"" and (i == 0 or line[i - 1] in " -:"):
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _split_key(content: str, lineno: int, line: str):
    """``key: value`` -> (key, value text) or None when not a mapping
    entry."""
    if content[0] in "'\"":
        end = content.find(content[0], 1)
        while content[0] == "'" and end >= 0 and \
                content[end + 1:end + 2] == "'":
            end = content.find("'", end + 2)
        if end < 0 or not content[end + 1:].startswith(":"):
            return None
        rest = content[end + 2:]
        key = _scalar(content[:end + 1], lineno, line)
    else:
        m = re.match(r"^(.*?):(?: |$)", content)
        if not m:
            return None
        rest = content[m.end():]
        if m.group(1).startswith("? "):
            raise _yaml_error("a complex key", lineno, line)
        key = _scalar(m.group(1), lineno, line)
    if not isinstance(key, (str, int, float, bool)) and key is not None:
        raise _yaml_error("a non-scalar key", lineno, line)
    return key, rest.strip()


def parse_yaml(text: str) -> Any:
    """Parse the block-style YAML subset described above; equal to
    ``yaml.safe_load`` on it, and raises on anything else."""
    lines = []  # (lineno, indent, content, raw line)
    for lineno, raw in enumerate(text.splitlines(), 1):
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise _yaml_error("tab indentation", lineno, raw)
        content = _strip_comment(raw)
        if not content.strip():
            continue
        if content.startswith(("---", "...")) and \
                content[3:4] in ("", " "):
            raise _yaml_error("a document marker", lineno, raw)
        indent = len(content) - len(content.lstrip(" "))
        lines.append((lineno, indent, content.strip(), raw))
    if not lines:
        return None
    pos = [0]

    def block(indent: int):
        lineno, ind, content, raw = lines[pos[0]]
        if content == "-" or content.startswith("- "):
            return sequence(ind)
        if _split_key(content, lineno, raw) is None:
            value = _scalar(content, lineno, raw)
            pos[0] += 1
            if pos[0] < len(lines) and lines[pos[0]][1] > ind:
                raise _yaml_error("a multi-line plain scalar", lineno, raw)
            return value
        return mapping(ind)

    def value_after(rest: str, ind: int, lineno: int, raw: str,
                    seq_ok: bool):
        """The value of an entry whose text after the indicator is
        ``rest``, at indentation ``ind``."""
        if rest:
            value = _scalar(rest, lineno, raw)
            pos[0] += 1
            if pos[0] < len(lines) and lines[pos[0]][1] > ind:
                raise _yaml_error("a multi-line plain scalar", lineno, raw)
            return value
        pos[0] += 1
        if pos[0] >= len(lines):
            return None
        nxt = lines[pos[0]]
        if nxt[1] > ind:
            return block(nxt[1])
        if seq_ok and nxt[1] == ind and (nxt[2] == "-"
                                         or nxt[2].startswith("- ")):
            return sequence(ind)  # yaml.dump's indentless sequence
        return None

    def mapping(ind: int) -> Dict[Any, Any]:
        out: Dict[Any, Any] = {}
        while pos[0] < len(lines):
            lineno, i, content, raw = lines[pos[0]]
            if i < ind:
                break
            if i > ind:
                raise _yaml_error("unexpected indentation", lineno, raw)
            if content == "-" or content.startswith("- "):
                break  # an indentless sequence ends with its mapping
            kv = _split_key(content, lineno, raw)
            if kv is None:
                raise _yaml_error("a line that is no mapping entry",
                                  lineno, raw)
            key, rest = kv
            if key in out:
                raise _yaml_error(f"the duplicate key {key!r}", lineno, raw)
            out[key] = value_after(rest, ind, lineno, raw, seq_ok=True)
        return out

    def sequence(ind: int) -> List[Any]:
        out: List[Any] = []
        while pos[0] < len(lines):
            lineno, i, content, raw = lines[pos[0]]
            if i != ind or not (content == "-" or content.startswith("- ")):
                if i > ind:
                    raise _yaml_error("unexpected indentation", lineno, raw)
                break
            rest = content[1:].lstrip(" ")
            if rest and _split_key(rest, lineno, raw) is not None:
                # "- key: value" opens a mapping at the key's column
                col = ind + (len(content) - len(rest))
                lines[pos[0]] = (lineno, col, rest, raw)
                out.append(mapping(col))
            elif rest.startswith("- ") or rest == "-":
                raise _yaml_error("a nested sequence on one line",
                                  lineno, raw)
            else:
                out.append(value_after(rest, ind, lineno, raw,
                                       seq_ok=False))
        return out

    result = block(lines[0][1])
    if pos[0] < len(lines):
        lineno, _, _, raw = lines[pos[0]]
        raise _yaml_error("unexpected indentation", lineno, raw)
    return result


def _dump_scalar(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):  # PyYAML's represent_float
        if v != v:
            return ".nan"
        if v in (math.inf, -math.inf):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return text
    if isinstance(v, str):
        if "\n" in v or "\r" in v:
            raise ValueError(f"YAML: multi-line strings are not supported "
                             f"by the port's YAML codec: {v!r}")
        plain = (v and v == v.strip() and v[0] not in "-?:,[]{}#&*!|>'\"%@`"
                 and ": " not in v and " #" not in v
                 and not v.endswith(":") and v.isprintable())
        if plain:
            try:
                plain = _resolve_plain(v, 0, v) == v
            except ValueError:
                plain = False
        return v if plain else "'" + v.replace("'", "''") + "'"
    raise ValueError(f"YAML: cannot write a {type(v).__name__} value")


def _dump(obj, indent: int, out: List[str]) -> None:
    pad = " " * indent
    if isinstance(obj, dict):
        for k in sorted(obj, key=str):  # yaml.dump sorts keys
            v = obj[k]
            if isinstance(v, (dict, list)) and v:
                out.append(f"{pad}{_dump_scalar(k)}:")
                _dump(v, indent + 2 if isinstance(v, dict) else indent, out)
            else:
                out.append(f"{pad}{_dump_scalar(k)}: {_dump_value(v)}")
    else:
        for v in obj:
            if isinstance(v, dict) and v:
                sub: List[str] = []
                _dump(v, indent + 2, sub)
                out.append(f"{pad}- {sub[0][indent + 2:]}")
                out.extend(sub[1:])
            elif isinstance(v, list) and v:
                raise ValueError("YAML: nested sequences are not supported "
                                 "by the port's YAML codec")
            else:
                out.append(f"{pad}- {_dump_value(v)}")


def _dump_value(v) -> str:
    if isinstance(v, dict):
        return "{}"
    if isinstance(v, (list, tuple)):
        return "[]"
    return _dump_scalar(v)


def dump_yaml(obj: Dict[str, Any]) -> str:
    """Write a mapping in the block style of
    ``yaml.dump(obj, default_flow_style=False)`` (sorted keys); the
    result reads back equal through :func:`parse_yaml` and through
    ``yaml.safe_load``."""
    if not isinstance(obj, dict):
        raise ValueError("YAML: the top level must be a mapping")
    out: List[str] = []
    _dump(obj, 0, out)
    return "\n".join(out) + "\n" if out else "{}\n"
