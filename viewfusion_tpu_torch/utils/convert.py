"""The port's denoisers and training state <-> the JAX package's trees.

Three name maps, one per denoiser family, chosen by the tree's shape in
one place (:func:`_map_entries`): the UNet's (the port keeps its own copy
of the name map of ``viewfusion_tpu/utils/torch_convert.py``), the
DiT's (``Dense_0``/``Dense_1`` <-> ``cond_mlp.0``/``cond_mlp.2``,
``patchify``, ``block_i/{adaLN, _MHAttention_0/{qkv, proj}, Dense_0,
Dense_1}`` <-> ``blocks.i.{adaLN, attn.qkv, attn.proj, fc1, fc2}``,
``final_adaLN``, ``unpatchify``; its LayerNorms hold no parameters) and
the ADM's, which the JAX package does not have: its tree nests the
port's module path, one dict a part (``input_blocks.1.0.in_layers.2``
<-> ``input_blocks/1/0/in_layers/2``), so that the ADM's run dirs and
checkpoints take the same file format.  Leaves map as:

  * conv kernel (kh, kw, I, O) <-> weight (O, I, kh, kw)
  * Dense kernel (I, O)        <-> Linear weight (O, I)
  * GroupNorm scale / bias     <-> weight / bias

and the training state, in the layout of the JAX ``TrainState``'s state
dict (what a JAX checkpoint file holds):

  * ``params``     <-> the denoiser's parameters (``{"params": {...}}``);
  * ``opt_state``  <-> ``torch.optim.Adam``'s state: optax's
    ``{"0": {"count", "mu", "nu"}, "1": {"count"}}`` with ``mu``/``nu``
    the ``exp_avg``/``exp_avg_sq`` trees and both counts the updates made;
  * ``step``       <-> ``Trainer.step`` (int32, shape ());
  * ``ema_params`` <-> the EMA shadow (``{}`` without EMA).

JAX-side trees are nested dicts of numpy arrays (anything ``np.asarray``
takes); the port's side stays torch.  Moments map like the weights they
belong to, since both are elementwise in the parameter.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["unet_state_dict_from_jax", "unet_params_to_jax",
           "trainer_state_to_jax", "load_trainer_state", "jax_layout_axes"]

# kind -> ((torch suffix, JAX leaf, torch->JAX axes), ...)
_LEAVES = {
    "linear": (("weight", "kernel", (1, 0)), ("bias", "bias", None)),
    "conv": (("weight", "kernel", (2, 3, 1, 0)), ("bias", "bias", None)),
    "norm": (("weight", "scale", None), ("bias", "bias", None)),
}
_INVERSE = {(1, 0): (1, 0), (2, 3, 1, 0): (3, 2, 0, 1)}

# (torch module prefix, JAX module path, kind, optional)
_Entry = Tuple[str, Tuple[str, ...], str, bool]


def _entries(num_mults: int, res_blocks: int) -> List[_Entry]:
    out: List[_Entry] = []

    def block(dst, src):
        out.append((f"{dst}.block.0", src + ("GroupNorm_0",), "norm", False))
        out.append((f"{dst}.block.3", src + ("Conv_0",), "conv", False))

    def block_with_attn(dst, src):
        r = src + ("ResnetBlock_0",)
        block(f"{dst}.res_block.block1", r + ("Block_0",))
        block(f"{dst}.res_block.block2", r + ("Block_1",))
        out.append((f"{dst}.res_block.noise_func.noise_func.0",
                    r + ("FeatureWiseAffine_0", "noise_func"), "linear",
                    False))
        out.append((f"{dst}.res_block.res_conv", r + ("res_conv",), "conv",
                    True))
        a = src + ("SelfAttention_0",)
        out.append((f"{dst}.attn.norm", a + ("GroupNorm_0",), "norm", True))
        out.append((f"{dst}.attn.qkv", a + ("qkv",), "conv", True))
        out.append((f"{dst}.attn.out", a + ("out",), "conv", True))

    out.append(("noise_level_mlp.0", ("noise_mlp_0",), "linear", False))
    out.append(("noise_level_mlp.2", ("noise_mlp_1",), "linear", False))
    out.append(("downs.0", ("stem",), "conv", False))
    idx = 1
    for ind in range(num_mults):
        for blk in range(res_blocks):
            block_with_attn(f"downs.{idx}", (f"down_{ind}_{blk}",))
            idx += 1
        if ind != num_mults - 1:
            out.append((f"downs.{idx}.conv", (f"downsample_{ind}", "Conv_0"),
                        "conv", False))
            idx += 1
    block_with_attn("mid.0", ("mid_0",))
    block_with_attn("mid.1", ("mid_1",))
    idx = 0
    for ind in reversed(range(num_mults)):
        for blk in range(res_blocks + 1):
            block_with_attn(f"ups.{idx}", (f"up_{ind}_{blk}",))
            idx += 1
        if ind >= 1:
            out.append((f"ups.{idx}.conv", (f"upsample_{ind}", "Conv_0"),
                        "conv", False))
            idx += 1
    block("final_conv", ("final_conv",))
    return out


def _dit_entries(depth: int) -> List[_Entry]:
    out: List[_Entry] = [
        ("cond_mlp.0", ("Dense_0",), "linear", False),
        ("cond_mlp.2", ("Dense_1",), "linear", False),
        ("patchify", ("patchify",), "conv", False),
    ]
    for i in range(depth):
        src = f"block_{i}"
        attn = (src, "_MHAttention_0")
        out += [(f"blocks.{i}.adaLN", (src, "adaLN"), "linear", False),
                (f"blocks.{i}.attn.qkv", attn + ("qkv",), "linear", False),
                (f"blocks.{i}.attn.proj", attn + ("proj",), "linear", False),
                (f"blocks.{i}.fc1", (src, "Dense_0"), "linear", False),
                (f"blocks.{i}.fc2", (src, "Dense_1"), "linear", False)]
    out += [("final_adaLN", ("final_adaLN",), "linear", False),
            ("unpatchify", ("unpatchify",), "linear", False)]
    return out


# the ADM's layers that are not convolutions, by the end of their prefix
_ADM_KINDS = {"in_layers.0": "norm", "out_layers.0": "norm", "norm": "norm",
              "out.0": "norm", "time_embed.0": "linear",
              "time_embed.2": "linear", "emb_layers.1": "linear",
              "qkv": "linear", "proj": "linear"}


def _adm_entries(names) -> List[_Entry]:
    """The ADM's map from the port's ``state_dict`` names: one entry a
    layer, its JAX path the parts of its prefix."""
    out: List[_Entry] = []
    for name in names:
        prefix = name.rsplit(".", 1)[0]
        if out and out[-1][0] == prefix:
            continue
        kind = next((k for tail, k in _ADM_KINDS.items()
                     if prefix == tail or prefix.endswith("." + tail)),
                    "conv")
        out.append((prefix, tuple(prefix.split(".")), kind, False))
    return out


def _tree_layers(tree, path=()):
    """The ``state_dict`` names of a JAX-side tree that nests module
    paths: every node that holds a ``kernel`` or a ``scale``."""
    if "kernel" in tree or "scale" in tree:
        prefix = ".".join(path)
        return [f"{prefix}.weight", f"{prefix}.bias"]
    return [n for k, v in tree.items() if isinstance(v, dict)
            for n in _tree_layers(v, path + (k,))]


def _map_entries(keys, jax_side: bool) -> List[_Entry]:
    """The name map for a tree: ``keys`` are the top-level names of a JAX
    params tree (``jax_side``; the tree itself for an ADM's) or the port's
    ``state_dict`` names.  A tree with a ``time_embed`` layer is an
    ADM's, with a ``patchify`` layer a DiT's, else a UNet's."""
    if jax_side and isinstance(keys, dict) and "time_embed" in keys:
        return _adm_entries(_tree_layers(keys))
    keys = list(keys)
    if not jax_side and any(k.startswith("time_embed.") for k in keys):
        return _adm_entries(keys)
    if jax_side:
        is_dit = "patchify" in keys
        blocks = {int(m.group(1)) for m in
                  (re.fullmatch(r"block_(\d+)", k) for k in keys) if m}
    else:
        is_dit = any(k.startswith("patchify.") for k in keys)
        blocks = {int(m.group(1)) for m in
                  (re.match(r"blocks\.(\d+)\.", k) for k in keys) if m}
    if is_dit:
        return _dit_entries(max(blocks) + 1 if blocks else 0)
    return _entries(*(_jax_structure(keys) if jax_side
                      else _torch_structure(keys)))


def jax_layout_axes(names) -> Dict[str, Optional[Tuple[int, ...]]]:
    """Per ``state_dict`` name, the axes that permute the port's tensor
    into its JAX leaf (None: the same layout)."""
    out: Dict[str, Optional[Tuple[int, ...]]] = {}
    for prefix, _, kind, _ in _map_entries(names, jax_side=False):
        for t_leaf, _, axes in _LEAVES[kind]:
            out[f"{prefix}.{t_leaf}"] = axes
    return out


def _get(tree, path):
    for k in path:
        if not isinstance(tree, dict) or k not in tree:
            return None
        tree = tree[k]
    return tree


def _jax_structure(p) -> Tuple[int, int]:
    downs = sorted({tuple(map(int, m.groups())) for m in
                    (re.fullmatch(r"down_(\d+)_(\d+)", k) for k in p) if m})
    if not downs:
        raise ValueError("not a UNet or DiT params tree (no down_<i>_<j> "
                         "blocks, no patchify)")
    return max(i for i, _ in downs) + 1, max(j for _, j in downs) + 1


def _torch_structure(names) -> Tuple[int, int]:
    downs = {int(m.group(1)) for m in
             (re.match(r"downs\.(\d+)\.", k) for k in names) if m}
    samples = {int(m.group(1)) for m in
               (re.match(r"downs\.(\d+)\.conv\.", k) for k in names) if m}
    if not downs:
        raise ValueError("not a UNet or DiT state_dict (no downs.<i> "
                         "modules, no patchify)")
    num_mults = len(samples) + 1
    # downs = the stem, num_mults * res_blocks blocks, num_mults - 1 convs
    return num_mults, (len(downs) - num_mults) // num_mults


def _jax_to_torch_tree(p: Dict[str, Any], convert: Callable
                       ) -> Dict[str, Any]:
    sd: Dict[str, Any] = {}
    for prefix, path, kind, optional in _map_entries(p, jax_side=True):
        src = _get(p, path)
        if src is None:
            if optional:
                continue
            raise KeyError(f"JAX params lack {'/'.join(path)}")
        for t_leaf, j_leaf, axes in _LEAVES[kind]:
            if j_leaf in src:
                a = np.asarray(src[j_leaf])
                if axes is not None:
                    a = np.transpose(a, _INVERSE[axes])
                sd[f"{prefix}.{t_leaf}"] = convert(a)
            elif t_leaf == "weight" or kind != "conv":
                raise KeyError(f"JAX params lack {'/'.join(path)}/{j_leaf}")
    return sd


def _torch_to_jax_tree(sd: Dict[str, Any], convert: Callable
                       ) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    used = set()
    for prefix, path, kind, optional in _map_entries(sd, jax_side=False):
        if f"{prefix}.weight" not in sd:
            if optional:
                continue
            raise KeyError(f"state_dict lacks {prefix}.weight")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        for t_leaf, j_leaf, axes in _LEAVES[kind]:
            name = f"{prefix}.{t_leaf}"
            if name in sd:
                v = sd[name]
                node[j_leaf] = convert(v if axes is None else v.permute(axes))
                used.add(name)
    extra = set(sd) - used
    if extra:
        raise KeyError(f"state_dict entries with no JAX counterpart: "
                       f"{sorted(extra)[:5]}")
    return tree


def unet_state_dict_from_jax(params: Dict[str, Any]
                             ) -> Dict[str, torch.Tensor]:
    """JAX ``{"params": {...}}`` (or the inner tree) of a UNet or a DiT ->
    the port's ``state_dict`` of that denoiser (f32 CPU tensors)."""
    p = params["params"] if "params" in params else params
    return _jax_to_torch_tree(
        p, lambda a: torch.from_numpy(np.array(a, dtype=np.float32)))


def unet_params_to_jax(state_dict: Dict[str, torch.Tensor]
                       ) -> Dict[str, Any]:
    """The port's UNet or DiT ``state_dict`` -> JAX ``{"params": {...}}``
    of numpy f32 arrays."""
    return {"params": _torch_to_jax_tree(
        state_dict,
        lambda t: np.ascontiguousarray(
            t.detach().cpu().numpy().astype(np.float32)))}


def _named_params(trainer) -> Dict[str, torch.Tensor]:
    return dict(trainer.model.unet.named_parameters())


def _count(n: int) -> np.ndarray:
    return np.asarray(n, np.int32)


def trainer_state_to_jax(trainer) -> Dict[str, Any]:
    """The ``Trainer``'s state as the JAX ``TrainState`` state dict.  Its
    leaves are torch tensors on the trainer's device, in the JAX layout
    (possibly transposed views); the checkpoint writer copies them to
    the host.  Under ZeRO-1 the moments are gathered whole over the data
    group, so every rank must call it."""
    named = _named_params(trainer)
    as_is = (lambda t: t.detach())
    params = {"params": _torch_to_jax_tree(named, as_is)}
    moments = [{"params": _torch_to_jax_tree(m, as_is)}
               for m in trainer.adam_moments()]
    ema: Dict[str, Any] = {}
    if trainer.ema is not None:
        ema = {"params": _torch_to_jax_tree(
            dict(zip(named, trainer.ema)), as_is)}
    count = _count(trainer.step)
    return {"params": params,
            "opt_state": {"0": {"count": count, "mu": moments[0],
                                "nu": moments[1]},
                          "1": {"count": count}},
            "step": count, "ema_params": ema}


def _copy_into(dst: List[torch.Tensor], names: List[str],
               src: Dict[str, torch.Tensor], what: str) -> None:
    for name, t in zip(names, dst):
        v = src[name]
        if tuple(v.shape) != tuple(t.shape):
            raise ValueError(f"{what} {name}: shape {tuple(v.shape)} in the "
                             f"file, {tuple(t.shape)} in the model")
    with torch.no_grad():
        for name, t in zip(names, dst):
            t.copy_(src[name])


def load_trainer_state(trainer, state: Dict[str, Any],
                       fields: Optional[List[str]] = None) -> None:
    """Set the ``Trainer``'s state from a JAX ``TrainState`` state dict
    (numpy leaves).  ``fields`` names the top-level fields to take (all
    four by default); a ``Trainer`` without EMA ignores ``ema_params``.
    Raises KeyError or ValueError when a field does not match the
    model."""
    fields = list(state) if fields is None else fields
    named = _named_params(trainer)
    names, params = list(named), list(named.values())

    def torch_tree(tree):
        p = tree["params"] if "params" in tree else tree
        return _jax_to_torch_tree(
            p, lambda a: torch.from_numpy(np.array(a, dtype=np.float32)))

    if "params" in fields:
        _copy_into(params, names, torch_tree(state["params"]), "params")
    if "ema_params" in fields and trainer.ema is not None:
        _copy_into(trainer.ema, names, torch_tree(state["ema_params"]),
                   "ema_params")
    if "opt_state" in fields:
        adam = state["opt_state"]["0"]
        count = int(np.asarray(adam["count"]))
        mu, nu = torch_tree(adam["mu"]), torch_tree(adam["nu"])
        for name, p in named.items():
            for key, src in (("exp_avg", mu), ("exp_avg_sq", nu)):
                if tuple(src[name].shape) != tuple(p.shape):
                    raise ValueError(f"opt_state {key} {name}: shape "
                                     f"{tuple(src[name].shape)} in the file")
        trainer.load_adam_moments(count, mu, nu)
    if "step" in fields:
        trainer.step = int(np.asarray(state["step"]))
