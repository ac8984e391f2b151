"""Convert the reference's PyTorch checkpoints, such as the published
``best_model_all.pt``, into a run dir (the port's counterpart of
``viewfusion_tpu/utils/torch_convert.py``, writing the same files).

The reference saves ``{"model": <ViewFusion state_dict>, "optimizer":
<Adam state>, "it", "t", "run_id", "ssim", "psnr"}``.  Its UNet's entries
are under ``denoise_fn.``; the port's UNet has the reference's module
names, so with the prefix stripped they load into it as they are
(:func:`convert_unet_state_dict`).  The ViewFusion schedule buffers
(:data:`SCHEDULE_BUFFERS`) lie outside the prefix and are dropped: the
config's beta schedule gives them again.

:func:`convert_checkpoint_file` writes ``best_model_all.msgpack``, the
params tree through the port's name map (``utils/convert.py``) with each
array in its stored dtype, and the payload's other entries as extras
(numbers as floats: ``it`` too); and ``config.yaml`` when ``out_dir`` is
new (``training/checkpoint.py``).  The optimizer state is dropped: a
resumed run starts a fresh Adam, as with the JAX converter.  The file is
read with ``torch.load(weights_only=True)``, numpy's scalar and dtype
globals allowed, so tensors, Python scalars and numpy scalars load and
any other global raises with its name.

    python -m viewfusion_tpu_torch.utils.torch_convert best_model_all.pt out/ [config.yaml]

needs no JAX, PyYAML or msgpack; without a config it reads
``configs/small-tpu-4.yaml`` under the working directory, as the JAX
converter does.  Then
``python -m viewfusion_tpu_torch.cli -s out -e`` evaluates the weights and
``python -m viewfusion_tpu_torch.serving -s out`` serves them.
"""

from __future__ import annotations

import sys
from typing import Any, Dict

import numpy as np
import torch

from viewfusion_tpu_torch.config import Config, UNetConfig, load_config
from viewfusion_tpu_torch.models.unet import UNet
from viewfusion_tpu_torch.training.checkpoint import Checkpoint
from viewfusion_tpu_torch.utils.convert import _torch_to_jax_tree

__all__ = ["SCHEDULE_BUFFERS", "convert_unet_state_dict",
           "convert_checkpoint_file", "main"]

PREFIX = "denoise_fn."
# the reference ViewFusion's buffers beside denoise_fn.* (model/view_fusion.py)
SCHEDULE_BUFFERS = ("gammas", "sqrt_recip_gammas", "sqrt_recipm1_gammas",
                    "posterior_log_variance_clipped", "posterior_mean_coef1",
                    "posterior_mean_coef2")


def _numpy_globals() -> list:
    """numpy's scalar constructor (under its numpy 1 and numpy 2 module
    names) and its dtypes: what pickled numpy scalars need."""
    scalar = np.float64(0).__reduce__()[0]
    dtypes = [c for c in vars(np.dtypes).values()
              if isinstance(c, type) and issubclass(c, np.dtype)]
    return [np.dtype, *dtypes, (scalar, "numpy.core.multiarray.scalar"),
            (scalar, "numpy._core.multiarray.scalar")]


def _load_reference(pt_path: str) -> Dict[str, Any]:
    """The payload of a reference ``.pt``, on the CPU.  Raises
    ``pickle.UnpicklingError`` naming the global when the file needs one
    beyond tensors, Python containers and scalars, and numpy scalars."""
    with torch.serialization.safe_globals(_numpy_globals()):
        return torch.load(pt_path, map_location="cpu", weights_only=True)


def _unet_entries(sd: Dict[str, Any], unet_config: UNetConfig,
                  prefix: str) -> Dict[str, torch.Tensor]:
    """The entries of ``sd`` that a UNet of ``unet_config`` holds, prefix
    stripped, as stored.  Entries outside the prefix are ignored; a
    missing one raises KeyError naming it, a misshapen one ValueError."""
    with torch.device("meta"):
        shapes = {k: v.shape for k, v in
                  UNet(unet_config).state_dict().items()}
    out = {}
    for name, shape in shapes.items():
        key = prefix + name
        if key not in sd:
            raise KeyError(f"{key} is missing from the checkpoint")
        v = torch.as_tensor(sd[key])
        if v.shape != shape:
            raise ValueError(f"{key}: shape {tuple(v.shape)} in the "
                             f"checkpoint, {tuple(shape)} in the config's "
                             "UNet")
        out[name] = v
    return out


def convert_unet_state_dict(sd: Dict[str, Any], unet_config: UNetConfig,
                            prefix: str = PREFIX
                            ) -> Dict[str, torch.Tensor]:
    """A reference state_dict (tensors or arrays) -> the port's ``UNet``
    state_dict: the reference names with ``prefix`` stripped, as f32
    tensors, which ``UNet(unet_config).load_state_dict(strict=True)``
    takes and ``ViewFusionService.from_state_dict`` serves."""
    return {k: v.float() for k, v in
            _unet_entries(sd, unet_config, prefix).items()}


def convert_checkpoint_file(pt_path: str, out_dir: str,
                            config: Config) -> str:
    """Convert a reference ``.pt`` into the run dir ``out_dir``; returns
    the msgpack's path."""
    payload = _load_reference(pt_path)
    # each array in its stored dtype, as the JAX converter keeps it
    params = {"params": _torch_to_jax_tree(
        _unet_entries(payload["model"], config.unet, PREFIX),
        lambda t: np.ascontiguousarray(t.numpy()))}
    extra = {k: (float(v) if hasattr(v, "__float__") else v)
             for k, v in payload.items() if k not in ("model", "optimizer")}
    Checkpoint(out_dir, config_yaml=config.to_yaml()).save(
        "best_model_all.msgpack", {"params": params}, **extra)
    return f"{out_dir}/best_model_all.msgpack"


def main(argv=None) -> None:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 2:
        print("usage: python -m viewfusion_tpu_torch.utils.torch_convert "
              "<checkpoint.pt> <out_dir> [config.yaml]")
        raise SystemExit(2)
    config = load_config(argv[2] if len(argv) > 2
                         else "configs/small-tpu-4.yaml")
    print("wrote", convert_checkpoint_file(argv[0], argv[1], config))


if __name__ == "__main__":
    main()
