"""ViewFusion on PyTorch and CUDA (NVIDIA Hopper).

A port of the JAX package ``viewfusion_tpu`` that keeps its public
layouts (NHWC images, ``y_cond`` as (B, N, H, W, C)) and its
reference-compatible UNet ``state_dict`` names.  The hot GroupNorm(+SiLU)
and spatial-attention ops are CUDA C++ kernels built for ``sm_90a`` at
first use (``_native.py``); on CPU tensors their plain PyTorch versions
run instead.  This package imports nothing of ``viewfusion_tpu``.
"""

from viewfusion_tpu_torch.config import Config, load_config

__all__ = ["Config", "load_config"]
