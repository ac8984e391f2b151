"""The benchmark of ``viewfusion_tpu_torch`` on an NVIDIA H100 (see
README.md).  Nothing here imports JAX or the JAX package."""
