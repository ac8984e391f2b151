"""The plain reference: float32 PyTorch with TF32 off, written from the
published descriptions.  It imports nothing of ``viewfusion_tpu_torch``
(and no JAX), calls none of the program's kernels or plain versions, and
takes nothing the program made: it is given the harness's weights and
inputs and works the rest out again."""
