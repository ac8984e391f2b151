"""Where the reference rounds: the identity in float32 (the reference),
or a rounding of every matrix-product operand to a lower precision (the
control that ``correct`` has to refuse).

``fp8`` rounds each operand of every convolution, linear layer and
attention product to float8 e4m3 with a per-tensor scale (its amax to
448, the format's largest), the usual way a program would run a bf16
model in fp8.  The products themselves accumulate in float32.  Gradients
pass the rounding unchanged (a straight-through rounding): the backward
products take the rounded operands the forward saved and float32
gradients."""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def no_tf32() -> None:
    """Float32 products in float32, not TF32 (the reference's precision)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Precision:
    """``op(x)`` rounds an operand of a matrix product."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def op(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "float32":
            return x
        with torch.no_grad():
            scale = E4M3_MAX / x.abs().amax().clamp_min(1e-30)
            q = (x * scale).to(torch.float8_e4m3fn).float() / scale
        return x + (q - x).detach() if x.requires_grad else q


FLOAT32 = Precision("float32")
