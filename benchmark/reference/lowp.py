"""The lower-precision control: the reference with every operand of its convs
and matmuls, weights and activations alike, rounded to float8 (e4m3) with one
scale per tensor, the products then taken in float32. The configurations
state bfloat16, and 8-bit floats are the next precision below it, the step a
later change would be tempted to take. The benchmark's check has to find this
control not correct (``tools/calibrate.py`` reads it on the card)."""

from __future__ import annotations

import torch

FP8_MAX = 448.0  # largest finite float8 e4m3fn


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 at the scale that takes its largest
    magnitude to ``FP8_MAX``, returned in float32."""
    x = x.float()
    amax = x.abs().max()
    if not bool(amax > 0):
        return x
    scale = amax / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bfloat16, in float32: the configurations' own
    precision, for reading what rounding alone gives."""
    return x.to(torch.bfloat16).float()


ROUNDINGS = {"fp8": fp8, "bf16": bf16}
