"""The reference's matrix product, in the configurations' precision and in the control's.

The configurations state float32 with TF32 off.  The nearest lower
precision is TF32: operands rounded to 10 explicit mantissa bits (round
to nearest, ties away from zero, as the tensor cores' conversion does),
products accumulated in float32.  :func:`mm_tf32` emulates it the same
way on the CPU and on the card, so the control reads alike on both.
"""

from __future__ import annotations

import torch


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, b)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32, finite) rounded to TF32's 10-bit mantissa."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def mm_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(tf32(a), tf32(b))
