"""K4, the ADMM shrink step on Hopper (twin of ``repro.kernels.soft_threshold``).

``out = sign(x) * max(|x| - t, 0)`` elementwise: one read and one write
per element, bound by device-memory bytes, and at the scan solver's
shapes shorter on the card than its launch from Python.  The CUDA C++
source and its design notes are in ``csrc/soft_threshold.cu``; this
module checks the operands and launches it through one C call, with no
copy of ``t`` when it already is the kernel's per-column row.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _launch

_SHRINK = _launch.CFunction("soft_threshold", "soft_threshold_launch",
                            [ctypes.c_void_p] * 3 + [ctypes.c_float] + [ctypes.c_int] * 3
                            + [ctypes.c_void_p])


def soft_threshold_cuda(x: torch.Tensor, t) -> torch.Tensor:
    """Launch K4 on a contiguous f32 CUDA tensor ``x`` of shape (..., r, c) or (c,).

    ``t`` is a Python number, or an f32 tensor on ``x``'s card that
    broadcasts to ``x.shape[:-2] + (1, c)`` (one threshold per machine
    and column).
    """
    if not x.is_cuda:
        raise ValueError(f"soft_threshold_cuda needs a CUDA tensor, got {x.device}")
    _launch.check_operand("x", x)
    numel = x.numel()
    if numel >= 2**31:
        raise ValueError(f"soft_threshold_cuda takes fewer than 2^31 elements, got {numel}")
    out = torch.empty_like(x)
    if numel == 0:
        return out
    c = x.shape[-1] if x.ndim else 1
    rc = c * x.shape[-2] if x.ndim >= 2 else c
    if isinstance(t, (int, float)):
        t_ptr, t_scalar = None, t
    else:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"t must be a number or a tensor, got {type(t).__name__}")
        if t.dtype != torch.float32 or t.device != x.device:
            raise TypeError("t must be a float32 tensor on x's device")
        rows = (*x.shape[:-2], 1, c) if x.ndim >= 2 else (c,)
        if t.shape != rows or not t.is_contiguous():
            t = t.expand(rows).contiguous()
        t_ptr, t_scalar = t.data_ptr(), 0.0
    code = _SHRINK(x.data_ptr(), t_ptr, out.data_ptr(), t_scalar, numel, c, rc,
                   _launch.stream(x.device))
    _launch.raise_on_error("soft_threshold", code)
    return out
