"""K1, the mean-centered Gram kernel on Hopper (twin of ``repro.kernels.gram``).

``(X - mu)^T (X - mu)`` per machine, the O(N d^2 / m) hot spot of the
pooled covariance.  The CUDA C++ source and its design notes are in
``csrc/gram.cu``; this module checks the operands and launches it.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _launch

_GRAM = _launch.CFunction("gram", "gram_launch",
                          [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def gram_cuda(x: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """Launch K1: x (m, n, d), mu (m, d) on the card -> (m, d, d) f32."""
    if x.ndim != 3:
        raise ValueError(f"x must be (m, n, d), got shape {tuple(x.shape)}")
    m, n, d = x.shape
    if m < 1 or n < 1 or d < 1:
        raise ValueError(f"empty operand: x has shape {tuple(x.shape)}")
    if not x.is_cuda:
        raise ValueError(f"gram_cuda needs CUDA tensors, got {x.device}")
    dev = x.device
    _launch.check_operand("x", x)
    _launch.check_operand("mu", mu, (m, d), dev)
    out = torch.empty((m, d, d), dtype=torch.float32, device=dev)
    code = _GRAM(x.data_ptr(), mu.data_ptr(), out.data_ptr(), m, n, d, _launch.stream(dev))
    _launch.raise_on_error("gram", code)
    return out
