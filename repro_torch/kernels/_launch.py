"""Argument checks, the CUDA stream and the C launchers shared by the ctypes kernel wrappers."""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build


def check_operand(name: str, t: torch.Tensor, shape: tuple | None = None,
                  device: torch.device | None = None) -> None:
    """Raise unless ``t`` is a contiguous f32 tensor, of ``shape`` and on ``device`` where given."""
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} has dtype {t.dtype}, expected torch.float32")
    if shape is not None and t.shape != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stream(device: torch.device) -> int:
    """The current CUDA stream's handle on ``device``; inside a graph capture, the capturing one."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def raise_on_error(kernel: str, code: int) -> None:
    if code != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError {code}")


class CFunction:
    """The C launcher ``symbol`` of ``csrc/<source>.cu``: built, loaded and typed on its first call.

    Pointers and the stream go in as Python ints (``c_void_p`` in
    ``argtypes``); the launcher returns its cudaError code.
    """

    def __init__(self, source: str, symbol: str, argtypes: list):
        self.source, self.symbol, self.argtypes = source, symbol, argtypes
        self._fn = None

    def __call__(self, *args) -> int:
        fn = self._fn
        if fn is None:
            fn = getattr(build.library(self.source), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return fn(*args)
