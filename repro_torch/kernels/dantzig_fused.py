"""K2, the fused fixed-iteration ADMM solve on Hopper (twin of ``repro.kernels.dantzig_fused``).

The CUDA C++ source and its design notes are in ``csrc/dantzig_fused.cu``.
This module holds the Hopper blocking model that sizes the kernel's
column blocks, and the launcher.

Blocking model.  The TPU kernel keeps A and Q resident in VMEM next to
the column block, so its model (``fused_block_vmem_bytes`` /
``pick_block_k`` in the reference) has a capacity cliff: when A and Q
alone exceed the budget, the dispatcher falls back to the scan solver
(d >~ 1250 on the TPU).  On Hopper A and Q stream from L2, so only the
(d, W) column state sits in shared memory: seven (d, W) f32 arrays
(z, w, u1, u2, b and two product buffers) plus per-column lam and 1/rho,
against the 227 KB a block may use.  ``W`` is one of the kernel's
compile-time column tiles.  There is no fallback: ``cfg.fused=True``
runs this kernel at every d where one column fits (d <~ 8300), and
raises beyond.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _launch, build

# Dynamic shared memory one block may use on an H100 (232,448 bytes).
SMEM_BYTES = 227 * 1024
# The kernel's compile-time column tiles (csrc/dantzig_fused.cu).
TILE_WIDTHS = (1, 8, 16, 24, 32, 40, 48)


class AdmmState(NamedTuple):
    """The full two-block ADMM state of a (..., d, k) batch."""

    z: torch.Tensor  # box-constrained copy of A beta - b
    w: torch.Tensor  # sparse copy of beta (the solution estimate)
    u1: torch.Tensor  # scaled dual for A beta - z = b
    u2: torch.Tensor  # scaled dual for beta - w = 0

    @classmethod
    def zeros(cls, *shape: int, device: str | torch.device = "cpu") -> "AdmmState":
        z = torch.zeros(shape, dtype=torch.float32, device=device)
        return cls(z, z, z, z)


def fused_block_smem_bytes(d: int, width: int) -> int:
    """Shared memory of one block of the kernel with column tile ``width``."""
    return 4 * (7 * d * width + 2 * width)


def max_block_k(d: int, budget: int = SMEM_BYTES) -> int:
    """The widest column tile that fits ``budget`` at this d; raises when none does."""
    fits = [w for w in TILE_WIDTHS if fused_block_smem_bytes(d, w) <= budget]
    if not fits:
        raise ValueError(
            f"dantzig_fused: one column's state at d={d} needs "
            f"{fused_block_smem_bytes(d, 1)} bytes of shared memory, over the "
            f"budget of {budget}")
    return fits[-1]


def pick_block_k(d: int, k: int, budget: int = SMEM_BYTES) -> int:
    """Columns per block: the whole batch when it fits, else equal blocks of at most the widest tile."""
    widest = max_block_k(d, budget)
    if k <= widest:
        return k
    blocks = -(-k // widest)
    return -(-k // blocks)


def tile_width(bk: int) -> int:
    """The narrowest compile-time tile that holds ``bk`` columns."""
    for w in TILE_WIDTHS:
        if w >= bk:
            return w
    raise ValueError(f"block of {bk} columns is wider than the widest tile {TILE_WIDTHS[-1]}")


def _lib():
    fn = build.library("dantzig_fused").dantzig_fused_launch
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                   + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def dantzig_fused_cuda(a, q, inv_eig, b, lam, rho, *, iters: int, alpha: float,
                       block_k: int | None = None) -> torch.Tensor:
    """Launch K2 once for every machine and column block.

    a, q: (m, d, d); inv_eig: (m, d); b: (m, d, k); lam, rho: (m, k);
    all f32 on one card.  ``block_k`` None sizes the blocks with
    :func:`pick_block_k`.  Returns w: (m, d, k).
    """
    if b.ndim != 3:
        raise ValueError(f"b must be (m, d, k), got shape {tuple(b.shape)}")
    m, d, k = b.shape
    dev = b.device
    if dev.type != "cuda":
        raise ValueError(f"dantzig_fused_cuda needs CUDA tensors, got {dev}")
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    for name, t, shape in (("a", a, (m, d, d)), ("q", q, (m, d, d)),
                           ("inv_eig", inv_eig, (m, d)), ("b", b, (m, d, k)),
                           ("lam", lam, (m, k)), ("rho", rho, (m, k))):
        _launch.check_operand(name, t, shape, dev)
    widest = max_block_k(d)
    bk = pick_block_k(d, k) if block_k is None else max(1, min(block_k, k, widest))
    width = tile_width(bk)
    at = a.mT.contiguous()
    qt = q.mT.contiguous()
    out = torch.empty((m, d, k), dtype=torch.float32, device=dev)
    code = _lib()(*(_launch.ptr(t) for t in (at, q, qt, inv_eig, b, lam, rho, out)),
                  m, d, k, bk, width, iters, alpha, 1.0 - alpha, _launch.stream(dev))
    _launch.raise_on_error("dantzig_fused", code)
    return out
