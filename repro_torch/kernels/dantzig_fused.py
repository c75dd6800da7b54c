"""K2 and K3, the fused ADMM solves on Hopper (twin of ``repro.kernels.dantzig_fused``).

K2 runs a fixed number of iterations from the zero state; K3 resumes
from a warm :class:`AdmmState`, hands the final state back, and with a
``tol`` stops each column block once its max scaled residual is at most
``tol``.  The CUDA C++ source and its design notes are in
``csrc/dantzig_fused.cu``: both kernels are instantiations of one
template.  This module holds the Hopper blocking model that sizes the
kernels' column blocks, and the launchers.

Blocking model.  The TPU kernel keeps A and Q resident in VMEM next to
the column block, so its model (``fused_block_vmem_bytes`` /
``pick_block_k`` in the reference) has a capacity cliff: when A and Q
alone exceed the budget, the dispatcher falls back to the scan solver
(d >~ 1250 on the TPU).  On Hopper A and Q stream from L2, so only the
(d, W) column state sits in shared memory: seven (d, W) f32 arrays
(z, w, u1, u2, b and two product buffers) plus per-column lam and 1/rho,
against the 227 KB a block may use.  K3 (``state_io``) streams its state
through global memory and keeps its chunk deltas in the two product
buffers, so it adds only a per-column rho row and a reduction scratch:
both kernels take 40-column tiles at d = 200.  ``W`` is one of the
kernels' compile-time column tiles.  There is no fallback:
``cfg.fused=True`` runs these kernels at every d where one column fits
(d <~ 8300), and raises beyond.

K3 gates each block on its own, as the TPU kernel does, so with ``tol``
set a column's iteration count depends on its block-mates: the blocking
is computed the same way on every device (:func:`resolve_block_k`), and
the CPU's plain version gates the same blocks.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _launch

# Dynamic shared memory one block may use on an H100 (232,448 bytes).
SMEM_BYTES = 227 * 1024
# The kernels' compile-time column tiles (csrc/dantzig_fused.cu).
TILE_WIDTHS = (1, 8, 16, 24, 32, 40, 48)
# K3's block-wide max reduction: one partial per warp of 256 threads, and the result.
REDUCE_FLOATS = 256 // 32 + 1


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


class FusedSolveResult(NamedTuple):
    """K3's outputs."""

    beta: torch.Tensor  # (..., d, k) the sparse ADMM copy w
    state: AdmmState  # full final state, resumable
    iters: torch.Tensor  # (..., num_blocks) int32 executed iterations per block


def fused_block_smem_bytes(d: int, width: int, state_io: bool = False) -> int:
    """Shared memory of one block with column tile ``width``: K2, or K3 with ``state_io``."""
    rows = 3 * width + REDUCE_FLOATS if state_io else 2 * width
    return 4 * (7 * d * width + rows)


def max_block_k(d: int, budget: int = SMEM_BYTES, state_io: bool = False) -> int:
    """The widest column tile that fits ``budget`` at this d; raises when none does."""
    fits = [w for w in TILE_WIDTHS if fused_block_smem_bytes(d, w, state_io) <= budget]
    if not fits:
        raise ValueError(
            f"dantzig_fused: one column's state at d={d} needs "
            f"{fused_block_smem_bytes(d, 1, state_io)} bytes of shared memory, over the "
            f"budget of {budget}")
    return fits[-1]


def pick_block_k(d: int, k: int, budget: int = SMEM_BYTES, state_io: bool = False) -> int:
    """Columns per block: the whole batch when it fits, else equal blocks of at most the widest tile."""
    widest = max_block_k(d, budget, state_io)
    if k <= widest:
        return k
    blocks = -(-k // widest)
    return -(-k // blocks)


def resolve_block_k(d: int, k: int, block_k: int | None, state_io: bool = False) -> int:
    """The columns per block a launch uses: the model's choice, or ``block_k`` capped to fit."""
    if block_k is None:
        return pick_block_k(d, k, state_io=state_io)
    return max(1, min(block_k, k, max_block_k(d, state_io=state_io)))


def tile_width(bk: int) -> int:
    """The narrowest compile-time tile that holds ``bk`` columns."""
    for w in TILE_WIDTHS:
        if w >= bk:
            return w
    raise ValueError(f"block of {bk} columns is wider than the widest tile {TILE_WIDTHS[-1]}")


_K2 = _launch.CFunction("dantzig_fused", "dantzig_fused_launch",
                        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_float] * 2
                        + [ctypes.c_void_p])
_K3 = _launch.CFunction("dantzig_fused", "dantzig_fused_state_launch",
                        [ctypes.c_void_p] * 16 + [ctypes.c_int] * 6 + [ctypes.c_float] * 2
                        + [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def _check_operands(a, q, inv_eig, b, lam, rho):
    """(m, d, k, device) of a launch, after checking every operand."""
    if b.ndim != 3:
        raise ValueError(f"b must be (m, d, k), got shape {tuple(b.shape)}")
    m, d, k = b.shape
    dev = b.device
    if dev.type != "cuda":
        raise ValueError(f"the fused kernels need CUDA tensors, got {dev}")
    for name, t, shape in (("a", a, (m, d, d)), ("q", q, (m, d, d)),
                           ("inv_eig", inv_eig, (m, d)), ("b", b, (m, d, k)),
                           ("lam", lam, (m, k)), ("rho", rho, (m, k))):
        _launch.check_operand(name, t, shape, dev)
    return m, d, k, dev


def dantzig_fused_cuda(a, q, inv_eig, b, lam, rho, *, iters: int, alpha: float,
                       block_k: int | None = None) -> torch.Tensor:
    """Launch K2 once for every machine and column block.

    a, q: (m, d, d); inv_eig: (m, d); b: (m, d, k); lam, rho: (m, k);
    all f32 on one card.  ``block_k`` None sizes the blocks with
    :func:`pick_block_k`.  Returns w: (m, d, k).
    """
    m, d, k, dev = _check_operands(a, q, inv_eig, b, lam, rho)
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    bk = resolve_block_k(d, k, block_k)
    width = tile_width(bk)
    at = a.mT.contiguous()
    qt = q.mT.contiguous()
    out = torch.empty((m, d, k), dtype=torch.float32, device=dev)
    code = _K2(*(t.data_ptr() for t in (at, q, qt, inv_eig, b, lam, rho, out)),
               m, d, k, bk, width, iters, alpha, 1.0 - alpha, _launch.stream(dev))
    _launch.raise_on_error("dantzig_fused", code)
    return out


def dantzig_fused_state_cuda(a, q, inv_eig, b, lam, rho, state: AdmmState | None = None, *,
                             iters: int, alpha: float, tol: float | None = None,
                             check_every: int = 10,
                             block_k: int | None = None) -> FusedSolveResult:
    """Launch K3 once for every machine and column block.

    Operands as :func:`dantzig_fused_cuda`; ``state`` None starts from
    zero, else its leaves are (m, d, k) f32 on the card.  ``tol`` None
    runs exactly ``iters`` iterations; otherwise ``check_every``-iteration
    chunks until the block's max scaled residual is at most ``tol``,
    capped at ``iters``.  Returns w (m, d, k), the final state and the
    executed iterations (m, num_blocks) int32.
    """
    m, d, k, dev = _check_operands(a, q, inv_eig, b, lam, rho)
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    if tol is not None and check_every < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")
    if state is not None:
        for name, leaf in zip(AdmmState._fields, state):
            _launch.check_operand(f"state.{name}", leaf, (m, d, k), dev)
    bk = resolve_block_k(d, k, block_k, state_io=True)
    width = tile_width(bk)
    at = a.mT.contiguous()
    qt = q.mT.contiguous()
    w, z, u1, u2 = (torch.empty((m, d, k), dtype=torch.float32, device=dev) for _ in range(4))
    counts = torch.empty((m, -(-k // bk)), dtype=torch.int32, device=dev)
    state_in = (None,) * 4 if state is None else tuple(leaf.data_ptr() for leaf in state)
    code = _K3(
        *(t.data_ptr() for t in (at, q, qt, inv_eig, b, lam, rho)), *state_in,
        *(t.data_ptr() for t in (w, z, u1, u2, counts)),
        m, d, k, bk, width, iters, alpha, 1.0 - alpha,
        int(tol is not None), 0.0 if tol is None else tol, check_every, _launch.stream(dev))
    _launch.raise_on_error("dantzig_fused_state", code)
    return FusedSolveResult(w, AdmmState(z, w, u1, u2), counts)
