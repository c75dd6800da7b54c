"""The mesh's collectives over ``torch.distributed`` process groups, with a tally of the wire.

An axis of the mesh is a process group (``DeviceMesh.get_group(name)``);
the data axes are a sequence of groups, ordered as the mesh orders them
(``("pod", "data")``), and a machine is one rank of their product.
Every collective of the port's mesh path goes through this module, so
:data:`TALLY` sees each one: the bits this rank put on the wire, by the
axis's role (``"data"``: between machines; ``"model"``: inside one),
and the host seconds spent in collectives.

Tensors stay on their device: gloo takes CUDA tensors (it stages them
through host memory itself), NCCL needs them.  Neither gloo nor NCCL
takes int16, the wire dtype of the compressed uplink's row indices
(:func:`repro_torch.core.compression.wire_index_dtype`), so an int16
tensor travels as a ``uint8`` view of the same bytes: a gather moves
exactly the bytes the reference's trace counts.
"""

from __future__ import annotations

import time
from typing import Sequence

import torch
import torch.distributed as dist

# dtypes that travel as their bytes (a uint8 view): no backend carries them
_BYTE_VIEW = (torch.int16,)


class WireTally:
    """What this rank's collectives moved: bits put on the wire by axis role, and seconds."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.bits = {"data": 0, "model": 0}
        self.seconds = 0.0

    def add(self, role: str, bits: int, seconds: float) -> None:
        self.bits[role] += bits
        self.seconds += seconds


# this process's tally (one rank is one process)
TALLY = WireTally()


def _timed(role: str, x: torch.Tensor, run):
    """Run one collective on ``x``, tallying its operand's bits and the seconds it took."""
    if x.is_cuda:
        torch.cuda.synchronize(x.device)  # the compute before it is not the collective's
    t0 = time.perf_counter()
    out = run()
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    TALLY.add(role, x.numel() * x.element_size() * 8, time.perf_counter() - t0)
    return out


def _wire(x: torch.Tensor) -> torch.Tensor:
    x = x.contiguous()
    return x.view(torch.uint8) if x.dtype in _BYTE_VIEW else x


def all_reduce_sum(x: torch.Tensor, groups: Sequence, role: str = "data") -> torch.Tensor:
    """The sum of ``x`` over every rank of ``groups`` (a new tensor; ``x`` is untouched).

    int16 is refused: a byte-wise sum is not an integer sum.  A caller
    whose sum has one non-zero operand (:func:`repro_torch.core.transport.psum_broadcast`)
    sums the bytes itself.
    """
    if x.dtype in _BYTE_VIEW:
        raise TypeError(f"no backend sums {x.dtype}; sum a wider dtype")
    out = x.clone(memory_format=torch.contiguous_format)
    for g in groups:
        _timed(role, out, lambda: dist.all_reduce(out, op=dist.ReduceOp.SUM, group=g))
    return out


def all_reduce_bytes(x: torch.Tensor, groups: Sequence, role: str = "data") -> torch.Tensor:
    """:func:`all_reduce_sum` of ``x``'s bytes, as a ``uint8`` view, viewed back.

    Exact only where one rank's operand is non-zero and every other
    rank sends zeros: each byte is then one byte plus zeros.
    """
    out = x.contiguous().clone()
    flat = out.reshape(-1).view(torch.uint8)
    for g in groups:
        _timed(role, flat, lambda: dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=g))
    return out


def all_gather_stack(x: torch.Tensor, groups: Sequence, role: str = "data") -> torch.Tensor:
    """Stack ``x`` from every rank of ``groups``: (...) -> (m, ...), row-major over ``groups``.

    For the data axes ``(pod, data)`` row ``i`` is machine ``pod * |data| + data``,
    the order of the reference's ``all_gather`` over both axes.
    """
    shape, dtype = x.shape, x.dtype
    out = _wire(x)
    for g in reversed(list(groups)):
        parts = [torch.empty_like(out) for _ in range(dist.get_world_size(g))]
        _timed(role, out, lambda: dist.all_gather(parts, out, group=g))
        out = torch.stack(parts)
    out = out.reshape(-1, *out.shape[len(groups):])
    if dtype in _BYTE_VIEW:
        out = out.view(dtype)
    return out.reshape(-1, *shape)


def all_gather_tiled(x: torch.Tensor, group, role: str = "model") -> torch.Tensor:
    """Concatenate ``x`` (rows, ...) from every rank of ``group`` along the rows, in rank order."""
    return all_gather_stack(x, (group,), role).reshape(-1, *x.shape[1:])


def group_rank(group) -> int:
    """This rank's index along the axis ``group``."""
    return dist.get_rank(group)


def group_size(group) -> int:
    """The number of ranks along the axis ``group``."""
    return dist.get_world_size(group)


def machine_index(groups: Sequence) -> int:
    """This rank's machine, row-major over the data axes ``groups``."""
    idx = 0
    for g in groups:
        idx = idx * dist.get_world_size(g) + dist.get_rank(g)
    return idx


def machine_count(groups: Sequence) -> int:
    m = 1
    for g in groups:
        m *= dist.get_world_size(g)
    return m
