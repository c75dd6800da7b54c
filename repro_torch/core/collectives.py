"""The mesh's collectives over ``torch.distributed`` process groups, with a tally of the wire.

An axis of the mesh is an :class:`Axis`: its name and its process
group (``DeviceMesh.get_group(name)``; a (1, 1) mesh may hand both axes
the same group, so the name travels beside it).  The data axes are a
sequence of axes, ordered as the mesh orders them (``("pod",
"data")``), and a machine is one rank of their product.  Every
collective of the port's mesh path goes through this module, so
:data:`TALLY` sees each one: the bits this rank put on the wire, by the
axis's role (``"data"``: between machines; ``"model"``: inside one),
and the host seconds spent in collectives.  A collective over several
axes runs one hop an axis, and the tally counts every hop.

:data:`RECORDS` keeps one :class:`CollectiveRecord` a call instead, a
logical collective as the reference's trace holds it: its kind
(``"psum"`` or ``"all_gather"``), role, axis names and operand, at the
operand's own dtype.  The op contracts of :mod:`repro_torch.analysis`
read the records; the tally is what moved.

Tensors stay on their device: gloo takes CUDA tensors (it stages them
through host memory itself), NCCL needs them.  Neither gloo nor NCCL
takes int16, the wire dtype of the compressed uplink's row indices
(:func:`repro_torch.core.compression.wire_index_dtype`), so an int16
tensor travels as a ``uint8`` view of the same bytes: a gather moves
exactly the bytes the reference's trace counts.
"""

from __future__ import annotations

import time
from typing import Any, NamedTuple, Sequence

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


class Axis(NamedTuple):
    """One axis of the mesh on this rank: its name and its process group."""

    name: str
    group: Any


class CollectiveRecord(NamedTuple):
    """One logical collective: ``op`` ``"psum"`` or ``"all_gather"`` over ``axes`` (names) in
    the role ``role``, on an operand of ``shape`` and ``dtype`` (its own, not the wire's
    byte view) carrying ``bits``; ``hops`` is the number of axes it ran over, one
    backend call each."""

    op: str
    role: str
    axes: tuple
    shape: tuple
    dtype: str
    bits: int
    hops: int


# this process's logical collectives, in call order
RECORDS: list[CollectiveRecord] = []


def reset_records() -> None:
    RECORDS.clear()


def _record(op: str, role: str, axes: Sequence[Axis], x: torch.Tensor) -> None:
    RECORDS.append(CollectiveRecord(op, role, tuple(ax.name for ax in axes), tuple(x.shape),
                                    str(x.dtype).removeprefix("torch."),
                                    x.numel() * x.element_size() * 8, len(axes)))


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


def all_reduce_sum(x: torch.Tensor, axes: Sequence[Axis], role: str = "data") -> torch.Tensor:
    """The sum of ``x`` over every rank of ``axes`` (a new tensor; ``x`` is untouched).

    int16 is refused: a byte-wise sum is not an integer sum.  A caller
    whose sum has one non-zero operand (:func:`repro_torch.core.transport.psum_broadcast`)
    sums the bytes itself.
    """
    if x.dtype in _BYTE_VIEW:
        raise TypeError(f"no backend sums {x.dtype}; sum a wider dtype")
    _record("psum", role, axes, x)
    out = x.clone(memory_format=torch.contiguous_format)
    for ax in axes:
        _timed(role, out, lambda: dist.all_reduce(out, op=dist.ReduceOp.SUM, group=ax.group))
    return out


def all_reduce_bytes(x: torch.Tensor, axes: Sequence[Axis], role: str = "data") -> torch.Tensor:
    """:func:`all_reduce_sum` of ``x``'s bytes, as a ``uint8`` view, viewed back.

    Exact only where one rank's operand is non-zero and every other
    rank sends zeros: each byte is then one byte plus zeros.
    """
    _record("psum", role, axes, x)
    out = x.contiguous().clone()
    flat = out.reshape(-1).view(torch.uint8)
    for ax in axes:
        _timed(role, flat, lambda: dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=ax.group))
    return out


def _gather(x: torch.Tensor, axes: Sequence[Axis], role: str) -> torch.Tensor:
    shape, dtype = x.shape, x.dtype
    out = _wire(x)
    for ax in reversed(list(axes)):
        parts = [torch.empty_like(out) for _ in range(dist.get_world_size(ax.group))]
        _timed(role, out, lambda: dist.all_gather(parts, out, group=ax.group))
        out = torch.stack(parts)
    out = out.reshape(-1, *out.shape[len(axes):])
    if dtype in _BYTE_VIEW:
        out = out.view(dtype)
    return out.reshape(-1, *shape)


def all_gather_stack(x: torch.Tensor, axes: Sequence[Axis], role: str = "data") -> torch.Tensor:
    """Stack ``x`` from every rank of ``axes``: (...) -> (m, ...), row-major over ``axes``.

    For the data axes ``(pod, data)`` row ``i`` is machine ``pod * |data| + data``,
    the order of the reference's ``all_gather`` over both axes.
    """
    _record("all_gather", role, axes, x)
    return _gather(x, axes, role)


def all_gather_tiled(x: torch.Tensor, axis: Axis, role: str = "model") -> torch.Tensor:
    """Concatenate ``x`` (rows, ...) from every rank of ``axis`` along the rows, in rank order."""
    _record("all_gather", role, (axis,), x)
    return _gather(x, (axis,), role).reshape(-1, *x.shape[1:])


def group_rank(axis: Axis) -> int:
    """This rank's index along ``axis``."""
    return dist.get_rank(axis.group)


def group_size(axis: Axis) -> int:
    """The number of ranks along ``axis``."""
    return dist.get_world_size(axis.group)


def machine_index(axes: Sequence[Axis]) -> int:
    """This rank's machine, row-major over the data axes ``axes``."""
    idx = 0
    for ax in axes:
        idx = idx * dist.get_world_size(ax.group) + dist.get_rank(ax.group)
    return idx


def machine_count(axes: Sequence[Axis]) -> int:
    m = 1
    for ax in axes:
        m *= dist.get_world_size(ax.group)
    return m
