"""What one call executed, counted: the port's stand-in for the reference's jaxpr walker.

The reference traces an entry point to a jaxpr and walks it
(``repro.analysis.walker``); the port has no jaxpr, so it has no
walker.  :func:`count_ops` runs the function once, eagerly, and counts
what that call executed:

* the aten ops it reached, under a ``TorchDispatchMode`` (after
  PyTorch's own decompositions: ``matmul`` arrives as ``mm``/``bmm``,
  ``linalg.eigh`` as ``_linalg_eigh``), with the floating dtypes they
  produced and the bytes they read and wrote;
* ``isfinite`` calls, under a ``TorchFunctionMode``: ``torch.isfinite``
  is decomposed before the dispatcher (into ``abs``/``ne``/``eq``/``mul``).
  The guard in :func:`repro_torch.kernels.spectral.spectral_factor`
  is left out: it is the port's own (cuSOLVER raises on a non-finite
  matrix), and the reference's trace has no such call;
* the kernel wrappers' calls and launches (:mod:`repro_torch.kernels.ops`),
  which run below the dispatcher, and the ADMM calls by blocking;
* the Dantzig solves dispatched (:data:`repro_torch.core.solver_dispatch.SOLVES`);
* the logical collectives (:data:`repro_torch.core.collectives.RECORDS`),
  and any ``c10d`` collective that went round them.

A trace holds an op once however often it runs; an eager call counts
each run.  The two agree where no counted op sits inside a loop or
behind a data-dependent branch: the ADMM loops hold no counted op, and
a fused solve is one call.
"""

from __future__ import annotations

import collections
import sys
from typing import NamedTuple

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.core import collectives, solver_dispatch
from repro_torch.kernels import ops as kops

# the ops that reach the dispatcher: ``linalg.eigh``/``eigvalsh`` and ``matmul`` are
# decomposed above it
EIGH_OPS = frozenset({"_linalg_eigh"})
MATMUL_OPS = frozenset({"mm", "bmm", "mv", "dot", "addmm", "addbmm", "baddbmm", "addmv"})
COLLECTIVE_NAMESPACES = frozenset({"c10d", "_c10d_functional", "c10d_functional"})
# c10d ops by the logical collective they carry
C10D_KINDS = {"allreduce_": "psum", "all_reduce": "psum", "allgather_": "all_gather",
              "_allgather_base_": "all_gather", "all_gather_into_tensor": "all_gather"}
# (module, function) of the isfinite calls the counts leave out
ISFINITE_GUARDS = frozenset({("repro_torch.kernels.spectral", "spectral_factor")})


class OpCounts(NamedTuple):
    """What one call executed."""

    ops: dict  # aten op name -> count
    eigh: int
    matmul: int
    float_outputs: dict  # floating dtype name -> ops that produced one
    bytes_accessed: int  # aten ops' tensor operands and results, views and c10d left out
    is_finite: int  # isfinite calls, the factor's guard left out
    calls: dict  # kernel wrapper calls by kernel, either device
    launches: dict  # hand-written kernel launches by kernel
    call_shapes: dict  # (kernel, m, rows, cols) -> calls
    call_blocks: dict  # (ADMM kernel, d, k, block_k) -> calls
    solves: int  # Dantzig solves dispatched
    collectives: tuple  # CollectiveRecord of each logical collective, in order
    unrecorded: dict  # "psum" / "all_gather" -> c10d ops no record accounts for
    on_card: bool  # some op ran on a CUDA tensor

    def collective_count(self, op: str) -> int:
        """Logical collectives of kind ``op``, the unrecorded c10d ones included."""
        return sum(r.op == op for r in self.collectives) + self.unrecorded.get(op, 0)


def _is_view(func) -> bool:
    """Whether an aten op returns a view of an input (moves no data)."""
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


class _DispatchCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()
        self.c10d = collections.Counter()
        self.floats = collections.Counter()
        self.bytes = 0
        self.on_card = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        self.ops[name] += 1
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if func.namespace in COLLECTIVE_NAMESPACES:
            self.c10d[C10D_KINDS.get(name, name)] += 1
        elif not _is_view(func):
            self.bytes += sum(t.numel() * t.element_size() for t in ins + outs)
        self.on_card = self.on_card or any(t.is_cuda for t in ins + outs)
        for dtype in {t.dtype for t in outs if t.is_floating_point()}:
            self.floats[str(dtype).removeprefix("torch.")] += 1
        return out


class _FunctionCounter(TorchFunctionMode):
    def __init__(self):
        super().__init__()
        self.is_finite = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is torch.isfinite or func is torch.Tensor.isfinite:
            caller = sys._getframe(1)
            if (caller.f_globals.get("__name__"), caller.f_code.co_name) not in ISFINITE_GUARDS:
                self.is_finite += 1
        return func(*args, **(kwargs or {}))


def _delta(after: dict, before: dict) -> dict:
    return {k: n - before.get(k, 0) for k, n in after.items() if n != before.get(k, 0)}


def count_ops(fn, *args, **kwargs):
    """``(fn(*args, **kwargs), OpCounts)``: one call of ``fn`` with what it executed counted."""
    before = (dict(kops.CALLS), dict(kops.LAUNCHES), dict(kops.CALL_SHAPES),
              dict(kops.CALL_BLOCKS), sum(solver_dispatch.SOLVES.values()))
    n_records = len(collectives.RECORDS)
    with _FunctionCounter() as functions, _DispatchCounter() as dispatched:
        out = fn(*args, **kwargs)
    records = tuple(collectives.RECORDS[n_records:])
    hops = collections.Counter()
    for r in records:
        hops[r.op] += r.hops
    ops = dict(dispatched.ops)
    return out, OpCounts(
        ops=ops, eigh=sum(n for name, n in ops.items() if name in EIGH_OPS),
        matmul=sum(n for name, n in ops.items() if name in MATMUL_OPS),
        float_outputs=dict(dispatched.floats), bytes_accessed=dispatched.bytes,
        is_finite=functions.is_finite,
        calls={k: n - before[0][k] for k, n in kops.CALLS.items()},
        launches={k: n - before[1][k] for k, n in kops.LAUNCHES.items()},
        call_shapes=_delta(kops.CALL_SHAPES, before[2]),
        call_blocks=_delta(kops.CALL_BLOCKS, before[3]),
        solves=sum(solver_dispatch.SOLVES.values()) - before[4], collectives=records,
        unrecorded={op: n - hops[op] for op, n in dispatched.c10d.items() if n > hops[op]},
        on_card=dispatched.on_card)
