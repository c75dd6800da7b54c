"""Op-count contracts of the serving path (the port's twin of two ``repro.analysis`` contracts).

The reference declares its trace contracts on jaxprs: ``classify_batch``
holds no ``eigh``, no ADMM loop, no kernel and no collective and
exactly one ``dot_general``; ``refit_step`` holds exactly one ``eigh``
and no collective, and neither holds an f64 value.  The port has no
jaxpr: :func:`count_ops` runs the function once under a
``TorchDispatchMode`` that counts the aten ops it reaches (after
PyTorch's own decompositions: ``matmul`` arrives as ``mm``/``bmm``,
``linalg.eigh`` as ``_linalg_eigh``), and reads the kernel wrappers'
launch counter (``repro_torch.kernels.ops.LAUNCHES``) around it, since
the hand-written kernels are launched below the dispatcher.
"""

from __future__ import annotations

import collections
from typing import NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.kernels import ops as kops

# the ops that reach the dispatcher: ``linalg.eigh``/``eigvalsh`` and ``matmul`` are
# decomposed above it
EIGH_OPS = frozenset({"_linalg_eigh"})
MATMUL_OPS = frozenset({"mm", "bmm", "mv", "dot", "addmm", "addbmm", "baddbmm", "addmv"})
COLLECTIVE_NAMESPACES = frozenset({"c10d", "_c10d_functional", "c10d_functional"})


class OpCounts(NamedTuple):
    """What one call reached: aten ops by name, and the contract's categories."""

    eigh: int
    matmul: int
    collectives: int
    float64: int  # ops with a float64 output
    launches: int  # hand-written kernel launches
    ops: dict  # aten op name -> count


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()
        self.collectives = 0
        self.float64 = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops[func.overloadpacket.__name__] += 1
        if func.namespace in COLLECTIVE_NAMESPACES:
            self.collectives += 1
        if any(isinstance(t, torch.Tensor) and t.dtype == torch.float64
               for t in tree_leaves(out)):
            self.float64 += 1
        return out


def count_ops(fn, *args, **kwargs):
    """``(fn(*args, **kwargs), OpCounts)``: one call of ``fn`` with its ops counted."""
    before = sum(kops.LAUNCHES.values())
    with _Counter() as counter:
        out = fn(*args, **kwargs)
    ops = dict(counter.ops)
    return out, OpCounts(
        eigh=sum(n for name, n in ops.items() if name in EIGH_OPS),
        matmul=sum(n for name, n in ops.items() if name in MATMUL_OPS),
        collectives=counter.collectives, float64=counter.float64,
        launches=sum(kops.LAUNCHES.values()) - before, ops=ops)


class Contract(NamedTuple):
    """Exact counts one call must show; None leaves a category free."""

    name: str
    eigh: int | None = None
    matmul: int | None = None
    collectives: int | None = None
    float64: int | None = None
    launches: int | None = None

    def violations(self, counts: OpCounts) -> list[str]:
        """Each category whose count is not the contract's, as a message."""
        return [f"{self.name}: {field} {getattr(counts, field)}, contract {want}"
                for field in ("eigh", "matmul", "collectives", "float64", "launches")
                if (want := getattr(self, field)) is not None
                and getattr(counts, field) != want]


# a query batch touches no estimator machinery: the score product is its
# only matrix product, with no eigh, no kernel and no collective
CLASSIFY_BATCH = Contract("streaming.classify_batch", eigh=0, matmul=1, collectives=0,
                          float64=0, launches=0)
# one fresh factorization a refit (the direction and CLIME solves share
# it), and a refit is single-machine: nothing on the wire
REFIT_STEP = Contract("streaming.refit_step", eigh=1, collectives=0, float64=0)
