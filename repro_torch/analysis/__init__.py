"""Op-contract analyzer: declarative checks of cost, communication and memory invariants
(twin of ``repro.analysis``).

The paper's claims are structural: one local factorization per machine,
one O(d*K) aggregation per round, a fused solver that fits its memory.
This package turns those invariants into machine-checked *contracts*:

- :mod:`repro_torch.analysis.counts` -- what one call executed, counted
  (the reference walks a jaxpr; the port runs the call once under
  PyTorch's dispatch and function modes and reads the kernel wrappers',
  the dispatcher's and the collectives' own counts);
- :mod:`repro_torch.analysis.contracts` -- the contract types: primitive
  budgets, collective payload contracts, shared-memory conformance and a
  floating-point dtype policy;
- :mod:`repro_torch.analysis.registry` -- the ``@trace_contract``
  decorator that declares contracts next to the code they guard;
- :mod:`repro_torch.analysis.cases` -- representative calls per entry
  point (the d % model_axis != 0 remainder meshes included);
- :mod:`repro_torch.analysis.imports` -- AST import-graph rules over
  ``repro_torch/``;
- :mod:`repro_torch.analysis.lint` -- the ``python -m
  repro_torch.analysis.lint`` CLI.
"""

from repro_torch.analysis.contracts import (  # noqa: F401
    AxisPayloadBits,
    CollectiveContract,
    DtypePolicy,
    GramLaunches,
    Param,
    PrimitiveBudget,
    SmemConformance,
    Violation,
    run_contracts,
)
from repro_torch.analysis.registry import (  # noqa: F401
    check_entry,
    contracts_of,
    registered,
    trace_contract,
)
from repro_torch.analysis.counts import OpCounts, count_ops  # noqa: F401

__all__ = [
    "AxisPayloadBits",
    "CollectiveContract",
    "DtypePolicy",
    "GramLaunches",
    "OpCounts",
    "Param",
    "PrimitiveBudget",
    "SmemConformance",
    "Violation",
    "check_entry",
    "contracts_of",
    "count_ops",
    "registered",
    "run_contracts",
    "trace_contract",
]
