"""The ``@trace_contract`` decorator and the entry-point registry (twin of ``repro.analysis.registry``).

Contracts are declared next to the code they guard::

    @trace_contract(
        "rounds.worker_rounds",
        contracts=(
            PrimitiveBudget("eigh", exact=1),
            CollectiveContract("psum", count=Param("dense_psums"), axis="data",
                               shape=Param("psum_payload"), dtype="float32"),
        ),
    )
    def worker_rounds(...): ...

The decorator only records (name, fn, contracts) and returns the
function unchanged, so decoration costs nothing at call time.
Representative calls live in :mod:`repro_torch.analysis.cases`; the
lint CLI joins the two.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

from repro_torch.analysis import contracts as C


class ContractSpec(NamedTuple):
    name: str
    fn: Callable
    contracts: Tuple[Any, ...]


_REGISTRY: Dict[str, ContractSpec] = {}


def trace_contract(name: str, *, contracts) -> Callable:
    """Register ``contracts`` for the decorated entry point under ``name``."""
    bundle = tuple(contracts)

    def decorate(fn: Callable) -> Callable:
        _REGISTRY[name] = ContractSpec(name, fn, bundle)
        return fn

    return decorate


def registered() -> Dict[str, ContractSpec]:
    """Snapshot of the registry (entry name -> spec)."""
    return dict(_REGISTRY)


def contracts_of(name: str) -> Tuple[Any, ...]:
    return _REGISTRY[name].contracts


def unregister(name: str) -> None:
    """Remove an entry (used by the analyzer's own negative tests)."""
    _REGISTRY.pop(name, None)


def check_entry(name: str, counts, params: Optional[dict] = None) -> list:
    """Run every contract registered for ``name`` against the counts of one call."""
    return C.run_contracts(contracts_of(name), counts, params)


__all__ = [
    "ContractSpec",
    "check_entry",
    "contracts_of",
    "registered",
    "trace_contract",
    "unregister",
]
