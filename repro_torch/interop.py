"""Carries the reference's state across to the port.

The JAX package hands its objects over as numpy arrays or plain dicts
(``np.asarray`` of each field, ``cfg._asdict()``); these functions turn
them into the port's tensors and types, so both packages compute from
exactly the same inputs.  The system has no weights: its parameters
are the problem, the spectral factor, the ADMM state and the solver
configuration; a lambda sweep carries its per-grid-point results and
states on a leading L axis (:func:`path_result_from_numpy`).  The
comms configs come across as ``_asdict()`` mappings (nested configs as
mappings or as the reference's own NamedTuples) and a materialized
fault plan as its three arrays, so a rounds test feeds both packages
the same plan.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from repro_torch.core.compression import Compression
from repro_torch.core.dantzig import DantzigConfig
from repro_torch.core.faults import Aggregation, FaultPlan, FaultSchedule
from repro_torch.core.path import PathResult
from repro_torch.core.transport import BitBudget, CommPlan
from repro_torch.device import require_device
from repro_torch.kernels.dantzig_fused import AdmmState
from repro_torch.kernels.spectral import SpectralFactor
from repro_torch.stats.synthetic import LDAProblem, MCProblem


def tensor(a, device: str | torch.device = "cuda", dtype=torch.float32) -> torch.Tensor:
    """A numpy array (or anything ``np.asarray`` takes) as a tensor, values unchanged."""
    return torch.tensor(np.asarray(a), dtype=dtype, device=require_device(device))


def problem_from_numpy(fields: Mapping, device: str | torch.device = "cuda") -> LDAProblem:
    """The reference's ``LDAProblem`` fields (a mapping of arrays) as the port's problem."""
    return LDAProblem(*(tensor(fields[name], device) for name in LDAProblem._fields))


def mc_problem_from_numpy(fields: Mapping, device: str | torch.device = "cuda") -> MCProblem:
    """The reference's ``MCProblem`` fields (a mapping of arrays) as the port's problem."""
    return MCProblem(*(tensor(fields[name], device) for name in MCProblem._fields))


def fault_plan_from_numpy(live, stale, corrupt, device: str | torch.device = "cuda") -> FaultPlan:
    """A materialized reference ``FaultPlan`` (live, stale, corrupt) as the port's."""
    return FaultPlan(tensor(live, device), tensor(stale, device, dtype=torch.int32),
                     tensor(corrupt, device, dtype=torch.int32))


def factor_from_numpy(sigma, q, evals, device: str | torch.device = "cuda") -> SpectralFactor:
    """A reference ``SpectralFactor`` (sigma, q, evals) as the port's."""
    return SpectralFactor(tensor(sigma, device), tensor(q, device), tensor(evals, device))


def state_from_numpy(z, w, u1, u2, device: str | torch.device = "cuda") -> AdmmState:
    """A reference ``AdmmState`` (z, w, u1, u2) as the port's."""
    return AdmmState(*(tensor(v, device) for v in (z, w, u1, u2)))


def path_result_from_numpy(fields: Mapping, device: str | torch.device = "cuda") -> PathResult:
    """A reference ``PathResult._asdict()`` as the port's, leaves on their leading L axis.

    ``state`` is a mapping of the four leaves (``AdmmState._asdict()``)
    or their sequence; ``iters`` comes across as int32.
    """
    state = fields["state"]
    if isinstance(state, Mapping):
        state = [state[name] for name in AdmmState._fields]
    return PathResult(
        beta=tensor(fields["beta"], device), lam=tensor(fields["lam"], device),
        kkt=tensor(fields["kkt"], device), rho=tensor(fields["rho"], device),
        state=state_from_numpy(*state, device=device),
        iters=tensor(fields["iters"], device, dtype=torch.int32))


def _config(cls, fields):
    """``cls`` from a mapping, or from a NamedTuple through its ``_asdict()``; None stays None."""
    if fields is None:
        return None
    if not isinstance(fields, Mapping):
        fields = fields._asdict()
    unknown = set(fields) - set(cls._fields)
    if unknown:
        raise ValueError(f"fields the port's {cls.__name__} does not have: {sorted(unknown)}")
    return cls(**fields)


def dantzig_config_from_dict(fields: Mapping) -> DantzigConfig:
    """A reference ``DantzigConfig._asdict()`` as the port's config (same fields)."""
    return _config(DantzigConfig, fields)


def compression_from_dict(fields: Mapping) -> Compression:
    """A reference ``Compression._asdict()`` as the port's codec."""
    return _config(Compression, fields)


def bit_budget_from_dict(fields: Mapping) -> BitBudget:
    """A reference ``BitBudget._asdict()`` as the port's schedule (``weights`` as a tuple)."""
    budget = _config(BitBudget, fields)
    weights = None if budget.weights is None else tuple(budget.weights)
    return budget._replace(weights=weights)


def comm_plan_from_dict(fields: Mapping) -> CommPlan:
    """A reference ``CommPlan._asdict()`` as the port's plan, its nested configs converted."""
    plan = _config(CommPlan, fields)
    return plan._replace(
        uplink=_config(Compression, plan.uplink), downlink=_config(Compression, plan.downlink),
        schedule=None if plan.schedule is None else bit_budget_from_dict(plan.schedule),
        faults=_config(FaultSchedule, plan.faults),
        aggregation=_config(Aggregation, plan.aggregation))
