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
the same plan.  The serving state comes across whole: sufficient
statistics, a model slot, a refit's warm carry, a serving fault plan
and a snapshot (``{"slot", "aux", "factor", "carry"}``), each from the
reference's NamedTuples or mappings of their fields, so a reference
runtime's state can be served by the port's.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from repro_torch.core.compression import Compression
from repro_torch.core.dantzig import DantzigConfig
from repro_torch.core.faults import Aggregation, FaultPlan, FaultSchedule
from repro_torch.core.path import PathResult
from repro_torch.core.pipeline import MCStats, SuffStats
from repro_torch.core.streaming import ModelSlot, RefitCarry, ServeFaultPlan
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


def _fields(obj) -> Mapping:
    """A NamedTuple's fields (through ``_asdict()``) or a mapping, as a mapping."""
    return obj if isinstance(obj, Mapping) else obj._asdict()


def suff_stats_from_numpy(fields, device: str | torch.device = "cuda") -> SuffStats:
    """A reference ``SuffStats`` (or its fields) as the port's, the counts 0-d int32."""
    f = _fields(fields)
    return SuffStats(tensor(f["sigma"], device), tensor(f["mu1"], device),
                     tensor(f["mu2"], device), tensor(f["n1"], device, dtype=torch.int32),
                     tensor(f["n2"], device, dtype=torch.int32))


def mc_stats_from_numpy(fields, device: str | torch.device = "cuda") -> MCStats:
    """A reference ``MCStats`` (or its fields) as the port's."""
    f = _fields(fields)
    return MCStats(*(tensor(f[name], device) for name in MCStats._fields))


def stats_from_numpy(fields, device: str | torch.device = "cuda"):
    """Either head's statistics: ``SuffStats`` when the fields hold ``mu1``, else ``MCStats``."""
    if "mu1" in _fields(fields):
        return suff_stats_from_numpy(fields, device)
    return mc_stats_from_numpy(fields, device)


def serve_fault_plan_from_numpy(corrupt, diverge, drop) -> ServeFaultPlan:
    """A materialized reference ``ServeFaultPlan`` as the port's host-side plan."""
    return ServeFaultPlan(tensor(corrupt, "cpu", dtype=torch.int32),
                          tensor(diverge, "cpu", dtype=torch.int32),
                          tensor(drop, "cpu", dtype=torch.bool))


def model_slot_from_numpy(fields, device: str | torch.device = "cuda") -> ModelSlot:
    """A reference ``ModelSlot`` (or its fields) as the port's, the version 0-d int32."""
    f = _fields(fields)
    return ModelSlot(tensor(f["beta"], device), tensor(f["means"], device),
                     tensor(f["priors"], device), tensor(f["version"], device, dtype=torch.int32))


def _state(state, device) -> AdmmState:
    if not isinstance(state, Mapping) and hasattr(state, "_asdict"):
        state = state._asdict()
    if isinstance(state, Mapping):
        state = [state[name] for name in AdmmState._fields]
    return state_from_numpy(*state, device=device)


def refit_carry_from_numpy(fields, device: str | torch.device = "cuda") -> RefitCarry:
    """A reference ``RefitCarry`` (or its fields; each state a mapping, NamedTuple or
    (z, w, u1, u2)) as the port's."""
    f = _fields(fields)
    return RefitCarry(tensor(f["rho_beta"], device), tensor(f["rho_theta"], device),
                      _state(f["state_beta"], device), _state(f["state_theta"], device))


def serving_snapshot_from_numpy(snapshot: Mapping, device: str | torch.device = "cuda") -> dict:
    """A reference serving snapshot (``ServingRuntime.snapshot()``) as the port's."""
    factor = _fields(snapshot["factor"])
    return {"slot": model_slot_from_numpy(snapshot["slot"], device),
            "aux": stats_from_numpy(snapshot["aux"], device),
            "factor": factor_from_numpy(factor["sigma"], factor["q"], factor["evals"], device),
            "carry": refit_carry_from_numpy(snapshot["carry"], device)}
