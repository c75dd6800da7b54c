"""One dispatch layer for every Dantzig/CLIME solve (twin of ``repro.core.solver_dispatch``).

``scan``
    The eager ADMM in :func:`repro_torch.core.dantzig.solve_dantzig_scan`,
    selected when ``cfg.fused`` is False (the only path with adaptive rho).
``fused`` / ``fused_blocked``
    The fused kernels with all k columns of a machine in one block, or
    tiled into column blocks: K2 for the fixed-iteration cold solve, K3
    (``state_io``) for the tol-gated and warm-started modes.  The columns
    per block are the launch plan's
    (:func:`repro_torch.kernels.dantzig_fused.plan_launch`, with the
    ``cfg.block_k`` override), the same plan the wrapper and the
    launchers take, so the blocks chosen here are the blocks that run.

``cfg.tol`` switches every path from the fixed-iteration schedule to
the residual-gated early exit, and every entry point accepts a warm
:class:`~repro_torch.kernels.dantzig_fused.AdmmState` to resume from.
:func:`solve_dantzig_full` returns the full result (solution, warm rho,
resumable state, executed iterations per column).

Unlike the TPU, there is no capacity fallback from fused to scan: where
A's and Q's rows do not fit a thread-block cluster's shared memory, the
kernels' streamed template reads them from L2, so ``cfg.fused=True``
means the kernel at every d where the plan fits one column, and an
error beyond.
Fused is fixed rho with no adaptation, so a silent switch to the scan
would be different math.

Every entry point accepts either the raw (..., d, d) matrix or its
:class:`~repro_torch.kernels.spectral.SpectralFactor`, so the one
eigendecomposition per worker is shared by all of its solves.

:data:`SOLVES` counts the solves dispatched, by implementation: the op
contracts of :mod:`repro_torch.analysis` read it where the reference's
read its ADMM loops (``while`` / ``scan``) in a trace.
"""

from __future__ import annotations

import collections
from typing import NamedTuple

import torch

from repro_torch.analysis.contracts import (
    DtypePolicy,
    Param,
    PrimitiveBudget,
    SmemConformance,
)
from repro_torch.analysis.registry import trace_contract
from repro_torch.core import dantzig as _dantzig
from repro_torch.kernels import ops as kops
from repro_torch.kernels.dantzig_fused import SMEM_BYTES, AdmmState, plan_launch
from repro_torch.kernels.ref import per_column
from repro_torch.kernels.spectral import sigma_of

SOLVES: collections.Counter = collections.Counter()


class SolverChoice(NamedTuple):
    """Solver selection for a (d, k) Dantzig batch."""

    kind: str  # "scan" | "fused" | "fused_blocked"
    block_k: int | None = None  # columns per block (fused paths)


def select_solver(cfg: "_dantzig.DantzigConfig", d: int, k: int,
                  state_io: bool | None = None) -> SolverChoice:
    """Pick the solver implementation for a (d, k) batch (the same on every device).

    ``state_io`` sizes the blocks for the state kernel (K3); None
    derives it from the config (``cfg.tol`` routes to K3).
    """
    if not cfg.fused:
        return SolverChoice("scan")
    if state_io is None:
        state_io = cfg.tol is not None
    bk = plan_launch(d, k, cfg.block_k, state_io, smem_budget(cfg)).block_k
    return SolverChoice("fused" if bk >= k else "fused_blocked", bk)


def smem_budget(cfg: "_dantzig.DantzigConfig") -> float:
    """The shared memory a fused launch may plan for: ``cfg.vmem_budget``, capped to the card's."""
    return SMEM_BYTES if cfg.vmem_budget is None else min(cfg.vmem_budget, SMEM_BYTES)


class SolveResult(NamedTuple):
    """Everything a dispatched solve can hand back."""

    beta: torch.Tensor  # the sparse solution, trailing shape of b
    rho: torch.Tensor  # (..., k) warm per-problem ADMM penalties
    state: AdmmState  # full final state, resumable via `state=`
    iters: torch.Tensor  # (..., k) int32 executed iterations per column


def solve_dantzig(a, b: torch.Tensor, lam, cfg: "_dantzig.DantzigConfig | None" = None, *,
                  rho=None, state: AdmmState | None = None) -> torch.Tensor:
    """Solve a batch of Dantzig problems through the dispatched implementation.

    ``a``: (..., d, d) PSD matrix or its SpectralFactor; ``b``: (..., d)
    or (..., d, k); ``lam``: scalar, (k,) or (..., k); ``rho``: optional
    per-column penalty (the fused kernel's operand, the scan's seed).
    Returns beta shaped like ``b`` (broadcast to ``a``'s machines).
    """
    out, _ = solve_dantzig_with_rho(a, b, lam, cfg, rho=rho, state=state)
    return out


def solve_dantzig_with_rho(a, b: torch.Tensor, lam,
                           cfg: "_dantzig.DantzigConfig | None" = None, *,
                           rho=None, state: AdmmState | None = None):
    """:func:`solve_dantzig` plus the final per-problem rho, (..., k)."""
    if cfg is None:
        cfg = _dantzig.DantzigConfig()
    if cfg.tol is not None or state is not None:
        # the adaptive / warm-started modes carry full state anyway
        result = solve_dantzig_full(a, b, lam, cfg, rho=rho, state=state)
        return result.beta, result.rho
    mat = sigma_of(a)
    squeeze = b.ndim == mat.ndim - 1
    b2 = b.unsqueeze(-1) if squeeze else b
    d, k = b2.shape[-2:]
    b2 = b2.expand(*mat.shape[:-2], d, k)
    choice = select_solver(cfg, d, k, state_io=False)
    SOLVES[choice.kind] += 1
    if choice.kind == "scan":
        out, rho_final = _dantzig.solve_dantzig_scan(a, b2, lam, cfg, rho0=rho, return_rho=True)
    else:
        rho_in = cfg.rho if rho is None else rho
        out = kops.dantzig_fused(a, b2, lam, iters=cfg.max_iters, rho=rho_in,
                                 alpha=cfg.alpha, block_k=choice.block_k)
        rho_final = per_column(rho_in, b2)[..., 0, :]
    out = out.to(b.dtype)
    if squeeze:
        return out[..., 0], rho_final[..., 0]
    return out, rho_final


@trace_contract(
    "solver_dispatch.solve_dantzig_full",
    contracts=(
        # factor-fed solves must not re-factorize; raw input costs one
        PrimitiveBudget("eigh", exact=Param("eighs")),
        PrimitiveBudget("pallas_call", exact=Param("pallas_calls")),
        DtypePolicy(),
        SmemConformance(),
    ),
)
def solve_dantzig_full(a, b: torch.Tensor, lam,
                       cfg: "_dantzig.DantzigConfig | None" = None, *,
                       rho=None, state: AdmmState | None = None) -> SolveResult:
    """Dispatched solve returning the full :class:`SolveResult`.

    Honours ``cfg.tol`` / ``cfg.check_every`` on every path, resumes
    from ``state`` (leaves shaped like ``b``) when given, and returns
    the final state and the executed iterations per column next to the
    solution and warm rho.  Counts come at the solver's own granularity,
    repeated over columns: one per machine on the scan path, one per
    column block on the fused paths.
    """
    if cfg is None:
        cfg = _dantzig.DantzigConfig()
    mat = sigma_of(a)
    squeeze = b.ndim == mat.ndim - 1
    b2 = b.unsqueeze(-1) if squeeze else b
    d, k = b2.shape[-2:]
    b2 = b2.expand(*mat.shape[:-2], d, k)
    if state is not None and squeeze:
        state = AdmmState(*(leaf.unsqueeze(-1) for leaf in state))
    choice = select_solver(cfg, d, k, state_io=True)
    SOLVES[choice.kind] += 1
    if choice.kind == "scan":
        out, rho_final, fstate, iters = _dantzig.solve_dantzig_scan(
            a, b2, lam, cfg, rho0=rho, return_rho=True, state0=state, return_info=True)
        iters_col = iters.unsqueeze(-1).expand(*iters.shape, k)
    else:
        rho_in = cfg.rho if rho is None else rho
        fused = kops.dantzig_fused(a, b2, lam, iters=cfg.max_iters, rho=rho_in,
                                   alpha=cfg.alpha, block_k=choice.block_k, tol=cfg.tol,
                                   check_every=cfg.check_every, state=state,
                                   return_info=True)
        out, fstate = fused.beta, fused.state
        rho_final = per_column(rho_in, b2)[..., 0, :]
        # per-block counts -> per-column (each block's columns share it)
        iters_col = fused.iters.repeat_interleave(choice.block_k, dim=-1)[..., :k]
    out = out.to(b.dtype)
    if squeeze:
        return SolveResult(out[..., 0], rho_final[..., 0],
                           AdmmState(*(leaf[..., 0] for leaf in fstate)), iters_col[..., 0])
    return SolveResult(out, rho_final, fstate, iters_col)
