"""Lambda-path solves folded into one launch (twin of ``repro.core.path``).

The paper picks the Dantzig box radius lam ∝ sqrt(log d / n) with
constants tuned on held-out data (§5), so every machine solves the same
problem across an L-point grid.  Two things fold the sweep into one
solve:

  * the spectral factor is lam- and rho-independent, so one ``eigh``
    serves the whole sweep and the CLIME solve;
  * ``lam`` and ``rho`` are per-column operands of the fused kernels,
    so an L-point grid over a (d, k) batch is a (d, L*k) batch with
    ``lam`` varying across the replicated column blocks: one launch,
    sized by the Hopper blocking model like any other wide batch.

Column layout: lambda index l owns columns [l*k, (l+1)*k); outputs
unfold to a (..., L, ...) axis after the machine axes.  Machines lead
every result: ``beta`` is (..., L, d, k), ``iters`` (..., L, k), and the
selectors return one index per machine.

Continuation: every sweep returns the full per-(lambda, column) ADMM
state next to the warm rho and accepts one back via ``state=``, so a
re-sweep resumes each grid point from its previous solution; with
``cfg.tol`` set the residual-gated exit turns that into fewer executed
iterations (``PathResult.iters``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.analysis.contracts import (
    DtypePolicy,
    GramLaunches,
    Param,
    PrimitiveBudget,
    SmemConformance,
)
from repro_torch.analysis.registry import trace_contract
from repro_torch.core.clime import solve_clime_columns, symmetrize_min
from repro_torch.core.dantzig import DantzigConfig, kkt_violation
from repro_torch.core.pipeline import HeadStats
from repro_torch.core.solver_dispatch import solve_dantzig_full
from repro_torch.kernels.dantzig_fused import AdmmState
from repro_torch.kernels.spectral import as_spectral_factor


class PathResult(NamedTuple):
    """One folded sweep, indexed by the lambda axis after the machine axes."""

    beta: torch.Tensor  # (..., L, d, k) solutions ((..., L, d) for vector rhs)
    lam: torch.Tensor  # (L,) the grid
    kkt: torch.Tensor  # (..., L, k) constraint violations ((..., L) for vector rhs)
    rho: torch.Tensor  # (..., L, k) final per-(lambda, column) ADMM penalties
    state: AdmmState  # full final states, leaves like beta
    iters: torch.Tensor  # (..., L, k) executed iterations ((..., L) for vector rhs)


def _unfold(wide: torch.Tensor, d: int, L: int, k: int) -> torch.Tensor:
    """(..., d, L*k) -> (..., L, d, k) under the lambda-owns-contiguous-columns fold."""
    return wide.unflatten(-1, (L, k)).movedim(-2, -3)


_STATE_LAYOUTS = ("auto", "grid", "single")


def _fold_state(state: AdmmState, batch: tuple, d: int, L: int, k: int,
                layout: str = "auto") -> AdmmState:
    """Warm path state -> the (..., d, L*k) wide layout.

    Every leaf carries the machine dimensions ``batch`` in front.  After
    them it is (L, d, k) or (L, d, 1) (a previous sweep, e.g.
    ``PathResult.state``; the ``grid`` layout), or (d, k) / (d,) (a
    single solve, broadcast to every grid point; the ``single``
    layout).  2-D trailing shapes are ambiguous when they collide: a
    (d, k) single solve and an (L, d) vector sweep read alike once
    ``L == d == k`` (and (d, d) with (L, d) whenever ``L == d``).
    ``layout="auto"`` infers the kind only when exactly one reading fits
    and raises on a collision; ``"grid"`` / ``"single"`` decide it.
    """
    if layout not in _STATE_LAYOUTS:
        raise ValueError(f"state_layout must be one of {_STATE_LAYOUTS}, got {layout!r}")
    nb = len(batch)
    leaves = []
    for leaf in state:
        leaf = torch.as_tensor(leaf).to(torch.float32)
        if tuple(leaf.shape[:nb]) != tuple(batch):
            raise ValueError(
                f"warm-state leaf {tuple(leaf.shape)} does not lead with the machine "
                f"dimensions {tuple(batch)}")
        trail = tuple(leaf.shape[nb:])
        if len(trail) == 1:  # (d,) single vector solve
            if trail != (d,):
                raise ValueError(f"1-D warm-state leaf {trail} != (d,)=({d},)")
            leaf = leaf[..., None, :, None]
        elif len(trail) == 2:
            as_single = trail in ((d, k), (d, 1))
            as_grid = trail == (L, d)
            kind = layout
            if kind == "auto":
                if as_single and as_grid:
                    raise ValueError(
                        f"warm-state leaf {trail} is ambiguous at L={L}, d={d}, k={k}: it "
                        "reads both as a (d, k) single solve and as an (L, d) vector sweep. "
                        "Pass state_layout='single' or 'grid' (or reshape sweep leaves to "
                        "(L, d, 1)).")
                kind = "single" if as_single else "grid"
            if kind == "single":
                if not as_single:
                    raise ValueError(
                        f"single-solve warm-state leaf {trail} != (d, k)=({d}, {k})")
                leaf = leaf.unsqueeze(-3)  # (..., 1, d, k|1): broadcast to the grid
            else:
                if not as_grid:
                    raise ValueError(
                        f"vector-sweep warm-state leaf {trail} != (L, d)=({L}, {d})")
                leaf = leaf.unsqueeze(-1)
        elif len(trail) == 3:
            if trail not in ((L, d, k), (L, d, 1)):
                raise ValueError(
                    f"3-D warm-state leaf {trail} matches neither (L, d, k)=({L}, {d}, {k}) "
                    "nor (L, d, 1)")
        else:
            raise ValueError(f"warm-state leaf has {len(trail)} dimensions after the "
                             "machines; expected 1-3")
        leaf = leaf.expand(*batch, L, d, k)
        leaves.append(leaf.movedim(-3, -2).reshape(*batch, d, L * k))
    return AdmmState(*leaves)


def seed_path_state(state: AdmmState, lams_from, lams_to) -> AdmmState:
    """Re-map a sweep's per-lambda states onto a new lambda grid.

    Each new grid point is seeded from the nearest old grid point's
    state: leaves go (..., L_from, d, k) -> (..., L_to, d, k).  Feed the
    result to :func:`solve_dantzig_path`'s ``state=``.
    """
    lams_from = torch.as_tensor(lams_from)
    lams_to = torch.as_tensor(lams_to, dtype=lams_from.dtype, device=lams_from.device)
    nearest = (lams_to[:, None] - lams_from[None, :]).abs().argmin(dim=1)  # (L_to,)
    return AdmmState(*(leaf.index_select(-3, nearest.to(leaf.device)) for leaf in state))


def _fold_rho(rho, batch: tuple, L: int, k: int) -> torch.Tensor:
    """Warm penalties (scalar, (L,), (k,) or (..., L, k)) as the wide (..., L*k) operand."""
    r = torch.as_tensor(rho).to(torch.float32)
    if r.ndim == 1:
        # (L,) = per-lambda, (k,) = per-column; at L == k the two readings
        # collide and picking one would misfold the warm carry
        if L == k and r.shape[0] == L:
            raise ValueError(
                f"1-D rho of shape {tuple(r.shape)} is ambiguous at L == k == {L}: pass "
                "rho[:, None] for per-lambda or rho[None, :] for per-column.")
        if r.shape[0] == L:
            r = r[:, None]
        elif r.shape[0] != k:
            raise ValueError(f"rho shape {tuple(r.shape)} matches neither (L,)=({L},) "
                             f"nor (k,)=({k},)")
    return r.expand(*batch, L, k).reshape(*batch, L * k)


@trace_contract(
    "path.solve_dantzig_path",
    contracts=(
        # a raw Sigma is factorized once for the WHOLE sweep; a
        # SpectralFactor input must run zero eighs
        PrimitiveBudget("eigh", exact=Param("eighs")),
        # the lambda grid folds into the column batch: one fused launch
        # covers all L grid points (scan cfg: none)
        PrimitiveBudget("pallas_call", exact=Param("pallas_calls")),
        PrimitiveBudget("psum", exact=0),
        DtypePolicy(),
        SmemConformance(),
    ),
)
def solve_dantzig_path(a, b: torch.Tensor, lams, cfg: DantzigConfig = DantzigConfig(), *,
                       rho=None, state: AdmmState | None = None,
                       state_layout: str = "auto") -> PathResult:
    """Solve a (..., d, k) Dantzig batch at every lambda of ``lams`` in one solve.

    ``a`` is the (..., d, d) matrix (factorized once for the whole
    sweep) or its ``SpectralFactor``; ``b`` is (..., d) or
    (..., d, k), shared by all lambdas; ``lams`` is the (L,) grid.
    ``rho``: warm penalties, scalar, (L,) per-lambda, (k,) per-column or
    (..., L, k) (e.g. ``PathResult.rho`` of the previous sweep); a 1-D
    rho raises at L == k.  ``state``: a warm ADMM state, a previous
    sweep's ``PathResult.state`` or a single solve's state (see
    :func:`_fold_state`; ``state_layout`` settles 2-D collisions).  The
    L*k columns dispatch as one batch.
    """
    factor = as_spectral_factor(a)
    batch = tuple(factor.sigma.shape[:-2])
    squeeze = b.ndim == factor.sigma.ndim - 1
    b2 = b.unsqueeze(-1) if squeeze else b
    d, k = b2.shape[-2:]
    b2 = b2.expand(*batch, d, k)
    lams = torch.as_tensor(lams, dtype=b2.dtype, device=b2.device)
    (L,) = lams.shape

    # fold: lambda l owns columns [l*k, (l+1)*k)
    wide_b = b2.repeat(*([1] * len(batch)), 1, L)
    wide_lam = lams.repeat_interleave(k)
    wide_rho = None if rho is None else _fold_rho(rho, batch, L, k)
    wide_state = None if state is None else _fold_state(state, batch, d, L, k, state_layout)

    result = solve_dantzig_full(factor, wide_b, wide_lam, cfg, rho=wide_rho, state=wide_state)
    wide_kkt = kkt_violation(factor.sigma, wide_b, result.beta, wide_lam)

    beta = _unfold(result.beta, d, L, k)  # (..., L, d, k)
    kkt = wide_kkt.unflatten(-1, (L, k))
    rho_final = result.rho.expand(*batch, L * k).unflatten(-1, (L, k))
    state_final = AdmmState(*(_unfold(leaf, d, L, k) for leaf in result.state))
    iters = result.iters.unflatten(-1, (L, k))
    if squeeze:
        return PathResult(beta[..., 0], lams, kkt[..., 0], rho_final,
                          AdmmState(*(leaf[..., 0] for leaf in state_final)), iters[..., 0])
    return PathResult(beta, lams, kkt, rho_final, state_final, iters)


class WorkerPathResult(NamedTuple):
    """The machines' debiased pipeline swept across the lambda grid."""

    beta_tilde: torch.Tensor  # (..., L, d, K) debiased direction blocks
    beta_hat: torch.Tensor  # (..., L, d, K) biased local estimates
    lam: torch.Tensor  # (L,)
    kkt: torch.Tensor  # (..., L, K) direction-solve constraint violations
    rho_beta: torch.Tensor  # (..., L, K) warm penalties for the next sweep
    stats: HeadStats  # the head's sufficient statistics (lambda-free)
    state_beta: AdmmState  # (..., L, d, K) direction states for the next sweep
    iters: torch.Tensor  # (..., L, K) executed direction-solve iterations


@trace_contract(
    "path.worker_debiased_path",
    contracts=(
        # one eigh funds the direction sweep AND the CLIME block
        PrimitiveBudget("eigh", exact=1),
        # fused cfg: folded direction sweep + CLIME = 2 launches
        PrimitiveBudget("pallas_call", exact=Param("pallas_calls")),
        GramLaunches(Param("gram_launches")),
        DtypePolicy(),
        SmemConformance(),
    ),
)
def worker_debiased_path(head, *data: torch.Tensor, lams, lam_prime,
                         cfg: DantzigConfig = DantzigConfig(), rho_beta=None, rho_theta=None,
                         state_beta: AdmmState | None = None,
                         state_theta: AdmmState | None = None, state_layout: str = "auto",
                         symmetrize: bool = False) -> WorkerPathResult:
    """Every machine's debiased estimate at every lambda of ``lams``.

    The lambda-path analogue of
    :func:`repro_torch.core.pipeline.worker_debiased`: one ``eigh``
    factorizes every machine's Sigma_hat for the whole sweep, the
    (..., d, K) direction block solves at all L grid points in one
    folded solve, and one CLIME solve at ``lam_prime`` debiases every
    grid point:

        beta_tilde_l = beta_hat_l - Theta^T (Sigma beta_hat_l - rhs).

    Under a fused config that is two kernel launches for all machines.
    ``rho_beta`` / ``state_beta`` take the carries of a previous result;
    ``rho_theta`` / ``state_theta`` warm the CLIME solve.
    """
    hs = head.stats(*data)
    factor = as_spectral_factor(hs.sigma)
    dir_path = solve_dantzig_path(factor, hs.rhs, lams, cfg, rho=rho_beta, state=state_beta,
                                  state_layout=state_layout)  # beta: (..., L, d, K)
    cols = torch.arange(hs.rhs.shape[-2], device=hs.rhs.device)
    theta = solve_clime_columns(factor, cols, lam_prime, cfg, rho=rho_theta,
                                state=state_theta)  # (..., d, d)
    if symmetrize:
        theta = symmetrize_min(theta)
    # debias every grid point with the one shared Theta_hat
    resid = hs.sigma.unsqueeze(-3) @ dir_path.beta - hs.rhs.unsqueeze(-3)
    beta_tilde = dir_path.beta - theta.mT.unsqueeze(-3) @ resid
    return WorkerPathResult(beta_tilde=beta_tilde, beta_hat=dir_path.beta, lam=dir_path.lam,
                            kkt=dir_path.kkt, rho_beta=dir_path.rho, stats=hs,
                            state_beta=dir_path.state, iters=dir_path.iters)


def select_by_kkt(result: "PathResult | WorkerPathResult", tol: float = 1e-3) -> torch.Tensor:
    """Index of the smallest lambda whose solve is tol-feasible, per machine.

    Among grid points with ``max_k kkt <= tol`` pick the smallest
    lambda; if none qualify, the smallest violation.  ``kkt`` is
    (..., L, k), reduced over k, or a vector sweep's (..., L) (read as
    such unless L == d, where it takes the (..., L, k) reading).
    Returns (...,) indices into ``result.lam``.
    """
    kkt = result.kkt
    beta = result.beta_tilde if isinstance(result, WorkerPathResult) else result.beta
    if kkt.shape == beta.shape[:-2] + beta.shape[-1:]:
        kkt = kkt.amax(-1)
    feasible = kkt <= tol
    lam_key = torch.where(feasible, result.lam, torch.full_like(kkt, float("inf")))
    return torch.where(feasible.any(-1), lam_key.argmin(-1), kkt.argmin(-1))


def select_by_validation(betas: torch.Tensor, score_fn):
    """Index of the best-scoring estimate along the leading lambda axis.

    ``score_fn(beta) -> scores`` (higher is better), a scalar or one per
    machine, evaluated per grid point; for a machine batch pass the
    lambda axis first (``beta_tilde.movedim(-3, 0)``).  Returns
    ``(index, scores)``: (...,) and (..., L).
    """
    scores = torch.stack([score_fn(betas[i]) for i in range(betas.shape[0])], dim=-1)
    return scores.argmax(-1), scores


def take_lambda(path_values: torch.Tensor, idx) -> torch.Tensor:
    """One grid point of a (..., L, ...) path output: ``idx`` is a scalar or (...,) per machine."""
    idx = torch.as_tensor(idx, device=path_values.device)
    axis = idx.ndim
    index = idx.reshape(*idx.shape, *([1] * (path_values.ndim - axis)))
    return torch.take_along_dim(path_values, index, dim=axis).squeeze(axis)
