"""Streaming refits and resilient serving (twin of ``repro.core.streaming``).

The paper's estimator exists to classify (eq. 1.1); this module is the
layer between the fitted estimator and live traffic:

* **Mergeable sufficient statistics** -- :func:`merge_suff_stats` /
  :func:`merge_mc_stats` combine two chunks' ``SuffStats`` / ``MCStats``
  exactly (per-class rank-1 mean-shift corrections of the pooled
  scatter), so data may arrive in chunks of any size, down to single
  samples.  Counts are 0-d int32 tensors here (``suff_stats`` gives
  Python ints; every function below takes either and returns tensors).
* **Ingest screening** -- :func:`screen_batch` applies the
  :func:`repro_torch.core.faults.screen_weight` policy to the RAW
  arriving batch, each array reduced whole; :func:`ingest_stats` then
  quarantines a poisoned batch with a ``where``-select, leaving the
  accumulated statistics bit-identical to never having seen it.
* **Incremental refit** -- :func:`refit_step` re-solves the estimator
  from merged :class:`~repro_torch.core.pipeline.HeadStats` (one
  ``eigh``, counted by :mod:`repro_torch.analysis`), resuming
  both solves from the previous refit's warm ``AdmmState``/rho; under a
  fused config with ``tol`` they run in K3.  :func:`refit_with_escalation`
  wraps it in the bounded ladder: warm retry, cold retry, full
  refactorize with a boosted iteration budget.
* **Graceful degradation** -- :class:`ModelSlot` double buffering (a
  failed refit never touches the served estimator), the
  live/stale/degraded staleness contract (:func:`slot_status`) and the
  seedable :class:`ServeFaultSchedule` (ingest corruption, refit
  divergence, refresh drops).  The port's schedule draws on a CPU
  ``torch.Generator``, not ``jax.random``: a parity test hands both
  packages the reference's materialized :class:`ServeFaultPlan`.
* **The hot path** -- :func:`classify_batch`: one (B, d) @ (d, K)
  product and an argmax, no ``eigh``, no kernel, no collective.

:class:`ServingRuntime` composes them into the host loop behind
``python -m repro_torch.launch.serve``, with crash recovery through
:mod:`repro_torch.checkpoint` snapshots.
"""

from __future__ import annotations

import time
from typing import Any, NamedTuple, Sequence

import torch

from repro_torch import obs
from repro_torch.analysis.contracts import (
    DtypePolicy,
    GramLaunches,
    Param,
    PrimitiveBudget,
    SmemConformance,
)
from repro_torch.analysis.registry import trace_contract
from repro_torch.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.core import classifier
from repro_torch.core import faults as faults_core
from repro_torch.core import transport as transport_core
from repro_torch.core.dantzig import DantzigConfig
from repro_torch.core.faults import _CORRUPT_CODES, Aggregation
from repro_torch.core.pipeline import (
    HeadStats,
    MCStats,
    SuffStats,
    debias,
    mc_direction_rhs,
    solves_from_stats,
)
from repro_torch.core.slda import hard_threshold
from repro_torch.device import require_device
from repro_torch.kernels.dantzig_fused import AdmmState
from repro_torch.kernels.spectral import SpectralFactor

__all__ = [
    "STATUS_DEGRADED",
    "STATUS_LIVE",
    "STATUS_STALE",
    "EscalationPolicy",
    "ModelSlot",
    "RefitCarry",
    "RefitResult",
    "ServeFaultPlan",
    "ServeFaultSchedule",
    "ServingRuntime",
    "classify_batch",
    "head_stats_of",
    "ingest_stats",
    "merge_mc_stats",
    "merge_stats",
    "merge_suff_stats",
    "refit_converged",
    "refit_step",
    "refit_with_escalation",
    "screen_batch",
    "slot_from_stats",
    "slot_status",
    "snapshot_template",
    "stats_on",
]


# ---------------------------------------------------------------------------
# Mergeable sufficient statistics (chunked / rank-1 streaming ingest)
# ---------------------------------------------------------------------------


def _count(n, like: torch.Tensor) -> torch.Tensor:
    """A class count (Python int or 0-d tensor) as a 0-d int32 tensor beside ``like``."""
    return torch.as_tensor(n, dtype=torch.int32, device=like.device)


def _as_float(n, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(n, device=like.device).to(like.dtype)


def _wmean(ma, na, mb, nb):
    """Count-weighted mean of two class means, safe for empty classes.

    An empty class's mean may be NaN (``suff_stats`` divides by a zero
    count); the contribution is SELECTED out with ``where``, never
    multiplied -- 0 * NaN would re-poison the merge.
    """
    na_f, nb_f = _as_float(na, ma), _as_float(nb, mb)
    num = torch.where(na_f > 0, na_f * ma, 0.0) + torch.where(nb_f > 0, nb_f * mb, 0.0)
    return num / torch.clamp_min(na_f + nb_f, 1.0)


def _shift_outer(ma, na, mb, nb):
    """The rank-1 pooled-scatter correction of one class across a merge.

    ``scatter_ab = scatter_a + scatter_b + w * delta delta^T`` with
    ``w = n_a n_b / (n_a + n_b)`` and ``delta = mu_a - mu_b``: the exact
    parallel-axis decomposition of the within-class scatter.
    """
    na_f, nb_f = _as_float(na, ma), _as_float(nb, mb)
    both = (na_f > 0) & (nb_f > 0)
    w = torch.where(both, na_f * nb_f / torch.clamp_min(na_f + nb_f, 1.0), 0.0)
    delta = torch.where(both, ma - mb, 0.0)
    return w * torch.outer(delta, delta)


def merge_suff_stats(a: SuffStats, b: SuffStats) -> SuffStats:
    """Exact merge of two two-class :class:`SuffStats` accumulators.

    ``sigma`` is the pooled within-class scatter over n1 + n2, so the
    merge rebuilds the scatter, applies the per-class rank-1 mean-shift
    corrections and re-normalizes.  A single sample in ``b`` is the
    rank-1 update.
    """
    n1 = _count(a.n1, a.sigma) + _count(b.n1, a.sigma)
    n2 = _count(a.n2, a.sigma) + _count(b.n2, a.sigma)
    n_a = _as_float(_count(a.n1, a.sigma) + _count(a.n2, a.sigma), a.sigma)
    n_b = _as_float(_count(b.n1, a.sigma) + _count(b.n2, a.sigma), b.sigma)
    scatter = a.sigma * n_a + b.sigma * n_b
    scatter = scatter + _shift_outer(a.mu1, a.n1, b.mu1, b.n1)
    scatter = scatter + _shift_outer(a.mu2, a.n2, b.mu2, b.n2)
    sigma = scatter / torch.clamp_min(n_a + n_b, 1.0)
    return SuffStats(sigma, _wmean(a.mu1, a.n1, b.mu1, b.n1), _wmean(a.mu2, a.n2, b.mu2, b.n2),
                     n1, n2)


def merge_mc_stats(a: MCStats, b: MCStats) -> MCStats:
    """Exact merge of two K-class :class:`MCStats` accumulators.

    The same parallel-axis decomposition, one rank-1 correction per
    class (``mc_suff_stats`` zero-fills empty class means, so the means
    need no NaN guards).
    """
    n_a, n_b = a.counts.sum(), b.counts.sum()
    counts = a.counts + b.counts
    means = ((a.counts[:, None] * a.means + b.counts[:, None] * b.means)
             / torch.clamp_min(counts, 1.0)[:, None])
    delta = a.means - b.means  # (K, d)
    both = (a.counts > 0) & (b.counts > 0)
    w = torch.where(both, a.counts * b.counts / torch.clamp_min(counts, 1.0), 0.0)
    corr = delta.mT @ (w[:, None] * delta)
    sigma = (a.sigma * n_a + b.sigma * n_b + corr) / torch.clamp_min(n_a + n_b, 1.0)
    return MCStats(sigma, means, counts)


def merge_stats(a, b):
    """Type-dispatched merge of two same-head sufficient statistics."""
    if isinstance(a, SuffStats):
        return merge_suff_stats(a, b)
    if isinstance(a, MCStats):
        return merge_mc_stats(a, b)
    raise TypeError(f"unmergeable stats type {type(a).__name__}")


def head_stats_of(aux) -> HeadStats:
    """The pipeline-facing :class:`HeadStats` rebuilt from merged aux statistics.

    Streaming accumulates the aux statistics (they merge exactly); the
    direction right-hand sides are re-derived from them at refit time.
    """
    if isinstance(aux, SuffStats):
        return HeadStats(aux.sigma, aux.mu_d.unsqueeze(-1), aux)
    if isinstance(aux, MCStats):
        return HeadStats(aux.sigma, mc_direction_rhs(aux), aux)
    raise TypeError(f"headless stats type {type(aux).__name__}")


def stats_on(aux, device: str | torch.device = "cuda"):
    """``aux`` with every leaf a tensor on ``device`` (counts as 0-d int32 tensors)."""
    dev = require_device(device)
    if isinstance(aux, SuffStats):
        return SuffStats(aux.sigma.to(dev), aux.mu1.to(dev), aux.mu2.to(dev),
                         _count(aux.n1, aux.sigma).to(dev), _count(aux.n2, aux.sigma).to(dev))
    if isinstance(aux, MCStats):
        return MCStats(*(leaf.to(dev) for leaf in aux))
    raise TypeError(f"unservable stats type {type(aux).__name__}")


# ---------------------------------------------------------------------------
# Ingest screening / quarantine
# ---------------------------------------------------------------------------


def screen_batch(agg: Aggregation, *arrays: torch.Tensor) -> torch.Tensor:
    """Ingest-screening weight in {0., 1.} (a 0-d tensor) over a batch's float arrays.

    Applies the :func:`repro_torch.core.faults.screen_weight` policy to
    the RAW arriving data, each array reduced whole (any shape) --
    before any statistic is formed, so one poisoned batch cannot
    contaminate the accumulators.  Integer arrays (labels) pass unscreened.
    """
    w = torch.ones((), device=arrays[0].device if arrays else None)
    for arr in arrays:
        if arr.is_floating_point():
            w = w * faults_core.screen_weight(agg, arr.reshape(1, -1)).to(w.dtype)
    return w


def ingest_stats(aux, batch_aux, weight: torch.Tensor):
    """Merge a batch's statistics, quarantining when ``weight == 0``.

    The quarantine is a ``where``-SELECT on every leaf: a rejected batch
    leaves the accumulated statistics bit-identical to never having
    seen it (NaN in the discarded merge branch cannot leak).
    """
    merged = merge_stats(aux, batch_aux)
    keep = weight > 0
    return type(merged)(*(torch.where(keep, new, torch.as_tensor(old, dtype=new.dtype,
                                                                  device=new.device))
                          for new, old in zip(merged, aux)))


# ---------------------------------------------------------------------------
# The serving hot path
# ---------------------------------------------------------------------------


@trace_contract(
    "streaming.classify_batch",
    contracts=(
        # a query batch touches NO estimator machinery: the score product
        # is the only matrix product, and there is no eigh, no Dantzig
        # solve (the reference's while / scan), no kernel call and no
        # collective anywhere in the call
        PrimitiveBudget("eigh", exact=0),
        PrimitiveBudget("while", exact=0),
        PrimitiveBudget("scan", exact=0),
        PrimitiveBudget("pallas_call", exact=0),
        GramLaunches(0),
        PrimitiveBudget("psum", exact=0),
        PrimitiveBudget("all_gather", exact=0),
        PrimitiveBudget("dot_general", exact=1),
        DtypePolicy(),
    ),
)
def classify_batch(z: torch.Tensor, beta: torch.Tensor, means: torch.Tensor,
                   priors: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The (B, d) @ (d, K) serving hot path: ``(pred (B,), scores (B, K))``.

    The scores ride along so the serving loop can watch their
    finiteness without a second pass.  One matrix product; the
    per-class offsets and priors are elementwise
    (:func:`repro_torch.core.classifier.classify_scores`).  Its op
    contract (no ``eigh``, no kernel, no collective, one product) is
    declared above it.
    """
    scores = classifier.classify_scores(z, beta, means, priors)
    return scores.argmax(-1), scores


# ---------------------------------------------------------------------------
# Incremental refit + escalation ladder
# ---------------------------------------------------------------------------


class RefitCarry(NamedTuple):
    """Warm-start carries threaded across streaming refits."""

    rho_beta: torch.Tensor  # (K,)
    rho_theta: torch.Tensor  # (d,)
    state_beta: AdmmState  # leaves (d, K)
    state_theta: AdmmState  # leaves (d, d)


class RefitResult(NamedTuple):
    beta_tilde: torch.Tensor  # (d, K) debiased direction block
    beta_hat: torch.Tensor  # (d, K) biased solution
    theta: torch.Tensor  # (d, d) CLIME block
    factor: SpectralFactor  # the refit's ONE factorization
    carry: RefitCarry  # resumable warm state for the next refit
    iters_beta: torch.Tensor  # (K,) executed ADMM iterations
    iters_theta: torch.Tensor  # (d,)


@trace_contract(
    "streaming.refit_step",
    contracts=(
        # ONE fresh factorization per refit -- the moved sigma must be
        # re-factorized, but never twice (direction + CLIME share it)
        PrimitiveBudget("eigh", exact=1),
        PrimitiveBudget("pallas_call", exact=Param("pallas_calls")),
        # statistics in, so no K1
        GramLaunches(0),
        # refit is a single-machine operation: nothing on the wire
        PrimitiveBudget("psum", exact=0),
        PrimitiveBudget("all_gather", exact=0),
        DtypePolicy(),
        SmemConformance(),
    ),
)
def refit_step(stats: HeadStats, lam, lam_prime, cfg: DantzigConfig = DantzigConfig(),
               carry: RefitCarry | None = None, symmetrize: bool = False) -> RefitResult:
    """Re-solve the estimator from merged sufficient statistics.

    The streaming twin of :func:`repro_torch.core.pipeline.worker_solves`:
    the raw-sample pass is replaced by the accumulated
    :class:`HeadStats`, and a ``carry`` resumes both ADMM solves from
    the previous refit's warm rho and :class:`AdmmState`.  The solves
    run through :func:`~repro_torch.core.pipeline.solves_from_stats`,
    so the served estimator is the pipeline's.  Its op contract (one
    ``eigh``, no collective) is declared above it.
    """
    kw = {}
    if carry is not None:
        kw = dict(rho_beta=carry.rho_beta, rho_theta=carry.rho_theta,
                  state_beta=carry.state_beta, state_theta=carry.state_theta)
    ws = solves_from_stats(stats, lam=lam, lam_prime=lam_prime, cfg=cfg,
                           symmetrize=symmetrize, full=True, **kw)
    beta_tilde = debias(stats.sigma, stats.rhs, ws.beta_hat, ws.theta)
    return RefitResult(
        beta_tilde, ws.beta_hat, ws.theta, ws.factor,
        RefitCarry(ws.rho_beta, ws.rho_theta, ws.state_beta, ws.state_theta),
        ws.iters_beta, ws.iters_theta)


def _read(to_host, value: torch.Tensor):
    """``to_host(value)``: a blocking read of a device value, marked as one."""
    with obs.span("repro_torch.host_read"):
        return to_host(value)


def refit_converged(res: RefitResult, cfg: DantzigConfig) -> bool:
    """Host-side convergence verdict for one refit attempt.

    Non-finite output is always a failure.  With a residual tolerance,
    a solve that burned its whole iteration budget without exiting
    early is not converged (``iters == max_iters``; on the fused path
    the counts are per column block); the fixed-iteration schedule
    (``tol=None``) fails only by producing non-finite values.
    """
    if not _read(bool, torch.isfinite(res.beta_tilde).all() & torch.isfinite(res.theta).all()):
        return False
    if cfg.tol is None:
        return True
    executed = max(_read(int, res.iters_beta.max()), _read(int, res.iters_theta.max()))
    return executed < cfg.max_iters


class EscalationPolicy(NamedTuple):
    """Bounded-attempt escalation on refit non-convergence.

    The ladder is warm retry (resume the carry) -> cold retry (fresh
    ADMM state, same statistics) -> full refactorize (fresh state, a
    re-symmetrized sigma and a ``refactor_scale``-boosted iteration
    budget).  ``max_attempts`` bounds how far it is climbed;
    ``backoff_s`` sleeps ``backoff_s * 2^(attempt - 1)`` between rungs.
    """

    max_attempts: int = 3
    backoff_s: float = 0.0
    refactor_scale: int = 2

    def validate(self) -> None:
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.backoff_s < 0:
            raise ValueError("backoff_s must be >= 0")
        if self.refactor_scale < 1:
            raise ValueError("refactor_scale must be >= 1")


def refit_with_escalation(stats: HeadStats, lam, lam_prime, cfg: DantzigConfig,
                          carry: RefitCarry | None,
                          policy: EscalationPolicy = EscalationPolicy(),
                          inject_fail_attempts: int = 0
                          ) -> tuple[RefitResult | None, list[dict]]:
    """Climb the escalation ladder until a refit converges.

    Returns ``(result, attempt_log)``; ``result`` is None when every
    attempt within ``policy.max_attempts`` failed (the caller keeps
    serving the last-good slot and counts a missed refresh).
    ``inject_fail_attempts`` poisons the first n attempts' solutions to
    NaN after solving, so detection and escalation run exactly as a
    genuinely diverged solve would drive them.
    """
    policy.validate()
    ladder: list[tuple[str, RefitCarry | None, DantzigConfig, HeadStats]] = []
    if carry is not None:
        ladder.append(("warm", carry, cfg, stats))
    ladder.append(("cold", None, cfg, stats))
    refactor_cfg = cfg._replace(max_iters=cfg.max_iters * policy.refactor_scale)
    refactor_stats = stats._replace(sigma=0.5 * (stats.sigma + stats.sigma.mT))
    ladder.append(("refactor", None, refactor_cfg, refactor_stats))
    log: list[dict] = []
    for attempt, (name, c, cfg_a, st) in enumerate(ladder[: policy.max_attempts]):
        if attempt > 0 and policy.backoff_s > 0:
            time.sleep(policy.backoff_s * (2 ** (attempt - 1)))
        with obs.span(f"repro_torch.rung.{name}"):
            res = refit_step(st, lam, lam_prime, cfg_a, carry=c)
            if attempt < inject_fail_attempts:
                res = res._replace(beta_tilde=torch.full_like(res.beta_tilde, float("nan")))
            with obs.span("repro_torch.verdict"):
                ok = refit_converged(res, cfg_a)
                log.append({"attempt": name, "converged": ok,
                            "iters_beta": _read(int, res.iters_beta.max()),
                            "iters_theta": _read(int, res.iters_theta.max())})
        if ok:
            return res, log
    return None, log


# ---------------------------------------------------------------------------
# Model slots + the live/stale/degraded contract
# ---------------------------------------------------------------------------

STATUS_LIVE = "live"
STATUS_STALE = "stale"
STATUS_DEGRADED = "degraded"


class ModelSlot(NamedTuple):
    """One immutable published model: everything the hot path reads.

    ``means`` rows are the per-class scoring anchors ``c_k`` of
    ``score_k(z) = (z - c_k / 2) @ beta[:, k] + log priors[k]``.  For the
    K-class head they are the class means; for the binary head the
    anchors are ``mu_k + mu_bar`` with directions ``+-beta / 2``, which
    makes the two-column rule exactly the paper's Fisher rule at equal
    priors.
    """

    beta: torch.Tensor  # (d, Kc) classifier direction columns
    means: torch.Tensor  # (Kc, d) scoring anchors
    priors: torch.Tensor  # (Kc,)
    version: torch.Tensor  # 0-d int32, bumped per publish


def _binary_slot(s: SuffStats, beta: torch.Tensor, version: int) -> ModelSlot:
    beta = beta.reshape(-1)
    mu_bar = 0.5 * (s.mu1 + s.mu2)
    cols = torch.stack([0.5 * beta, -0.5 * beta], dim=1)
    anchors = torch.stack([s.mu1 + mu_bar, s.mu2 + mu_bar])
    n1, n2 = _as_float(s.n1, beta), _as_float(s.n2, beta)
    priors = torch.stack([n1, n2]) / torch.clamp_min(n1 + n2, 1.0)
    return ModelSlot(cols, anchors, priors, _count(version, beta))


def _mc_slot(s: MCStats, beta: torch.Tensor, version: int) -> ModelSlot:
    priors = s.counts / torch.clamp_min(s.counts.sum(), 1.0)
    return ModelSlot(beta, s.means, priors, _count(version, beta))


def slot_from_stats(aux, beta_raw: torch.Tensor, threshold: float,
                    version: int = 0) -> ModelSlot:
    """Publishable :class:`ModelSlot` from a refit and the aux statistics."""
    beta = hard_threshold(beta_raw, threshold)
    if isinstance(aux, SuffStats):
        return _binary_slot(aux, beta, version)
    if isinstance(aux, MCStats):
        return _mc_slot(aux, beta, version)
    raise TypeError(f"slotless stats type {type(aux).__name__}")


def slot_status(missed: int, bound: int) -> str:
    """The bounded-staleness verdict, mirroring ``select_anchor``.

    ``missed`` consecutive missed refreshes clip against the bound like
    a straggler's requested staleness: within it the slot serves as
    ``stale``; past it the server keeps serving the last-good slot but
    reports ``degraded`` -- a reporting contract, not an outage.
    """
    if missed <= 0:
        return STATUS_LIVE
    return STATUS_STALE if missed <= bound else STATUS_DEGRADED


# ---------------------------------------------------------------------------
# Deterministic serving fault plans
# ---------------------------------------------------------------------------


class ServeFaultPlan(NamedTuple):
    """Materialized per-tick fault outcomes, host-side CPU tensors."""

    corrupt: torch.Tensor  # (ticks,) int32 CORRUPT_* code for the ingest batch
    diverge: torch.Tensor  # (ticks,) int32 refit attempts to poison
    drop: torch.Tensor  # (ticks,) bool: the tick's refresh is dropped


class ServeFaultSchedule(NamedTuple):
    """Seedable per-tick serving faults (the :class:`FaultSchedule` twin).

    :meth:`plan` materializes the outcomes, so a chaos run reproduces
    from the seed.  ``corrupt_ingest`` poisons the tick's arriving batch
    (``corrupt_mode`` as in :mod:`repro_torch.core.faults`; ``"mix"``
    cycles NaN/Inf/garbage); ``diverge_refit`` poisons the first 1-2
    refit attempts of the tick's refresh; ``drop_refresh`` skips it.
    """

    corrupt_ingest: float = 0.0
    diverge_refit: float = 0.0
    drop_refresh: float = 0.0
    corrupt_mode: str = "mix"
    seed: int = 0

    def validate(self) -> None:
        for name, p in (("corrupt_ingest", self.corrupt_ingest),
                        ("diverge_refit", self.diverge_refit),
                        ("drop_refresh", self.drop_refresh)):
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {p}")
        if self.corrupt_mode != "mix" and self.corrupt_mode not in _CORRUPT_CODES:
            raise ValueError(f"unknown corrupt_mode {self.corrupt_mode!r}")

    def plan(self, ticks: int) -> ServeFaultPlan:
        """Draw the per-tick outcomes on a CPU ``torch.Generator`` seeded from ``seed``."""
        self.validate()
        gen = torch.Generator().manual_seed(self.seed)
        ticks_idx = torch.arange(ticks)
        hit_c = torch.rand(ticks, generator=gen) < self.corrupt_ingest
        if self.corrupt_mode == "mix":
            code = 1 + ticks_idx % 3
        else:
            code = torch.full((ticks,), _CORRUPT_CODES[self.corrupt_mode])
        corrupt = torch.where(hit_c, code, 0).to(torch.int32)
        hit_d = torch.rand(ticks, generator=gen) < self.diverge_refit
        # alternate 1- and 2-rung divergence so both the cold retry and
        # the full refactorize rung are exercised
        diverge = torch.where(hit_d, 1 + ticks_idx % 2, 0).to(torch.int32)
        drop = torch.rand(ticks, generator=gen) < self.drop_refresh
        return ServeFaultPlan(corrupt, diverge, drop)


# ---------------------------------------------------------------------------
# Checkpoint templates (crash recovery of the serving loop)
# ---------------------------------------------------------------------------


def snapshot_template(aux) -> dict:
    """Zeros tree matching a serving snapshot's structure and shapes, on ``aux``'s device.

    The snapshot is the full last-good serving state: the published
    :class:`ModelSlot`, the accumulated aux statistics, the refit's
    :class:`SpectralFactor` and the warm :class:`RefitCarry` -- what
    :meth:`ServingRuntime.restore` needs to resume serving and refitting.
    """
    dev = aux.sigma.device
    zero = type(aux)(*(torch.zeros_like(torch.as_tensor(leaf, device=dev)) for leaf in aux))
    if isinstance(aux, SuffStats):
        d = aux.mu1.shape[0]
        k_solve, k_cls = 1, 2
        zero = zero._replace(n1=zero.n1.to(torch.int32), n2=zero.n2.to(torch.int32))
    else:
        k_cls, d = aux.means.shape
        k_solve = k_cls

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    slot = ModelSlot(zeros(d, k_cls), zeros(k_cls, d), zeros(k_cls), zeros(dtype=torch.int32))
    factor = SpectralFactor(zeros(d, d), zeros(d, d), zeros(d))
    carry = RefitCarry(zeros(k_solve), zeros(d), AdmmState(*(zeros(d, k_solve),) * 4),
                       AdmmState(*(zeros(d, d),) * 4))
    return {"slot": slot, "aux": zero, "factor": factor, "carry": carry}


# ---------------------------------------------------------------------------
# The serving runtime (host loop)
# ---------------------------------------------------------------------------


class ServingRuntime:
    """Classify-as-a-service over a streaming refit loop.

    The hot path reads only the active :class:`ModelSlot` (double
    buffered: a refit builds its candidate slot off to the side and
    :meth:`refresh` swaps it in on success); ingest screens before
    merging; refits climb the escalation ladder; missed refreshes count
    against the staleness bound.  ``protect=False`` is the deliberately
    fragile baseline -- no screening, no convergence verdict, no
    staleness accounting -- that a chaos run must show degrading.
    Everything lives on ``device`` (the card unless told otherwise).
    """

    def __init__(self, aux, lam: float, lam_prime: float, threshold: float,
                 cfg: DantzigConfig = DantzigConfig(), staleness_bound: int = 2,
                 escalation: EscalationPolicy = EscalationPolicy(),
                 ingest: Aggregation = Aggregation(envelope=1e6), protect: bool = True,
                 ckpt_dir: str | None = None, comm: "transport_core.CommPlan | None" = None,
                 device: str | torch.device = "cuda", _defer_fit: bool = False):
        self.device = require_device(device)
        self.lam, self.lam_prime, self.threshold = lam, lam_prime, threshold
        self.cfg = cfg
        if comm is not None:
            # the CommPlan shim: the plan's staleness bound maps onto the
            # refresh contract, its aggregation onto ingest screening (the
            # refit is single-machine: none of its codecs rides a wire here)
            comm.validate()
            staleness_bound = comm.staleness if comm.staleness > 0 else staleness_bound
            if comm.aggregation is not None:
                ingest = comm.aggregation
        self.staleness_bound = int(staleness_bound)
        self.escalation = escalation
        self.ingest_policy = ingest
        self.protect = bool(protect)
        self.ckpt_dir = ckpt_dir
        self.aux = stats_on(aux, self.device)
        self.carry: RefitCarry | None = None
        self.factor: SpectralFactor | None = None
        self.missed = 0
        self.ladder_log: list[dict] = []
        self.slot: ModelSlot | None = None
        if not _defer_fit:
            res, log = refit_with_escalation(head_stats_of(self.aux), lam, lam_prime, cfg,
                                             None, escalation)
            self.ladder_log.extend(log)
            if res is None:
                raise RuntimeError("initial fit did not converge within "
                                   f"{escalation.max_attempts} attempts")
            self._stage(res, version=1)

    # -- lifecycle ---------------------------------------------------------

    def _stage(self, res: RefitResult, version: int) -> None:
        """Publish a refit: build the candidate slot, then swap it in."""
        candidate = slot_from_stats(self.aux, res.beta_tilde, self.threshold, version)
        # the rebind is the double buffer's commit point: the hot path holds
        # the previous slot until here, and a failed refit never gets here
        self.slot = candidate
        self.carry = res.carry
        self.factor = res.factor
        self.missed = 0
        if self.ckpt_dir is not None:
            save_checkpoint(self.ckpt_dir, version, self.snapshot())

    def snapshot(self) -> dict:
        return {"slot": self.slot, "aux": self.aux, "factor": self.factor, "carry": self.carry}

    @classmethod
    def restore(cls, ckpt_dir: str, aux_like, lam, lam_prime, threshold,
                cfg: DantzigConfig = DantzigConfig(), device: str | torch.device = "cuda",
                **kw) -> "ServingRuntime":
        """Resume serving on ``device`` from the latest readable snapshot.

        ``latest_step`` skips torn and partial writes, so a server killed
        mid-checkpoint restores the previous good snapshot.
        """
        device = require_device(device)
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no restorable checkpoint in {ckpt_dir}")
        snap = restore_checkpoint(ckpt_dir, step, snapshot_template(stats_on(aux_like, device)),
                                  device=device)
        rt = cls(snap["aux"], lam, lam_prime, threshold, cfg=cfg, ckpt_dir=ckpt_dir,
                 device=device, _defer_fit=True, **kw)
        rt.slot = snap["slot"]
        rt.factor = snap["factor"]
        rt.carry = snap["carry"]
        return rt

    @property
    def status(self) -> str:
        return slot_status(self.missed, self.staleness_bound)

    # -- the three serving verbs ------------------------------------------

    def classify(self, z: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The hot path: (B, d) queries -> (pred (B,), scores (B, Kc))."""
        with obs.span("repro_torch.classify"):
            s = self.slot
            return classify_batch(z, s.beta, s.means, s.priors)

    def ingest_batch(self, batch_aux, *raw: torch.Tensor) -> bool:
        """Screen and merge one arriving batch; returns acceptance.

        ``raw`` are the arriving arrays (screened before the statistics
        are touched), ``batch_aux`` their sufficient statistics.  The
        unprotected baseline merges blindly.
        """
        with obs.span("repro_torch.ingest"):
            if not self.protect:
                with obs.span("repro_torch.ingest.merge"):
                    self.aux = merge_stats(self.aux, batch_aux)
                return True
            with obs.span("repro_torch.ingest.screen"):
                w = screen_batch(self.ingest_policy, *raw)
            with obs.span("repro_torch.ingest.merge"):
                self.aux = ingest_stats(self.aux, batch_aux, w)
            return _read(bool, w > 0)

    def refresh(self, drop: bool = False, inject_diverge: int = 0) -> bool:
        """Attempt one model refresh; returns True when published.

        ``drop`` simulates a lost refresh (the staleness path);
        ``inject_diverge`` poisons the first n refit attempts (the
        divergence path).  Failures leave the active slot untouched and
        count a missed refresh against the staleness bound.
        """
        if drop:
            self.missed += 1
            return False
        with obs.span("repro_torch.refresh"):
            if not self.protect:
                # fragile baseline: one attempt, no verdict, publish whatever
                res = refit_step(head_stats_of(self.aux), self.lam, self.lam_prime, self.cfg)
                if inject_diverge > 0:
                    res = res._replace(beta_tilde=torch.full_like(res.beta_tilde, float("nan")))
                self._publish(res)
                return True
            res, log = refit_with_escalation(head_stats_of(self.aux), self.lam, self.lam_prime,
                                             self.cfg, self.carry, self.escalation,
                                             inject_fail_attempts=inject_diverge)
            self.ladder_log.extend(log)
            if res is None:
                self.missed += 1
                return False
            self._publish(res)
            return True

    def _publish(self, res: RefitResult) -> None:
        """Stage a refresh's refit as the next version of the slot."""
        with obs.span("repro_torch.publish"):
            self._stage(res, version=_read(int, self.slot.version) + 1)


def corrupt_batch_arrays(code: int, arrays: Sequence[torch.Tensor]) -> tuple:
    """Apply one tick's ingest corruption to the float arrays of a batch.

    Garbage alternates sign by row, the first axis (a 1-D array's
    entries), as the reference's does.
    """
    out: list[Any] = []
    for arr in arrays:
        if code and arr.is_floating_point():
            rows = arr.reshape(arr.shape[0], -1)
            out.append(faults_core.corrupt_block(code, rows).reshape(arr.shape))
        else:
            out.append(arr)
    return tuple(out)
