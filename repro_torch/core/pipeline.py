"""The one worker pipeline behind every estimator (twin of ``repro.core.pipeline``, unsharded).

Algorithm 1's per-machine schedule -- sufficient statistics, one
eigendecomposition, the direction solve, the CLIME columns, the debias
correction -- written once.  Machines are the leading axis of every
tensor: ``xs`` (m, n1, d) gives (m, d, d) statistics, one batched
``eigh`` and one launch per solve for all m machines.

A head turns a machine batch's samples into ``HeadStats(sigma, rhs,
aux)``: :class:`BinaryHead` (the paper's two-sample problem, K = 1)
or :class:`MulticlassHead` (K classes sharing one covariance, all K
directions in one batched solve).

On the mesh (:mod:`repro_torch.core.distributed`) one rank is one
machine, or one machine's share of the CLIME columns: with
``model_axis`` (the model :class:`~repro_torch.core.collectives.Axis`) the d columns pad to a
multiple of the axis size, each rank solves its ``ceil(d / size)``,
and :func:`apply_correction` reassembles the correction with one
masked gather over the axis, so any (d, size) pair is exact.
"""

from __future__ import annotations

from typing import Any, NamedTuple

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
from repro_torch.core import collectives
from repro_torch.core.clime import (
    solve_clime_columns,
    solve_clime_columns_full,
    solve_clime_columns_joined,
    symmetrize_min,
)
from repro_torch.core.dantzig import DantzigConfig
from repro_torch.core.solver_dispatch import smem_budget, solve_dantzig, solve_dantzig_full
from repro_torch.kernels import ops as kops
from repro_torch.kernels.dantzig_fused import AdmmState, rides_in_tail
from repro_torch.kernels.spectral import SpectralFactor, spectral_factor

# The span around a joined direction and CLIME solve (see :func:`solves_from_stats`), and the
# number of such solves, as the CPU tests count them.
FOLDED_SPAN = "repro_torch.solve.folded"
FOLDS = 0


class HeadStats(NamedTuple):
    """What a head hands the shared pipeline."""

    sigma: torch.Tensor  # (..., d, d) pooled within-class covariance
    rhs: torch.Tensor  # (..., d, K) direction right-hand sides
    aux: Any  # head-specific stats (SuffStats / MCStats)


class SuffStats(NamedTuple):
    """Per-machine sufficient statistics of the two-class sample."""

    sigma: torch.Tensor  # (..., d, d) pooled intra-class covariance
    mu1: torch.Tensor  # (..., d)
    mu2: torch.Tensor  # (..., d)
    n1: int
    n2: int

    @property
    def mu_d(self) -> torch.Tensor:
        return self.mu1 - self.mu2


def suff_stats(x: torch.Tensor, y: torch.Tensor, use_kernel: bool | None = None) -> SuffStats:
    """(Sigma_hat, mu1, mu2) from class samples x: (..., n1, d), y: (..., n2, d).

    Sigma_hat = [sum (X_i-mu1)(X_i-mu1)^T + sum (Y_i-mu2)(Y_i-mu2)^T] / n

    ``use_kernel=None`` takes the gram kernel (K1) when the samples are
    on the card and the plain product elsewhere.
    """
    if use_kernel is None:
        use_kernel = x.is_cuda
    n1, n2 = x.shape[-2], y.shape[-2]
    with obs.span("repro_torch.suff_stats"):
        mu1 = x.mean(-2)
        mu2 = y.mean(-2)
        if use_kernel:
            g1 = kops.gram(x, mu1)
            g2 = kops.gram(y, mu2)
        else:
            xc = x - mu1.unsqueeze(-2)
            yc = y - mu2.unsqueeze(-2)
            g1 = xc.mT @ xc
            g2 = yc.mT @ yc
        sigma = (g1 + g2) / (n1 + n2)
    return SuffStats(sigma, mu1, mu2, n1, n2)


class BinaryHead(NamedTuple):
    """The paper's two-sample head: K = 1, rhs = mu1 - mu2."""

    use_kernel: bool | None = None

    def stats(self, x: torch.Tensor, y: torch.Tensor) -> HeadStats:
        s = suff_stats(x, y, self.use_kernel)
        return HeadStats(s.sigma, s.mu_d.unsqueeze(-1), s)


class MCStats(NamedTuple):
    """Per-machine sufficient statistics of a K-class sample."""

    sigma: torch.Tensor  # (..., d, d) pooled within-class covariance
    means: torch.Tensor  # (..., K, d) class means
    counts: torch.Tensor  # (..., K)


def mc_suff_stats(x: torch.Tensor, labels: torch.Tensor, num_classes: int) -> MCStats:
    """x: (..., n, d), labels: (..., n) in [0, K) -> pooled stats.

    Class sums through the one-hot product, as the reference computes
    them (static shapes, no sort); each sample is centred on its own
    class mean by a gather, and the pooled scatter is one product.
    """
    n = x.shape[-2]
    labels = labels.long()
    onehot = torch.nn.functional.one_hot(labels, num_classes).to(x.dtype)  # (..., n, K)
    counts = onehot.sum(-2)  # (..., K)
    means = (onehot.mT @ x) / counts.clamp_min(1.0).unsqueeze(-1)  # (..., K, d)
    own = torch.take_along_dim(means, labels.unsqueeze(-1), dim=-2)  # (..., n, d)
    centered = x - own
    return MCStats(centered.mT @ centered / n, means, counts)


def mc_direction_rhs(stats: MCStats) -> torch.Tensor:
    """(..., d, K) Dantzig right-hand sides ``mu_k - mu_bar`` (shared mu_bar)."""
    mu_bar = stats.means.mean(-2, keepdim=True)
    return (stats.means - mu_bar).mT


class MulticlassHead(NamedTuple):
    """K-class shared-covariance head: rhs[:, k] = mu_k - mu_bar."""

    num_classes: int

    def stats(self, x: torch.Tensor, labels: torch.Tensor) -> HeadStats:
        s = mc_suff_stats(x, labels, self.num_classes)
        return HeadStats(s.sigma, mc_direction_rhs(s), s)


def debias(sigma: torch.Tensor, rhs: torch.Tensor, beta_hat: torch.Tensor,
           theta_hat: torch.Tensor) -> torch.Tensor:
    """beta_tilde = beta_hat - Theta^T (Sigma beta_hat - rhs)  (eq. 3.4).

    ``rhs``/``beta_hat`` are (..., d) vectors or (..., d, K) blocks.
    """
    vector = beta_hat.ndim == sigma.ndim - 1
    if vector:
        rhs, beta_hat = rhs.unsqueeze(-1), beta_hat.unsqueeze(-1)
    with obs.span("repro_torch.debias"):
        resid = sigma @ beta_hat - rhs
        out = beta_hat - theta_hat.mT @ resid
    return out[..., 0] if vector else out


class WorkerSolves(NamedTuple):
    """One machine batch's heavy lifting: statistics and both solves.

    The warm-carry fields (``rho_*`` / ``state_*`` / ``iters_*``) are
    filled only by ``full=True`` solves; the narrow mode leaves them None.
    """

    stats: HeadStats
    beta_hat: torch.Tensor  # (..., d, K) biased local direction block
    theta: torch.Tensor  # (..., d, d) CLIME block
    valid: torch.Tensor | None  # (cols,) non-pad mask (sharded paths only)
    rho_beta: torch.Tensor | None  # warm carries of the two solves
    rho_theta: torch.Tensor | None
    state_beta: AdmmState | None
    state_theta: AdmmState | None
    iters_beta: torch.Tensor | None  # executed ADMM iterations per column
    iters_theta: torch.Tensor | None
    # the machines' ONE factorization, shared by both solves
    factor: SpectralFactor | None = None


def worker_solves(head, *data: torch.Tensor, lam, lam_prime,
                  cfg: DantzigConfig = DantzigConfig(), model_axis=None,
                  model_axis_size: int = 1, rho_beta=None, rho_theta=None,
                  state_beta: AdmmState | None = None, state_theta: AdmmState | None = None,
                  symmetrize: bool = False, full: bool = False) -> WorkerSolves:
    """Run the machines' ADMM solves (direction block + CLIME columns).

    ``rho_*`` / ``state_*`` thread warm penalties and ADMM states into
    the two solves.  ``full=True`` routes both through
    :func:`~repro_torch.core.solver_dispatch.solve_dantzig_full` and fills
    the warm-carry fields of the result.  ``model_axis`` (a process
    group of ``model_axis_size`` ranks) shards the CLIME columns;
    ``symmetrize`` (eq. 3.3) pairs theta_ij with theta_ji across the
    shards and so needs the unsharded path: both together raise.
    """
    if symmetrize and model_axis is not None:
        raise ValueError(
            "symmetrize=True needs the full (d, d) Theta_hat on one rank; the "
            "model-axis-sharded path would need an extra (d, d) gather to pair "
            "theta_ij with theta_ji (eq. 3.3). Run with model_axis=None to symmetrize.")
    hs = head.stats(*data)
    return solves_from_stats(hs, lam=lam, lam_prime=lam_prime, cfg=cfg,
                             model_axis=model_axis, model_axis_size=model_axis_size,
                             rho_beta=rho_beta, rho_theta=rho_theta, state_beta=state_beta,
                             state_theta=state_theta, symmetrize=symmetrize, full=full)


def model_columns(d: int, index: int, size: int, device=None):
    """Rank ``index`` of a model axis of ``size``: its CLIME columns and their non-pad mask.

    Rank i takes ``i * cols_per + arange(cols_per)``, ``cols_per =
    ceil(d / size)``; pad columns (>= d) clamp to column d - 1 and are
    masked out of the gather.
    """
    cols_per = -(-d // size)
    cols = index * cols_per + torch.arange(cols_per, device=device)
    return cols.clamp_max(d - 1), cols < d


def solves_from_stats(hs: HeadStats, *, lam, lam_prime, cfg: DantzigConfig = DantzigConfig(),
                      model_axis=None, model_axis_size: int = 1, rho_beta=None,
                      rho_theta=None, state_beta: AdmmState | None = None,
                      state_theta: AdmmState | None = None, symmetrize: bool = False,
                      full: bool = False) -> WorkerSolves:
    """The solve body of :func:`worker_solves`, from pre-built statistics.

    In the narrow K2 mode (not ``full``, ``cfg.fused``, no ``cfg.tol``,
    no warm ``rho_*`` or ``state_*``) the direction's K columns ride in
    the CLIME launch wherever its plan has room for them in the masked
    lanes of its last column block
    (:func:`~repro_torch.kernels.dantzig_fused.rides_in_tail`, d = 1,000
    at K = 1): one launch, inside :data:`FOLDED_SPAN`, where the
    direction and the CLIME columns otherwise take one each.  A column's
    result does not depend on its block, so either way gives the same
    answer.
    """
    global FOLDS
    # ONE eigendecomposition for all machines: the direction solve and
    # every CLIME column share this factor (it is rho- and lam-independent).
    factor = spectral_factor(hs.sigma)
    d = hs.rhs.shape[-2]
    if model_axis is None:
        cols = torch.arange(d, device=hs.rhs.device)
        valid = None
    else:
        size = collectives.group_size(model_axis)
        if size != model_axis_size:
            raise ValueError(f"model_axis_size is {model_axis_size}, the model axis has {size}")
        cols, valid = model_columns(d, collectives.group_rank(model_axis), size,
                                    hs.rhs.device)
    carries = dict(rho_beta=None, rho_theta=None, state_beta=None, state_theta=None,
                   iters_beta=None, iters_theta=None)
    if full:
        with obs.span("repro_torch.solve.direction"):
            dir_res = solve_dantzig_full(factor, hs.rhs, lam, cfg, rho=rho_beta,
                                         state=state_beta)
        with obs.span("repro_torch.solve.clime"):
            theta_res = solve_clime_columns_full(factor, cols, lam_prime, cfg, rho=rho_theta,
                                                 state=state_theta)
        beta_hat, theta = dir_res.beta, theta_res.beta
        carries = dict(rho_beta=dir_res.rho, rho_theta=theta_res.rho,
                       state_beta=dir_res.state, state_theta=theta_res.state,
                       iters_beta=dir_res.iters, iters_theta=theta_res.iters)
    elif (cfg.fused and cfg.tol is None
          and all(v is None for v in (rho_beta, rho_theta, state_beta, state_theta))
          and rides_in_tail(d, cols.shape[0], hs.rhs.shape[-1], block_k=cfg.block_k,
                            budget=smem_budget(cfg))):
        FOLDS += 1
        with obs.span(FOLDED_SPAN):
            theta, beta_hat = solve_clime_columns_joined(factor, cols, lam_prime, hs.rhs, lam,
                                                         cfg)
    else:
        with obs.span("repro_torch.solve.direction"):
            beta_hat = solve_dantzig(factor, hs.rhs, lam, cfg, rho=rho_beta, state=state_beta)
        with obs.span("repro_torch.solve.clime"):
            theta = solve_clime_columns(factor, cols, lam_prime, cfg, rho=rho_theta,
                                        state=state_theta)
    if symmetrize:
        theta = symmetrize_min(theta)
    return WorkerSolves(stats=hs, beta_hat=beta_hat, theta=theta, valid=valid, factor=factor,
                        **carries)


def apply_correction(theta: torch.Tensor, valid, resid: torch.Tensor,
                     model_axis=None) -> torch.Tensor:
    """The (..., d, K) debias correction ``Theta^T resid``.

    With ``model_axis`` (``valid`` the non-pad mask of
    :func:`model_columns`) each rank computes its (cols, K) slice, pad
    rows are set to zero, and one tiled gather over the axis puts global
    column j at row j; the pad rows, at d and beyond, are dropped.
    """
    if model_axis is None:
        return theta.mT @ resid
    corr = torch.where(valid[:, None], theta.mT @ resid, 0.0)
    return collectives.all_gather_tiled(corr, model_axis)[:resid.shape[-2]]


@trace_contract(
    "pipeline.worker_debiased",
    contracts=(
        # one SpectralFactor per worker: refinement and the lambda path
        # both reuse it, so a second eigh is always a regression
        PrimitiveBudget("eigh", exact=1),
        # fused cfg: direction solve + CLIME block = exactly 2 launches, or 1
        # where the direction rides in the CLIME launch's last block
        # (rides_in_tail: narrow K2 at d = 1,000, never at these cases' d);
        # scan cfg: none (a third launch means the factor stopped folding)
        PrimitiveBudget("pallas_call", exact=Param("pallas_calls")),
        # the binary head's statistics: two K1 launches on the card
        GramLaunches(Param("gram_launches")),
        # the unsharded worker communicates nothing
        PrimitiveBudget("psum", exact=0),
        PrimitiveBudget("all_gather", exact=0),
        DtypePolicy(),
        SmemConformance(),
    ),
)
def worker_debiased(head, *data: torch.Tensor, lam, lam_prime,
                    cfg: DantzigConfig = DantzigConfig(), symmetrize: bool = False):
    """Every machine's debiased estimate of the (d, K) direction block.

    ``data`` are the head's samples with machines on the leading axis
    (``(xs, ys)`` for :class:`BinaryHead`).  Returns
    ``(beta_tilde, beta_hat, stats)`` with (..., d, K) blocks.
    """
    ws = worker_solves(head, *data, lam=lam, lam_prime=lam_prime, cfg=cfg,
                       symmetrize=symmetrize)
    resid = ws.stats.sigma @ ws.beta_hat - ws.stats.rhs
    correction = apply_correction(ws.theta, None, resid)
    return ws.beta_hat - correction, ws.beta_hat, ws.stats
