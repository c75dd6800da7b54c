"""Multi-class distributed sparse LDA (twin of ``repro.core.multiclass``).

K classes share one covariance (Chen's multicategory one-shot schedule):

  * the discriminant directions beta_k* = Theta* (mu_k - mu_bar), with
    mu_bar the grand mean of the class means, all solve Dantzig
    problems with the same Sigma_hat: one batched (d, K) solve;
  * debiasing reuses the one CLIME estimate:
      beta_tilde_k = beta_hat_k - Theta_hat^T (Sigma_hat beta_hat_k - mu_dk);
  * each machine sends one (d, K) block per round;
  * classification: argmax_k (Z - mu_k/2)^T beta_k + log pi_k.

The worker schedule is :mod:`repro_torch.core.pipeline`'s with a
:class:`~repro_torch.core.pipeline.MulticlassHead`; machines lead
every tensor (``xs`` (m, n, d), ``labels`` (m, n)), so a machine batch
is one ``eigh`` and, under a fused config, one K2 launch for the
direction block and one for the CLIME columns.  The lambda path folds
the K*L direction columns into one K3 launch.  The mesh face
(``distributed_mc_slda_shardmap``) comes with the port's mesh slice.
"""

from __future__ import annotations

import torch

from repro_torch.core import classifier
from repro_torch.core import path as _path
from repro_torch.core import pipeline
from repro_torch.core import rounds as _rounds
from repro_torch.core.dantzig import DantzigConfig
from repro_torch.core.pipeline import (  # noqa: F401
    MCStats,
    MulticlassHead,
    mc_direction_rhs,
    mc_suff_stats,
)
from repro_torch.core.slda import hard_threshold
from repro_torch.core.solver_dispatch import solve_dantzig


def local_mc_slda(stats: MCStats, lam, cfg: DantzigConfig = DantzigConfig()) -> torch.Tensor:
    """Batched estimation of all K directions: (..., d, K)."""
    return solve_dantzig(stats.sigma, mc_direction_rhs(stats), lam, cfg)


def mc_debias(stats: MCStats, beta_hat: torch.Tensor, theta_hat: torch.Tensor) -> torch.Tensor:
    """beta_tilde_k = beta_hat_k - Theta^T (Sigma beta_hat_k - mu_dk)."""
    return pipeline.debias(stats.sigma, mc_direction_rhs(stats), beta_hat, theta_hat)


def mc_debiased_local(x: torch.Tensor, labels: torch.Tensor, num_classes: int, lam,
                      lam_prime=None, cfg: DantzigConfig = DantzigConfig(),
                      symmetrize: bool = False) -> tuple[torch.Tensor, MCStats]:
    """The worker pipeline: returns ``(beta_tilde (..., d, K), stats)``."""
    beta_tilde, _, hs = pipeline.worker_debiased(
        MulticlassHead(num_classes), x, labels, lam=lam,
        lam_prime=lam if lam_prime is None else lam_prime, cfg=cfg, symmetrize=symmetrize)
    return beta_tilde, hs.aux


def mc_debiased_local_path(x: torch.Tensor, labels: torch.Tensor, num_classes: int, lams,
                           lam_prime=None, cfg: DantzigConfig = DantzigConfig(), rho_beta=None,
                           state_beta=None, symmetrize: bool = False) -> _path.WorkerPathResult:
    """All K directions at every lambda of ``lams`` in one folded solve.

    One eigendecomposition and one CLIME solve serve the sweep;
    ``lam_prime=None`` pins the CLIME radius to the grid's middle,
    ``lams[L // 2]``.  Returns the (..., L, d, K)-blocked
    :class:`~repro_torch.core.path.WorkerPathResult`.
    """
    lams = torch.as_tensor(lams, dtype=torch.float32, device=x.device)
    if lam_prime is None:
        lam_prime = lams[lams.shape[0] // 2]
    return _path.worker_debiased_path(MulticlassHead(num_classes), x, labels, lams=lams,
                                      lam_prime=lam_prime, cfg=cfg, rho_beta=rho_beta,
                                      state_beta=state_beta, symmetrize=symmetrize)


def simulated_distributed_mc_slda(xs: torch.Tensor, labels: torch.Tensor, num_classes: int,
                                  lam, lam_prime, t, cfg: DantzigConfig = DantzigConfig(),
                                  rounds: int = 1, compression=None, faults=None,
                                  staleness: int = 0, aggregation=None,
                                  comm=None) -> tuple[torch.Tensor, torch.Tensor]:
    """xs (m, n, d), labels (m, n) -> ``(beta_bar (d, K), means (K, d))``.

    One mean of (d, K) blocks per round and the hard threshold
    (``rounds=1``: one shot), through the rounds core as the binary
    face; ``comm`` and the separate comms arguments as in
    :func:`repro_torch.core.rounds.simulate_round_loop`.
    """
    beta_bar, ws = _rounds.simulate_multi_round(
        MulticlassHead(num_classes), (xs, labels), lam=lam, lam_prime=lam_prime,
        rounds=rounds, cfg=cfg, comm=comm, compression=compression, faults=faults,
        staleness=staleness, aggregation=aggregation)
    return hard_threshold(beta_bar, t), ws.stats.aux.means.mean(0)


def mc_multi_round_slda(xs: torch.Tensor, labels: torch.Tensor, num_classes: int, lam,
                        lam_prime, t, rounds: int = 3, cfg: DantzigConfig = DantzigConfig(),
                        compression=None, faults=None, staleness: int = 0, aggregation=None,
                        comm=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The T-round refined K-class estimator (three rounds by default)."""
    return simulated_distributed_mc_slda(xs, labels, num_classes, lam, lam_prime, t, cfg,
                                         rounds, compression, faults, staleness, aggregation,
                                         comm)


def simulated_naive_mc_slda(xs: torch.Tensor, labels: torch.Tensor, num_classes: int, lam,
                            cfg: DantzigConfig = DantzigConfig()
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Baseline: the mean over machines of the biased local estimators (no debias, no HT)."""
    stats = mc_suff_stats(xs, labels, num_classes)
    return local_mc_slda(stats, lam, cfg).mean(0), stats.means.mean(0)


def centralized_mc_slda(x: torch.Tensor, labels: torch.Tensor, num_classes: int, lam,
                        cfg: DantzigConfig = DantzigConfig()) -> tuple[torch.Tensor, torch.Tensor]:
    """Centralized baseline: everything pooled, one batched solve (m = 1, n = N)."""
    stats = mc_suff_stats(x, labels, num_classes)
    return local_mc_slda(stats, lam, cfg), stats.means


def mc_classify(z: torch.Tensor, beta: torch.Tensor, means: torch.Tensor,
                priors=None) -> torch.Tensor:
    """z (n, d), beta (d, K), means (K, d) -> the predicted class (n,)."""
    return classifier.classify_scores(z, beta, means, priors).argmax(-1)
