"""Binary sparse-LDA estimation, debiasing and aggregation (twin of ``repro.core.slda``).

  * pooled intra-class covariance  Sigma_hat (gram kernel K1)
  * local Dantzig-type sparse LDA  beta_hat           (eq. 3.1)
  * CLIME precision estimate       Theta_hat          (eq. 3.2)
  * debiased estimator             beta_tilde         (eq. 3.4)
  * hard threshold                 HT(., t)           (eq. 3.5)
"""

from __future__ import annotations

import torch

from repro_torch.core import pipeline
from repro_torch.core.dantzig import DantzigConfig
from repro_torch.core.pipeline import BinaryHead, SuffStats, suff_stats  # noqa: F401
from repro_torch.core.solver_dispatch import solve_dantzig


def local_slda(stats: SuffStats, lam, cfg: DantzigConfig = DantzigConfig()) -> torch.Tensor:
    """Biased local estimator beta_hat (eq. 3.1), per machine."""
    return solve_dantzig(stats.sigma, stats.mu_d, lam, cfg)


def debias(stats: SuffStats, beta_hat: torch.Tensor, theta_hat: torch.Tensor) -> torch.Tensor:
    """beta_tilde = beta_hat - Theta_hat^T (Sigma_hat beta_hat - mu_d)  (eq. 3.4)."""
    return pipeline.debias(stats.sigma, stats.mu_d, beta_hat, theta_hat)


def debiased_local_estimator(x: torch.Tensor, y: torch.Tensor, lam, lam_prime=None,
                             cfg: DantzigConfig = DantzigConfig(), symmetrize: bool = False):
    """Full worker-side pipeline: returns (beta_tilde, beta_hat), (..., d) each."""
    beta_tilde, beta_hat, _ = pipeline.worker_debiased(
        BinaryHead(), x, y, lam=lam, lam_prime=lam if lam_prime is None else lam_prime,
        cfg=cfg, symmetrize=symmetrize)
    return beta_tilde[..., 0], beta_hat[..., 0]


def hard_threshold(beta: torch.Tensor, t) -> torch.Tensor:
    """HT(beta, t)_j = beta_j * 1(|beta_j| > t)."""
    return torch.where(beta.abs() > t, beta, torch.zeros_like(beta))


def aggregate(beta_tildes: torch.Tensor, t) -> torch.Tensor:
    """Master-side aggregation (eq. 3.5): mean over machines + HT."""
    return hard_threshold(beta_tildes.mean(0), t)


def centralized_slda(x: torch.Tensor, y: torch.Tensor, lam, cfg: DantzigConfig = DantzigConfig(),
                     use_kernel: bool | None = None) -> torch.Tensor:
    """Centralized baseline: pool everything, solve (3.1) once (m=1, n=N)."""
    return local_slda(suff_stats(x, y, use_kernel), lam, cfg)
