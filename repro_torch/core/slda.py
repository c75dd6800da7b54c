"""Binary sparse-LDA estimation, debiasing and aggregation (twin of ``repro.core.slda``).

  * pooled intra-class covariance  Sigma_hat (gram kernel K1)
  * local Dantzig-type sparse LDA  beta_hat           (eq. 3.1)
  * CLIME precision estimate       Theta_hat          (eq. 3.2)
  * debiased estimator             beta_tilde         (eq. 3.4)
  * hard threshold                 HT(., t)           (eq. 3.5)

Lambda tuning (the paper's lam ∝ sqrt(log d / n) with grid-tuned
constants) goes through :func:`debiased_local_estimator_path`: the whole
grid solves in one folded launch sharing one eigendecomposition
(:mod:`repro_torch.core.path`), and :func:`tune_lambda_validation` picks
each machine's operating point by held-out misclassification.
"""

from __future__ import annotations

import torch

from repro_torch.core import path, pipeline
from repro_torch.core import rounds as _rounds
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


def debiased_local_estimator_path(x: torch.Tensor, y: torch.Tensor, lams, lam_prime=None,
                                  cfg: DantzigConfig = DantzigConfig(), rho_beta=None,
                                  state_beta=None, symmetrize: bool = False
                                  ) -> path.WorkerPathResult:
    """The worker pipeline at every lambda of ``lams``, for every machine at once.

    One eigendecomposition, one folded direction solve and one CLIME
    solve serve the whole grid.  ``lam_prime=None`` pins the CLIME
    radius to the middle of the grid, ``lams[L // 2]``.  ``rho_beta`` /
    ``state_beta`` take the warm carries of a previous sweep's result
    (with ``cfg.tol`` set a resumed sweep exits in fewer iterations).
    Returns the :class:`~repro_torch.core.path.WorkerPathResult`
    ((..., L, d, 1) blocks).
    """
    lams = torch.as_tensor(lams, dtype=torch.float32, device=x.device)
    if lam_prime is None:
        lam_prime = lams[lams.shape[0] // 2]
    return path.worker_debiased_path(BinaryHead(), x, y, lams=lams, lam_prime=lam_prime,
                                     cfg=cfg, rho_beta=rho_beta, state_beta=state_beta,
                                     symmetrize=symmetrize)


def tune_lambda_validation(result: path.WorkerPathResult, z_val: torch.Tensor,
                           labels_val: torch.Tensor):
    """Pick lambda by held-out misclassification of each machine's Fisher rule.

    ``result.stats.aux`` carries every machine's (mu1, mu2), so the rule
    needs only the validation draw z_val (n, d), labels_val (n,).
    Returns ``(idx, error_rates)``: (...,) and (..., L); the tuned
    estimate is ``path.take_lambda(result.beta_tilde, idx)``.
    """
    s = result.stats.aux
    mu = 0.5 * (s.mu1 + s.mu2)  # (..., d)
    scores = (z_val - mu.unsqueeze(-2)) @ result.beta_tilde[..., 0].mT  # (..., n, L)
    pred = torch.where(scores > 0, 0, 1)
    errors = (pred != labels_val.unsqueeze(-1)).to(torch.float32).mean(-2)
    return errors.argmin(-1), errors


def multi_round_slda(xs: torch.Tensor, ys: torch.Tensor, lam, lam_prime, t, rounds: int = 3,
                     cfg: DantzigConfig = DantzigConfig(), compression=None, faults=None,
                     staleness: int = 0, aggregation=None, comm=None) -> torch.Tensor:
    """The T-round refined estimator: xs (m, n1, d), ys (m, n2, d) -> beta_bar (d,).

    ``rounds`` rounds share one set of machine solves (``rounds=1`` is
    the one-shot aggregate); ``comm`` and the separate comms arguments
    as in :func:`repro_torch.core.rounds.simulate_round_loop`.
    """
    beta_bar, _ = _rounds.simulate_multi_round(
        BinaryHead(), (xs, ys), lam=lam, lam_prime=lam_prime, rounds=rounds, cfg=cfg,
        comm=comm, compression=compression, faults=faults, staleness=staleness,
        aggregation=aggregation)
    return hard_threshold(beta_bar[:, 0], t)


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
