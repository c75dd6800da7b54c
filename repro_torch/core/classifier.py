"""Fisher discriminant rule and evaluation metrics (twin of ``repro.core.classifier``)."""

from __future__ import annotations

import torch


def classify_scores(z: torch.Tensor, beta: torch.Tensor, mu: torch.Tensor,
                    priors=None) -> torch.Tensor:
    """Batched K-class discriminant scores: (B, d) queries -> (B, K).

    ``score_k(Z) = (Z - mu_k / 2)^T beta_k + log pi_k``: one (B, d) @ (d, K)
    product plus per-class offsets.  ``priors=None`` means equal priors
    (a constant shift, dropped from the argmax).
    """
    proj = z @ beta  # (B, K)
    offset = 0.5 * torch.sum(mu * beta.mT, dim=-1)  # (K,)
    scores = proj - offset.unsqueeze(-2)
    if priors is not None:
        priors = torch.as_tensor(priors, dtype=scores.dtype, device=scores.device)
        scores = scores + torch.log(priors).unsqueeze(-2)
    return scores


def fisher_rule(z: torch.Tensor, beta: torch.Tensor, mu1: torch.Tensor,
                mu2: torch.Tensor) -> torch.Tensor:
    """psi(Z) = 1((Z - (mu1+mu2)/2)^T beta > 0); returns class index {0, 1}.

    Class 0 = N(mu1, Sigma), class 1 = N(mu2, Sigma).
    """
    mu = 0.5 * (mu1 + mu2)
    score = (z - mu) @ beta
    return torch.where(score > 0, 0, 1)


def misclassification_rate(z, labels, beta, mu1, mu2) -> torch.Tensor:
    pred = fisher_rule(z, beta, mu1, mu2)
    return (pred != labels).to(torch.float32).mean()


def support(beta: torch.Tensor, tol: float = 0.0) -> torch.Tensor:
    return beta.abs() > tol


def f1_score(beta_hat: torch.Tensor, beta_star: torch.Tensor) -> torch.Tensor:
    """Support-recovery F1 between an estimate and the truth (paper §5.1)."""
    s_hat = support(beta_hat)
    s_star = support(beta_star)
    inter = (s_hat & s_star).sum().to(torch.float32)
    precision = inter / s_hat.sum().clamp_min(1)
    recall = inter / s_star.sum().clamp_min(1)
    total = precision + recall
    return torch.where(total > 0, 2 * precision * recall / total.clamp_min(1e-30),
                       torch.zeros_like(total))


def estimation_errors(beta_hat: torch.Tensor, beta_star: torch.Tensor) -> dict:
    diff = beta_hat - beta_star
    l2 = torch.sqrt(torch.sum(diff * diff))
    return {
        "l1": diff.abs().sum(),
        "l2": l2,
        "linf": diff.abs().max(),
        "rel_l2": l2 / torch.sqrt(torch.sum(beta_star * beta_star)).clamp_min(1e-30),
    }
