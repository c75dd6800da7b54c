"""Algorithm 1's one-shot fit in plain PyTorch.

Per machine: the pooled within-class covariance, one eigendecomposition,
the direction solve (b = mu1 - mu2, radius lam) and the CLIME block
(b = I, radius lam'), both as fixed-iteration ADMM, the debias
beta_hat - Theta^T (Sigma beta_hat - mu_d); then the mean over machines
and the hard threshold at t.  Leading dimensions are datasets.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from portbench.reference import admm


class Solves(NamedTuple):
    sigma: torch.Tensor  # (..., m, d, d)
    rhs: torch.Tensor  # (..., m, d, 1)
    beta_hat: torch.Tensor  # (..., m, d, 1)
    theta: torch.Tensor  # (..., m, d, d)


def pooled_stats(x: torch.Tensor, y: torch.Tensor, mm):
    """``(sigma, mu1, mu2)``: the pooled within-class covariance of x (..., n1, d), y (..., n2, d)."""
    mu1, mu2 = x.mean(-2), y.mean(-2)
    xc, yc = x - mu1.unsqueeze(-2), y - mu2.unsqueeze(-2)
    sigma = (mm(xc.mT, xc) + mm(yc.mT, yc)) / (x.shape[-2] + y.shape[-2])
    return sigma, mu1, mu2


def solves(xs, ys, lam, lam_prime, iters: int, mm) -> Solves:
    sigma, mu1, mu2 = pooled_stats(xs, ys, mm)
    f = admm.factor(sigma)
    rhs = (mu1 - mu2).unsqueeze(-1)
    d = sigma.shape[-1]
    eye = torch.eye(d, dtype=sigma.dtype, device=sigma.device)
    beta_hat = admm.solve(f, rhs, lam, iters=iters, mm=mm)[0]
    theta = admm.solve(f, eye.expand_as(sigma), lam_prime, iters=iters, mm=mm)[0]
    return Solves(sigma, rhs, beta_hat, theta)


def debias(s: Solves, anchor: torch.Tensor, mm) -> torch.Tensor:
    return anchor - mm(s.theta.mT, mm(s.sigma, anchor) - s.rhs)


def hard_threshold(beta: torch.Tensor, t) -> torch.Tensor:
    return torch.where(beta.abs() > t, beta, torch.zeros_like(beta))


def fit(xs, ys, *, lam, lam_prime, t, iters: int, mm):
    """``(beta_bar (..., d), mean (..., d))``: the thresholded aggregate and the mean before it."""
    s = solves(xs, ys, lam, lam_prime, iters, mm)
    mean = debias(s, s.beta_hat, mm).mean(-3)[..., 0]
    return hard_threshold(mean, t), mean
