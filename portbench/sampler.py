"""The paper's two-class Gaussian design (§5.1), drawn on the device from a seed.

Sigma*_jk = rho^|j - k| (AR(rho)), mu1 = 0, mu2 = (1, ..., 1, 0, ..., 0)
with ``n_signal`` ones, beta* = Theta* (mu1 - mu2).  The problem is built
in numpy float64 and cast to float32; the samples come from a
``torch.Generator`` on the device, in a few large calls, so one seed gives
the same inputs on every run of one card.  The benchmark hands the same
tensors to the port and to the reference.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Problem(NamedTuple):
    mu1: torch.Tensor  # (d,)
    mu2: torch.Tensor  # (d,)
    chol: torch.Tensor  # (d, d) Cholesky factor of Sigma*
    beta_l1: float  # ||beta*||_1, which scales the paper's tuning


def problem(d: int, n_signal: int, rho: float, device) -> Problem:
    idx = np.arange(d)
    sigma = rho ** np.abs(idx[:, None] - idx[None, :])
    mu1, mu2 = np.zeros(d), np.zeros(d)
    mu2[:n_signal] = 1.0
    beta_star = np.linalg.inv(sigma) @ (mu1 - mu2)
    beta_star[np.abs(beta_star) < 1e-10] = 0.0

    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    beta_l1 = float(f32(beta_star).abs().sum())
    return Problem(f32(mu1), f32(mu2), f32(np.linalg.cholesky(sigma)), beta_l1)


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded by ``seed`` (any integer the command line takes)."""
    return torch.Generator(device=device).manual_seed(seed % (2**63))


def two_class(gen: torch.Generator, prob: Problem, lead: tuple, n1: int, n2: int):
    """``(x (*lead, n1, d), y (*lead, n2, d))`` from the two classes."""
    d = prob.mu1.shape[0]
    dev = prob.chol.device
    x = prob.mu1 + torch.randn(*lead, n1, d, generator=gen, device=dev) @ prob.chol.T
    y = prob.mu2 + torch.randn(*lead, n2, d, generator=gen, device=dev) @ prob.chol.T
    return x, y


def queries(gen: torch.Generator, prob: Problem, lead: tuple, n: int) -> torch.Tensor:
    """Equal-prior queries (*lead, n, d): each row from class 1 or class 2 at random."""
    d = prob.mu1.shape[0]
    dev = prob.chol.device
    second = torch.rand(*lead, n, 1, generator=gen, device=dev) < 0.5
    noise = torch.randn(*lead, n, d, generator=gen, device=dev) @ prob.chol.T
    return torch.where(second, prob.mu2, prob.mu1) + noise
