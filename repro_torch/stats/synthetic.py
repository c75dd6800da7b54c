"""Synthetic Gaussian generators (paper §5.1 and its K-class extension), twin of ``repro.stats.synthetic``.

The paper's synthetic design: d = 200, Sigma*_jk = 0.8^{|j-k|} (AR(1)),
mu1 = 0, mu2 = (1,...,1,0,...,0) with 10 ones; beta* = Theta* mu_d has
11 nonzeros (AR(1) precision is tridiagonal, so the support widens by
one).  r = n1/n = 0.5.

The problem is built in numpy f64 and cast to f32 exactly as the
reference does, so its tensors equal the reference's bit for bit.  The
samplers draw from a ``torch.Generator``; their numbers differ from
``jax.random``'s by design, so parity tests feed both packages the same
numpy draws instead.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import require_device


class LDAProblem(NamedTuple):
    sigma: torch.Tensor  # (d, d) true covariance
    theta: torch.Tensor  # (d, d) true precision
    mu1: torch.Tensor
    mu2: torch.Tensor
    beta_star: torch.Tensor  # Theta* (mu1 - mu2)
    chol: torch.Tensor  # cholesky(sigma) for sampling


def ar1_covariance(d: int, rho: float = 0.8) -> np.ndarray:
    idx = np.arange(d)
    return rho ** np.abs(idx[:, None] - idx[None, :])


def block_covariance(d: int, block: int = 10, rho: float = 0.5) -> np.ndarray:
    """Block-diagonal equicorrelation: an extra design for ablations."""
    sigma = np.eye(d)
    for start in range(0, d, block):
        end = min(start + block, d)
        sigma[start:end, start:end] = rho
    np.fill_diagonal(sigma, 1.0)
    return sigma


def make_problem(
    d: int = 200,
    n_signal: int = 10,
    rho: float = 0.8,
    signal: float = 1.0,
    design: str = "ar1",
    *,
    device: str | torch.device = "cuda",
) -> LDAProblem:
    """The §5.1 problem: ``design="ar1"`` (the paper's) or ``"block"`` (10-wide blocks of
    equicorrelation min(rho, 0.5))."""
    dev = require_device(device)
    if design == "ar1":
        sigma = ar1_covariance(d, rho)
    elif design == "block":
        sigma = block_covariance(d, rho=min(rho, 0.5))
    else:
        raise ValueError(f"unknown design {design!r}")
    theta = np.linalg.inv(sigma)
    mu1 = np.zeros(d)
    mu2 = np.zeros(d)
    mu2[:n_signal] = signal
    beta_star = theta @ (mu1 - mu2)
    # clean up numerically-zero entries so support metrics are exact
    beta_star[np.abs(beta_star) < 1e-10] = 0.0
    chol = np.linalg.cholesky(sigma)

    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    return LDAProblem(f32(sigma), f32(theta), f32(mu1), f32(mu2), f32(beta_star), f32(chol))


def _on(problem: LDAProblem, device) -> torch.device:
    dev = require_device(device)
    if problem.sigma.device.type != dev.type:
        raise ValueError(
            f"the problem lives on {problem.sigma.device}, the draw was asked for {dev}")
    return problem.sigma.device


def sample_two_class(
    gen: torch.Generator, problem: LDAProblem, n1: int, n2: int, *,
    device: str | torch.device = "cuda",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Draw (X: (n1, d), Y: (n2, d)) from the two Gaussians."""
    dev = _on(problem, device)
    d = problem.mu1.shape[0]
    x = problem.mu1 + torch.randn(n1, d, generator=gen, device=dev) @ problem.chol.T
    y = problem.mu2 + torch.randn(n2, d, generator=gen, device=dev) @ problem.chol.T
    return x, y


def sample_machines(
    gen: torch.Generator, problem: LDAProblem, m: int, n1: int, n2: int, *,
    device: str | torch.device = "cuda",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Draw stacked per-machine shards xs: (m, n1, d), ys: (m, n2, d)."""
    dev = _on(problem, device)
    d = problem.mu1.shape[0]
    xs = problem.mu1 + torch.randn(m, n1, d, generator=gen, device=dev) @ problem.chol.T
    ys = problem.mu2 + torch.randn(m, n2, d, generator=gen, device=dev) @ problem.chol.T
    return xs, ys


def sample_labeled(
    gen: torch.Generator, problem: LDAProblem, n: int, *,
    device: str | torch.device = "cuda",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Equal-prior labeled test draw: returns (Z: (n, d), labels in {0, 1})."""
    dev = _on(problem, device)
    labels = (torch.rand(n, generator=gen, device=dev) < 0.5).to(torch.int32)
    d = problem.mu1.shape[0]
    noise = torch.randn(n, d, generator=gen, device=dev) @ problem.chol.T
    mus = torch.where(labels[:, None] == 0, problem.mu1[None, :], problem.mu2[None, :])
    return mus + noise, labels


def surrogate_from_draws(problem: LDAProblem, labels: torch.Tensor, noise: torch.Tensor,
                         sites: torch.Tensor, site_shift: torch.Tensor) -> torch.Tensor:
    """The surrogate's features from its draws: each class mean, plus ``noise`` (n, d) of
    standard normals through ``problem.chol``, plus the patient's site shift."""
    mus = torch.where(labels[:, None] == 0, problem.mu1[None, :], problem.mu2[None, :])
    return mus + noise @ problem.chol.T + site_shift[sites]


def heart_disease_surrogate(
    gen: torch.Generator, n: int = 920, d: int = 22, n_sites: int = 4, *,
    device: str | torch.device = "cuda",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Offline surrogate for the UCI Heart-Disease experiment (§5.2): (features, labels, sites).

    Synthetic, with the published dimensions (920 patients, 22 numeric
    attributes after dummy-coding, 4 hospitals): strongly correlated
    attributes (AR(0.85), as clinical features are collinear) and a
    mild per-site mean shift.  Drawn from ``gen``; results on it are
    labelled as surrogate.
    """
    dev = require_device(device)
    problem = make_problem(d=d, n_signal=6, rho=0.85, signal=0.8, device=dev)
    labels = (torch.rand(n, generator=gen, device=dev) < 0.5).to(torch.int32)
    noise = torch.randn(n, d, generator=gen, device=dev)
    sites = torch.randint(0, n_sites, (n,), generator=gen, device=dev)
    site_shift = 0.15 * torch.randn(n_sites, d, generator=gen, device=dev)
    return surrogate_from_draws(problem, labels, noise, sites, site_shift), labels, sites


class MCProblem(NamedTuple):
    sigma: torch.Tensor
    theta: torch.Tensor
    means: torch.Tensor  # (K, d)
    betas: torch.Tensor  # (d, K) Theta (mu_k - mu_bar)
    chol: torch.Tensor


def make_mc_problem(
    d: int = 120, num_classes: int = 4, n_signal: int = 6, rho: float = 0.8,
    signal: float = 1.2, *, device: str | torch.device = "cuda",
) -> MCProblem:
    """K classes on disjoint mean supports, shared AR(1) covariance (numpy f64, cast to f32)."""
    dev = require_device(device)
    sigma = ar1_covariance(d, rho)
    theta = np.linalg.inv(sigma)
    means = np.zeros((num_classes, d))
    for k in range(num_classes):
        start = k * n_signal
        means[k, start:start + n_signal] = signal
    mu_bar = means.mean(axis=0)
    betas = theta @ (means - mu_bar).T  # (d, K)
    betas[np.abs(betas) < 1e-10] = 0.0
    chol = np.linalg.cholesky(sigma)

    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    return MCProblem(f32(sigma), f32(theta), f32(means), f32(betas), f32(chol))


def sample_mc_machines(
    gen: torch.Generator, problem: MCProblem, m: int, n_per_machine: int,
    class_probs=None, *, device: str | torch.device = "cuda",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-machine draws: xs (m, n, d), labels (m, n) int64.

    ``class_probs=None`` draws balanced labels (uniform over classes);
    a (K,) probability vector draws imbalanced ones.
    """
    dev = _on(problem, device)
    num_classes, d = problem.means.shape
    if class_probs is None:
        labels = torch.randint(0, num_classes, (m, n_per_machine), generator=gen, device=dev)
    else:
        p = torch.as_tensor(class_probs, dtype=torch.float32, device=dev)
        labels = torch.multinomial(p, m * n_per_machine, replacement=True,
                                   generator=gen).reshape(m, n_per_machine)
    noise = torch.randn(m, n_per_machine, d, generator=gen, device=dev) @ problem.chol.T
    return problem.means[labels] + noise, labels
