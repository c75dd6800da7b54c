"""The cached spectral factor every Dantzig/CLIME solve shares (twin of ``repro.kernels.spectral``).

The exact two-block ADMM iteration solves ``(A^2 + I) beta = v`` once
per iteration.  With one symmetric eigendecomposition ``A = Q L Q^T``
the solve is two matmuls: ``Q diag(1/(L^2+1)) Q^T v``.  The factor
depends only on A, so one factorization serves the direction solve and
every CLIME column of a worker.  Leading dimensions are machines: one
batched ``torch.linalg.eigh`` factorizes every machine's Sigma_hat in
one call.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import obs


class SpectralFactor(NamedTuple):
    """``sigma = q @ diag(evals) @ q.mT``, per machine along leading dimensions."""

    sigma: torch.Tensor  # (..., d, d) the matrix itself (PSD sample covariance)
    q: torch.Tensor  # (..., d, d) orthonormal eigenvectors
    evals: torch.Tensor  # (..., d) eigenvalues

    @property
    def d(self) -> int:
        return self.sigma.shape[-1]

    @property
    def inv_eig(self) -> torch.Tensor:
        """(..., d) diagonal of ``(sigma^2 + I)^{-1}`` in the eigenbasis.

        Recomputed at each use from the raw eigenvalues, as the
        reference does, so a solve handed a factor computes exactly
        what a solve that factorizes internally computes.
        """
        return 1.0 / (self.evals * self.evals + 1.0)


def spectral_factor(sigma: torch.Tensor) -> SpectralFactor:
    """Factorize ``sigma`` once: the only ``eigh`` call in the system.

    A machine whose matrix holds a NaN or an infinity gets an all-NaN
    factor, as the reference's ``eigh`` gives it: LAPACK and cuSOLVER
    may instead raise on such input, so ``eigh`` sees zeros there and
    the NaN is selected in after (finite matrices are factorized as given).
    """
    with obs.span("repro_torch.spectral_factor"):
        finite = torch.isfinite(sigma).all(-1, keepdim=True).all(-2, keepdim=True)
        evals, q = torch.linalg.eigh(torch.where(finite, sigma, 0.0))
    return SpectralFactor(sigma, torch.where(finite, q, float("nan")),
                          torch.where(finite[..., 0], evals, float("nan")))


def as_spectral_factor(a) -> SpectralFactor:
    """Pass a factor through; factorize a raw matrix."""
    if isinstance(a, SpectralFactor):
        return a
    return spectral_factor(a)


def sigma_of(a) -> torch.Tensor:
    """The raw matrix behind either calling convention."""
    return a.sigma if isinstance(a, SpectralFactor) else a
