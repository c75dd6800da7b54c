"""CLIME precision-matrix estimation (Cai, Liu & Luo 2011), twin of ``repro.core.clime``.

``Theta_hat = argmin ||Theta||_{1,1}  s.t.  ||Sigma_hat Theta - I||_inf <= lam'``
decomposes into d independent Dantzig problems (one per column,
RHS = e_j) that share the matrix, so every column of every machine
solves in one batched call.
"""

from __future__ import annotations

import torch

from repro_torch.core.dantzig import DantzigConfig
from repro_torch.core.solver_dispatch import SolveResult, solve_dantzig, solve_dantzig_full
from repro_torch.kernels.ref import per_column
from repro_torch.kernels.spectral import sigma_of


def _clime_rhs(sigma, cols: torch.Tensor) -> torch.Tensor:
    """(..., d, len(cols)) unit right-hand sides, one per machine of ``sigma``."""
    mat = sigma_of(sigma)
    d = mat.shape[-1]
    rhs = torch.zeros((d, cols.shape[0]), dtype=mat.dtype, device=mat.device)
    rhs[cols, torch.arange(cols.shape[0], device=mat.device)] = 1.0
    return rhs.expand(*mat.shape[:-2], d, cols.shape[0])


def solve_clime_columns(sigma, cols: torch.Tensor, lam, cfg: DantzigConfig = DantzigConfig(),
                        rho=None, state=None) -> torch.Tensor:
    """Solve CLIME for the columns indexed by ``cols``: (..., d, len(cols)).

    ``state`` optionally resumes the block from a previous solve's ADMM
    state (leaves (..., d, len(cols))).
    """
    return solve_dantzig(sigma, _clime_rhs(sigma, cols), lam, cfg, rho=rho, state=state)


def solve_clime_columns_full(sigma, cols: torch.Tensor, lam,
                             cfg: DantzigConfig = DantzigConfig(), rho=None,
                             state=None) -> SolveResult:
    """:func:`solve_clime_columns` returning the full warm-carry :class:`SolveResult`."""
    return solve_dantzig_full(sigma, _clime_rhs(sigma, cols), lam, cfg, rho=rho, state=state)


def solve_clime_columns_joined(sigma, cols: torch.Tensor, lam_prime, rhs: torch.Tensor, lam,
                               cfg: DantzigConfig = DantzigConfig()):
    """:func:`solve_clime_columns` and the Dantzig problems of ``rhs`` (..., d, K) as one solve.

    The K columns go after the CLIME columns, so each CLIME column keeps
    its column block; ``lam_prime`` holds for the CLIME columns, ``lam``
    for the K others, and every column takes ``cfg.rho``.  Returns
    ``(theta, beta)``, contiguous (..., d, len(cols)) and (..., d, K).
    """
    unit = _clime_rhs(sigma, cols)
    rhs = rhs.expand(*unit.shape[:-1], rhs.shape[-1])
    lams = torch.cat([per_column(lam_prime, unit), per_column(lam, rhs)], -1)[..., 0, :]
    w = solve_dantzig(sigma, torch.cat([unit, rhs], -1), lams, cfg)
    k = cols.shape[0]
    return w[..., :k].contiguous(), w[..., k:].to(rhs.dtype).contiguous()


def solve_clime(sigma, lam, cfg: DantzigConfig = DantzigConfig(), rho=None, state=None,
                symmetrize: bool = False) -> torch.Tensor:
    """Full (..., d, d) CLIME estimate, all columns in one batched solve."""
    mat = sigma_of(sigma)
    cols = torch.arange(mat.shape[-1], device=mat.device)
    theta = solve_clime_columns(sigma, cols, lam, cfg, rho=rho, state=state)
    return symmetrize_min(theta) if symmetrize else theta


def symmetrize_min(theta: torch.Tensor) -> torch.Tensor:
    """CLIME symmetrization: keep the entry of smaller magnitude.

    theta_ij <- theta_ij if |theta_ij| <= |theta_ji| else theta_ji.
    """
    take_t = theta.abs() <= theta.mT.abs()
    return torch.where(take_t, theta, theta.mT)
