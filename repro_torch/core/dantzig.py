"""Dantzig-type l1 solver via two-block ADMM with a cached spectral factor (twin of ``repro.core.dantzig``).

Solves   min ||beta||_1   s.t.  ||A beta - b||_inf <= lam
for PSD ``A`` (a sample covariance): the primitive behind the sparse-LDA
direction (eq. 3.1, ``b = mu_d``) and every CLIME column (eq. 3.3,
``b = e_j``).  Exact two-block ADMM on the splitting

    min ||w||_1 + I_{B_inf(lam)}(z)   s.t.  A beta - z = b,  beta - w = 0

solves ``(A^2 + I) beta = v`` per iteration with one cached
eigendecomposition ``A = Q L Q^T``: two matmuls.  Leading dimensions of
``A`` are machines; every machine and column is solved in one batch.

This module is the scan path of the reference (``solve_dantzig_scan``):
over-relaxation and residual-balancing adaptive rho, in PyTorch eager.
The residual-gated early exit (``cfg.tol``) and warm ``AdmmState``
resumes come with the slice that ports the state kernel (K3).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels.dantzig_fused import AdmmState
from repro_torch.kernels.ref import per_column
from repro_torch.kernels.spectral import SpectralFactor, spectral_factor

NEXT_SLICE = ("comes with the port's next slice (the warm-state, tol-gated "
              "fused kernel K3 and the solver paths that use it)")


class DantzigConfig(NamedTuple):
    """Solver knobs, field for field the reference's."""

    max_iters: int = 600
    rho: float = 1.0
    # over-relaxation coefficient (1.0 disables; 1.5-1.8 typical)
    alpha: float = 1.7
    # residual-balancing: rho *= / /= rho_tau when residuals differ by
    # more than rho_mu x; adapt every `adapt_every` iterations.
    adapt_rho: bool = True
    rho_mu: float = 10.0
    rho_tau: float = 2.0
    adapt_every: int = 10
    # use the soft-threshold kernel (K4) for the shrink step on the card
    use_kernel: bool = False
    # run the WHOLE solve in the fused kernel (K2; fixed rho, no adaptation)
    fused: bool = False
    # explicit columns-per-block override for the fused kernel
    # (None = size the blocks with the Hopper blocking model)
    block_k: int | None = None
    # shared-memory budget in bytes for the fused kernel's blocking model
    # (None = the card's 227 KB; larger values are capped at it)
    vmem_budget: int | None = None
    # residual-gated early exit: not in this slice (see NEXT_SLICE)
    tol: float | None = None
    check_every: int = 10


def soft_threshold(x: torch.Tensor, t, use_kernel: bool = False) -> torch.Tensor:
    """Elementwise shrink; ``use_kernel`` routes through the K4 wrapper."""
    if use_kernel:
        return kops.soft_threshold(x, t)
    return torch.sign(x) * torch.clamp_min(x.abs() - t, 0.0)


def solve_dantzig(a, b: torch.Tensor, lam, cfg: DantzigConfig = DantzigConfig(), *,
                  rho=None) -> torch.Tensor:
    """Thin shim over :func:`repro_torch.core.solver_dispatch.solve_dantzig`."""
    from repro_torch.core import solver_dispatch  # deferred: avoids an import cycle

    return solver_dispatch.solve_dantzig(a, b, lam, cfg, rho=rho)


def solve_dantzig_scan(
    a,
    b: torch.Tensor,
    lam,
    cfg: DantzigConfig = DantzigConfig(),
    rho0=None,
    *,
    return_rho: bool = False,
    state0: AdmmState | None = None,
    return_info: bool = False,
):
    """The eager ADMM loop (adaptive rho lives here).

    ``a``: (..., d, d) matrix or its :class:`SpectralFactor`; ``b``:
    (..., d) or (..., d, k) with the same leading dimensions; ``lam``
    and ``rho0`` scalars, (k,) or (..., k).  With ``return_rho`` the
    final adapted per-problem rho, (..., k), rides along.
    """
    if cfg.tol is not None or state0 is not None or return_info:
        raise NotImplementedError(f"cfg.tol, state0 and return_info {NEXT_SLICE}")
    factor = a if isinstance(a, SpectralFactor) else spectral_factor(a)
    a = factor.sigma
    squeeze = b.ndim == a.ndim - 1
    if squeeze:
        b = b.unsqueeze(-1)
    b = b.expand(*a.shape[:-2], *b.shape[-2:])
    q = factor.q
    qt = q.mT
    inv_eig = factor.inv_eig.unsqueeze(-1)
    lam = per_column(lam, b)

    def solve_m(v):  # (A^2 + I)^{-1} v
        return q @ (inv_eig * (qt @ v))

    zeros = torch.zeros_like(b)
    rho = (per_column(cfg.rho, b) if rho0 is None else per_column(rho0, b)).clone()
    z = w = u1 = u2 = zeros
    alpha = cfg.alpha
    for i in range(cfg.max_iters):
        z0, w0 = z, w
        beta = solve_m(a @ (z0 + b - u1) + (w0 - u2))
        ab = a @ beta
        # over-relaxation mixes in the previous constraint copies
        ab_r = alpha * ab + (1.0 - alpha) * (z0 + b)
        beta_r = alpha * beta + (1.0 - alpha) * w0
        z = torch.minimum(torch.maximum(ab_r - b + u1, -lam), lam)
        w = soft_threshold(beta_r + u2, 1.0 / rho, cfg.use_kernel)
        u1 = u1 + ab_r - z - b
        u2 = u2 + beta_r - w
        if not cfg.adapt_rho or i % cfg.adapt_every:
            continue
        # residual balancing, per problem in the batch.  Skipping the
        # other iterations is exact: the reference scales by 1.0 there.
        r_pri = torch.sqrt(torch.sum((ab - z - b) ** 2 + (beta - w) ** 2, dim=-2, keepdim=True))
        s_dual = rho * torch.sqrt(
            torch.sum((a @ (z - z0)) ** 2 + (w - w0) ** 2, dim=-2, keepdim=True))
        scale = torch.where(r_pri > cfg.rho_mu * s_dual, cfg.rho_tau,
                            torch.where(s_dual > cfg.rho_mu * r_pri, 1.0 / cfg.rho_tau, 1.0))
        rho = rho * scale
        # scaled duals u = y/rho must rescale with rho
        u1 = u1 / scale
        u2 = u2 / scale

    beta = w[..., 0] if squeeze else w
    if not return_rho:
        return beta
    rho = rho[..., 0, :]
    return beta, (rho[..., 0] if squeeze else rho)


def kkt_violation(a: torch.Tensor, b: torch.Tensor, beta: torch.Tensor, lam) -> torch.Tensor:
    """Max constraint violation ``max(||A beta - b||_inf - lam, 0)``, per column."""
    if beta.ndim == a.ndim - 1:
        resid = (a @ beta.unsqueeze(-1)).squeeze(-1) - b
        return torch.clamp_min(resid.abs().amax(-1) - lam, 0.0)
    resid = a @ beta - b
    return torch.clamp_min(resid.abs().amax(-2) - lam, 0.0)
