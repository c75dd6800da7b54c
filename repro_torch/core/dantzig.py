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
over-relaxation, residual-balancing adaptive rho, the residual-gated
early exit (``cfg.tol``) and warm ``AdmmState`` resumes, in PyTorch
eager.  With machines on the leading axes the gate is per machine, as
under the reference's ``vmap`` of its ``while_loop``: a machine that
has converged freezes while the others run on.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels.dantzig_fused import AdmmState
from repro_torch.kernels.ref import gated_chunks, per_column, scaled_residual
from repro_torch.kernels.spectral import SpectralFactor, spectral_factor


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
    # run the WHOLE solve in the fused kernels (K2, or K3 with `tol` or a
    # warm state; fixed rho, no adaptation)
    fused: bool = False
    # explicit columns-per-block override for the fused kernel
    # (None = size the blocks with the Hopper blocking model)
    block_k: int | None = None
    # shared-memory budget in bytes for the fused kernel's blocking model
    # (None = the card's 227 KB; larger values are capped at it)
    vmem_budget: int | None = None
    # residual-gated early exit: stop once the max scaled primal/dual
    # residual is at most `tol`, checking every `check_every` iterations,
    # capped at `max_iters` (None: exactly `max_iters` iterations)
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
    and ``rho0`` scalars, (k,) or (..., k).  ``state0`` resumes from a
    previous solve's :class:`AdmmState` (leaves shaped like ``b``; the
    residual-balancing index restarts at 0).  With ``cfg.tol`` the loop
    runs ``cfg.check_every``-iteration chunks until each machine's max
    scaled residual is at most ``tol``, capped at exactly
    ``cfg.max_iters``.  Returns ``beta``, then the final per-problem rho
    (..., k) with ``return_rho``, then ``(state, iters)`` with
    ``return_info``: iters is each machine's executed count, shaped like
    the leading dimensions.
    """
    factor = a if isinstance(a, SpectralFactor) else spectral_factor(a)
    a = factor.sigma
    batch = a.shape[:-2]
    squeeze = b.ndim == a.ndim - 1
    if squeeze:
        b = b.unsqueeze(-1)
    b = b.expand(*batch, *b.shape[-2:])
    q = factor.q
    qt = q.mT
    inv_eig = factor.inv_eig.unsqueeze(-1)
    lam = per_column(lam, b)

    def solve_m(v):  # (A^2 + I)^{-1} v
        return q @ (inv_eig * (qt @ v))

    zeros = torch.zeros_like(b)
    rho = (per_column(cfg.rho, b) if rho0 is None else per_column(rho0, b)).clone()
    if state0 is None:
        state = (zeros, zeros, zeros, zeros, rho)
    else:
        leaves = [leaf.to(b.dtype) for leaf in state0]
        if squeeze:
            leaves = [leaf.unsqueeze(-1) for leaf in leaves]
        state = (*(leaf.expand_as(b) for leaf in leaves), rho)
    alpha = cfg.alpha

    def iterate(z0, w0, u1, u2, rho, i):
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
            return z, w, u1, u2, rho
        # residual balancing, per problem in the batch.  Skipping the
        # other iterations is exact: the reference scales by 1.0 there.
        r_pri = torch.sqrt(torch.sum((ab - z - b) ** 2 + (beta - w) ** 2, dim=-2, keepdim=True))
        s_dual = rho * torch.sqrt(
            torch.sum((a @ (z - z0)) ** 2 + (w - w0) ** 2, dim=-2, keepdim=True))
        scale = torch.where(r_pri > cfg.rho_mu * s_dual, cfg.rho_tau,
                            torch.where(s_dual > cfg.rho_mu * r_pri, 1.0 / cfg.rho_tau, 1.0))
        # scaled duals u = y/rho must rescale with rho
        return z, w, u1 / scale, u2 / scale, rho * scale

    if cfg.tol is None:
        for i in range(cfg.max_iters):
            state = iterate(*state, i)
        iters = torch.full(batch, cfg.max_iters, dtype=torch.int32, device=b.device)
    else:
        # the balancing index is the global it + j
        state, iters = gated_chunks(
            lambda st, i: iterate(*st, i), state, batch, cfg.max_iters, cfg.check_every,
            cfg.tol, lambda st, dz, dw: scaled_residual(a, q, qt, inv_eig, b, st[4], *st[:4],
                                                        dz, dw))

    z, w, u1, u2, rho = state
    out = (w[..., 0] if squeeze else w,)
    if return_rho:
        rho = rho[..., 0, :]
        out += (rho[..., 0] if squeeze else rho,)
    if return_info:
        leaves = (z, w, u1, u2)
        if squeeze:
            leaves = tuple(v[..., 0] for v in leaves)
        out += (AdmmState(*leaves), iters)
    return out if len(out) > 1 else out[0]


def kkt_violation(a: torch.Tensor, b: torch.Tensor, beta: torch.Tensor, lam) -> torch.Tensor:
    """Max constraint violation ``max(||A beta - b||_inf - lam, 0)``, per column."""
    if beta.ndim == a.ndim - 1:
        resid = (a @ beta.unsqueeze(-1)).squeeze(-1) - b
        return torch.clamp_min(resid.abs().amax(-1) - lam, 0.0)
    resid = a @ beta - b
    return torch.clamp_min(resid.abs().amax(-2) - lam, 0.0)
