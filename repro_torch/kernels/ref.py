"""Plain PyTorch versions of every kernel (twin of ``repro.kernels.ref``).

The CPU path runs these; on the card they are what each kernel is held
against.  Leading dimensions are machines.
"""

from __future__ import annotations

import torch


def per_column(v, b: torch.Tensor) -> torch.Tensor:
    """A scalar, (k,) or (..., k) value as a (..., 1, k) row for ``b`` of shape (..., d, k)."""
    v = torch.as_tensor(v, dtype=torch.float32, device=b.device)
    *batch, _, k = b.shape
    if v.ndim:
        v = v.unsqueeze(-2)
    return v.expand(*batch, 1, k)


def gram_ref(x: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """(X - mu)^T (X - mu) in float32: x (..., n, d), mu (..., d) -> (..., d, d)."""
    xc = (x - mu.unsqueeze(-2)).to(torch.float32)
    return xc.mT @ xc


def soft_threshold_ref(x: torch.Tensor, t) -> torch.Tensor:
    """sign(x) * max(|x| - t, 0); ``t`` a scalar or a tensor that broadcasts (per column)."""
    return torch.sign(x) * torch.clamp_min(x.abs() - t, 0.0)


def hard_threshold_ref(x: torch.Tensor, t) -> torch.Tensor:
    return torch.where(x.abs() > t, x, torch.zeros_like(x))


def dantzig_fused_ref(a, q, inv_eig, b, lam, *, iters=500, rho=1.0, alpha=1.7):
    """The fused ADMM kernel's math in plain PyTorch.

    a, q: (..., d, d); inv_eig: (..., d); b: (..., d, k); ``lam`` and
    ``rho`` scalars, (k,) per column or (..., k) per machine and column.
    """
    b = b.to(torch.float32)
    inv = inv_eig.unsqueeze(-1)
    lam = per_column(lam, b)
    rho = per_column(rho, b)
    qt = q.mT

    z = w = u1 = u2 = torch.zeros_like(b)
    for _ in range(iters):
        beta = q @ (inv * (qt @ (a @ (z + b - u1) + (w - u2))))
        ab = a @ beta
        ab_r = alpha * ab + (1.0 - alpha) * (z + b)
        beta_r = alpha * beta + (1.0 - alpha) * w
        z = torch.minimum(torch.maximum(ab_r - b + u1, -lam), lam)
        w = soft_threshold_ref(beta_r + u2, 1.0 / rho)
        u1 = u1 + ab_r - z - b
        u2 = u2 + beta_r - w
    return w
