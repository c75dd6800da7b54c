"""Dantzig solves by exact two-block ADMM on a cached eigendecomposition, in plain PyTorch.

    min ||beta||_1  s.t.  ||A beta - b||_inf <= lam

on the splitting A beta - z = b, beta - w = 0 with over-relaxation
``alpha`` and a fixed penalty ``rho``: each iteration solves
(A^2 + I) beta = v with A = Q diag(e) Q^T, two products.  Leading
dimensions are problems (machines, datasets).  With ``tol`` the columns
are cut into contiguous blocks of ``block`` columns, and every block of
every problem stops on its own once the largest scaled residual,
checked every ``check_every`` iterations, is at most ``tol``; the
iteration count then caps at ``iters``.  The solution is the sparse copy w.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class State(NamedTuple):
    z: torch.Tensor
    w: torch.Tensor
    u1: torch.Tensor
    u2: torch.Tensor


class Factor(NamedTuple):
    a: torch.Tensor  # (..., d, d)
    q: torch.Tensor  # (..., d, d) eigenvectors
    inv: torch.Tensor  # (..., d) 1 / (e^2 + 1)


def factor(a: torch.Tensor) -> Factor:
    evals, q = torch.linalg.eigh(a)
    return Factor(a, q, 1.0 / (evals * evals + 1.0))


def _solve_beta(f: Factor, mm, b, st: State):
    v = mm(f.a, st.z + b - st.u1) + (st.w - st.u2)
    return mm(f.q, f.inv.unsqueeze(-1) * mm(f.q.mT, v))


def _step(f: Factor, mm, b, lam, inv_rho, alpha, st: State) -> State:
    beta = _solve_beta(f, mm, b, st)
    ab = mm(f.a, beta)
    ab_r = alpha * ab + (1.0 - alpha) * (st.z + b)
    beta_r = alpha * beta + (1.0 - alpha) * st.w
    z = torch.minimum(torch.maximum(ab_r - b + st.u1, -lam), lam)
    s = beta_r + st.u2
    w = torch.sign(s) * torch.clamp_min(s.abs() - inv_rho, 0.0)
    return State(z, w, st.u1 + ab_r - z - b, st.u2 + beta_r - w)


def _residual(f: Factor, mm, b, rho, st: State, dz, dw) -> torch.Tensor:
    """max(|A beta - z - b|, |beta - w|, rho_c |A dz + dw|_c) over each problem's block."""
    beta = _solve_beta(f, mm, b, st)
    ab = mm(f.a, beta)
    r_pri = torch.maximum((ab - st.z - b).abs().amax((-2, -1)), (beta - st.w).abs().amax((-2, -1)))
    s_dual = (rho * (mm(f.a, dz) + dw).abs().amax(-2, keepdim=True)).amax((-2, -1))
    return torch.maximum(r_pri, s_dual)


def solve(f: Factor, b: torch.Tensor, lam, *, iters: int, mm, rho: float = 1.0,
          alpha: float = 1.7, tol: float | None = None, check_every: int = 10,
          block: int | None = None, state: State | None = None):
    """``(w, state, counts)``: counts (..., blocks) int32 iterations each block ran."""
    *lead, d, k = b.shape
    bk = k if block is None else max(1, min(block, k))
    nb = -(-k // bk)
    pad = nb * bk - k

    def blocks(x, fill=0.0):  # (..., r, k) -> (..., nb, r, bk), the tail padded with neutral columns
        x = F.pad(x.expand(*lead, x.shape[-2], k), (0, pad), value=fill)
        return x.unflatten(-1, (nb, bk)).movedim(-2, -3)

    cols = torch.ones(1, k, dtype=b.dtype, device=b.device)
    bb = blocks(b)
    lam_b = blocks(lam * cols, 1.0)
    rho_b = blocks(rho * cols, 1.0)
    inv_rho = 1.0 / rho_b
    f4 = Factor(f.a.unsqueeze(-3), f.q.unsqueeze(-3), f.inv.unsqueeze(-2))
    if state is None:
        zero = torch.zeros_like(bb)
        st = State(zero, zero, zero, zero)
    else:
        st = State(*(blocks(leaf) for leaf in state))
    counts = torch.zeros((*lead, nb), dtype=torch.int32, device=b.device)
    if tol is None:
        for _ in range(iters):
            st = _step(f4, mm, bb, lam_b, inv_rho, alpha, st)
        counts += iters
    else:
        active = torch.ones((*lead, nb, 1, 1), dtype=torch.bool, device=b.device)
        done = 0
        while done < iters and bool(active.any()):
            n = min(check_every, iters - done)
            for _ in range(n):
                new = _step(f4, mm, bb, lam_b, inv_rho, alpha, st)
                dz, dw = new.z - st.z, new.w - st.w
                st = State(*(torch.where(active, v, old) for v, old in zip(new, st)))
            done += n
            counts = torch.where(active[..., 0, 0], counts + n, counts)
            res = _residual(f4, mm, bb, rho_b, st, dz, dw)
            active = active & (res > tol)[..., None, None]

    def unblock(x):
        return x.movedim(-3, -2).flatten(-2)[..., :k]

    out = State(*(unblock(leaf) for leaf in st))
    return out.w, out, counts
