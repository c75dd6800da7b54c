"""Plain PyTorch versions of every kernel (twin of ``repro.kernels.ref``).

The CPU path runs these; on the card they are what each kernel is held
against.  Leading dimensions are machines.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.dantzig_fused import AdmmState


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
        z, w, u1, u2 = _admm_iteration(a, q, qt, inv, b, lam, 1.0 / rho, alpha, z, w, u1, u2)
    return w


def _admm_iteration(a, q, qt, inv, b, lam, inv_rho, alpha, z, w, u1, u2):
    """One exact two-block ADMM iteration, as the kernels compute it."""
    beta = q @ (inv * (qt @ (a @ (z + b - u1) + (w - u2))))
    ab = a @ beta
    ab_r = alpha * ab + (1.0 - alpha) * (z + b)
    beta_r = alpha * beta + (1.0 - alpha) * w
    z_new = torch.minimum(torch.maximum(ab_r - b + u1, -lam), lam)
    w_new = soft_threshold_ref(beta_r + u2, inv_rho)
    u1 = u1 + ab_r - z_new - b
    u2 = u2 + beta_r - w_new
    return z_new, w_new, u1, u2


def dantzig_fused_state_ref(a, q, inv_eig, b, lam, *, iters=500, rho=1.0, alpha=1.7,
                            block_k=None, tol=None, check_every=10,
                            state: AdmmState | None = None, trace: list | None = None):
    """The state kernel's (K3's) math in plain PyTorch.

    Shapes as :func:`dantzig_fused_ref`; ``state`` leaves broadcast to
    ``b``'s shape (None: the zero state).  With ``tol`` None, ``iters``
    iterations from ``state``.  Otherwise the columns are cut into
    contiguous blocks of ``block_k`` (None: one block), the ragged tail
    padded with neutral columns (b = 0, lam = rho = 1, zero state), and
    every block of every machine is gated on its own by
    :func:`gated_chunks` on :func:`scaled_residual`.  Returns
    ``(w, state, iters)`` with iters (..., num_blocks) int32.
    ``trace``, a list, receives every chunk's (..., num_blocks) residual.
    """
    b = b.to(torch.float32)
    *batch, d, k = b.shape
    bk = k if block_k is None else max(1, min(block_k, k))
    nb = -(-k // bk)
    pad = nb * bk - k

    def blocks(x, fill=0.0):  # (..., r, k) -> (..., nb, r, bk), the tail padded
        x = F.pad(x.expand(*batch, x.shape[-2], k), (0, pad), value=fill)
        return x.unflatten(-1, (nb, bk)).movedim(-2, -3)

    bb = blocks(b)
    lam_b = blocks(per_column(lam, b), 1.0)
    rho_b = blocks(per_column(rho, b), 1.0)
    inv_rho = 1.0 / rho_b
    a4, q4 = a.unsqueeze(-3), q.unsqueeze(-3)
    qt4 = q4.mT
    inv = inv_eig.unsqueeze(-1).unsqueeze(-3)
    if state is None:
        z = w = u1 = u2 = torch.zeros_like(bb)
    else:
        z, w, u1, u2 = (blocks(leaf.to(torch.float32)) for leaf in state)

    if tol is None:
        for _ in range(iters):
            z, w, u1, u2 = _admm_iteration(a4, q4, qt4, inv, bb, lam_b, inv_rho, alpha,
                                           z, w, u1, u2)
        counts = torch.full((*batch, nb), iters, dtype=torch.int32, device=b.device)
    else:
        (z, w, u1, u2), counts = gated_chunks(
            lambda st, _: _admm_iteration(a4, q4, qt4, inv, bb, lam_b, inv_rho, alpha, *st),
            (z, w, u1, u2), (*batch, nb), iters, check_every, tol,
            lambda st, dz, dw: scaled_residual(a4, q4, qt4, inv, bb, rho_b, *st, dz, dw),
            trace)

    def unblock(x):
        return x.movedim(-3, -2).flatten(-2)[..., :k]

    z, w, u1, u2 = map(unblock, (z, w, u1, u2))
    return w, AdmmState(z, w, u1, u2), counts


def scaled_residual(a, q, qt, inv, b, rho, z, w, u1, u2, dz, dw) -> torch.Tensor:
    """The residual gate's max scaled residual over each problem's (d, k) block.

    max(|A beta - z - b|, |beta - w|, rho_c |A dz + dw|_c), with beta
    the next iteration's solve from (z, w, u1, u2) and dz, dw the last
    iteration's deltas; reduced over the last two axes, keeping NaN.
    """
    beta = q @ (inv * (qt @ (a @ (z + b - u1) + (w - u2))))
    ab = a @ beta
    r_pri = torch.maximum((ab - z - b).abs().amax((-2, -1)), (beta - w).abs().amax((-2, -1)))
    s_dual = (rho * (a @ dz + dw).abs().amax(-2, keepdim=True)).amax((-2, -1))
    return torch.maximum(r_pri, s_dual)


def gated_chunks(step, state: tuple, shape: tuple, iters: int, check_every: int, tol: float,
                 residual, trace: list | None = None):
    """The chunked residual gate of K3 and of the scan solver, per problem of ``shape``.

    ``step(state, i)`` is iteration ``i`` (the global index) on a tuple
    whose leaves lead with ``shape`` + (rows, cols), z and w first;
    ``residual(state, dz, dw)`` gives a ``shape`` tensor.  Chunks of
    ``check_every`` iterations, the last clamped so the cap is exactly
    ``iters``, run until a problem's residual is at most ``tol`` (a NaN
    residual stops it too); a stopped problem freezes while the others
    run on.  Returns ``(state, counts)`` with int32 counts of ``shape``.
    """
    device = state[0].device
    active = torch.ones((*shape, 1, 1), dtype=torch.bool, device=device)
    counts = torch.zeros(shape, dtype=torch.int32, device=device)
    it = 0
    while it < iters and bool(active.any()):
        n = min(check_every, iters - it)
        for j in range(n):
            new = step(state, it + j)
            dz, dw = new[0] - state[0], new[1] - state[1]
            state = tuple(torch.where(active, v, old) for v, old in zip(new, state))
        it += n
        counts = torch.where(active[..., 0, 0], counts + n, counts)
        res = residual(state, dz, dw)
        if trace is not None:
            trace.append(res)
        active = active & (res > tol)[..., None, None]
    return state, counts
