"""The kernel wrappers every caller goes through (twin of ``repro.kernels.ops``).

A wrapper given CUDA tensors launches its hand-written kernel, or
raises; given CPU tensors it runs the kernel's plain PyTorch version
from :mod:`repro_torch.kernels.ref`.  This replaces the reference's
per-call ``interpret`` switch: the tensor's device decides.  Nothing
falls back from the card to the plain version.

``LAUNCHES`` counts the kernel launches each wrapper made; it is the
evidence that a run on the card went through the kernels.
``LAUNCH_SHAPES`` splits the same launches by the kernel's operand
shape, ``(name, m, rows, cols)``: x (m, n, d) for ``gram``, b
(m, d, k) for the ADMM kernels, x for ``soft_threshold``.
``CALLS`` and ``CALL_SHAPES`` count the wrapper calls the same way on
either device (on the CPU a call runs the plain version and launches
nothing; on the card every call launches once), and ``CALL_BLOCKS``
the ADMM kernels' calls by ``(name, d, k, block_k)``, the columns per
block each used: the op contracts of :mod:`repro_torch.analysis` read them.
"""

from __future__ import annotations

import collections
import math

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.dantzig_fused import (
    AdmmState,
    FusedSolveResult,
    dantzig_fused_cuda,
    dantzig_fused_state_cuda,
    plan_launch,
)
from repro_torch.kernels.gram import gram_cuda
from repro_torch.kernels.soft_threshold import soft_threshold_cuda
from repro_torch.kernels.spectral import as_spectral_factor

KERNELS = ("gram", "dantzig_fused", "dantzig_fused_state", "soft_threshold")
LAUNCHES = dict.fromkeys(KERNELS, 0)
LAUNCH_SHAPES: collections.Counter = collections.Counter()
CALLS = dict.fromkeys(KERNELS, 0)
CALL_SHAPES: collections.Counter = collections.Counter()
CALL_BLOCKS: collections.Counter = collections.Counter()


def reset_launches() -> None:
    """Zero the launch and the call counts."""
    for name in KERNELS:
        LAUNCHES[name] = CALLS[name] = 0
    for counter in (LAUNCH_SHAPES, CALL_SHAPES, CALL_BLOCKS):
        counter.clear()


def _count(name: str, operand: torch.Tensor) -> None:
    LAUNCHES[name] += 1
    LAUNCH_SHAPES[(name, *operand.shape)] += 1


def _called(name: str, shape: tuple, block: tuple | None = None) -> None:
    """One wrapper call, on either device; ``block`` is an ADMM call's (d, k, block_k)."""
    CALLS[name] += 1
    CALL_SHAPES[(name, *shape)] += 1
    if block is not None:
        CALL_BLOCKS[(name, *block)] += 1


def _machines_shape(batch, *tail) -> tuple:
    """The kernels' (m, ...) operand shape of a batch with leading dimensions ``batch``."""
    return (math.prod(batch), *tail)


def _on_card(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type != "cpu":
        raise ValueError(f"the port runs on CUDA or the CPU, not {t.device}")
    return False


def gram(x: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """Mean-centered Gram (X - mu)^T (X - mu): x (..., n, d), mu (..., d) -> (..., d, d)."""
    _called("gram", _machines_shape(x.shape[:-2], *x.shape[-2:]))
    if not _on_card(x):
        return ref.gram_ref(x, mu)
    *batch, n, d = x.shape
    x = x.reshape(-1, n, d).contiguous()
    out = gram_cuda(x, mu.reshape(-1, d).contiguous())
    _count("gram", x)
    return out.reshape(*batch, d, d)


def soft_threshold(x: torch.Tensor, t) -> torch.Tensor:
    """Shrink sign(x) * max(|x| - t, 0); ``t`` scalar or per column, (..., 1, c)."""
    _called("soft_threshold", tuple(x.shape))
    if not _on_card(x):
        return ref.soft_threshold_ref(x, t)
    out = soft_threshold_cuda(x.contiguous(), t)
    _count("soft_threshold", x)
    return out


def dantzig_fused(a, b: torch.Tensor, lam, *, iters: int = 500, rho=1.0,
                  alpha: float = 1.7, block_k: int | None = None, tol: float | None = None,
                  check_every: int = 10, state: AdmmState | None = None,
                  return_info: bool = False):
    """Whole Dantzig/CLIME ADMM solve in the fused kernels.

    ``a`` is a (..., d, d) matrix, factorized here, or its
    :class:`~repro_torch.kernels.spectral.SpectralFactor`, used as is.
    ``b`` is (..., d, k) with the same leading (machine) dimensions;
    ``lam`` and ``rho`` are scalars, (k,) per column or (..., k).

    With none of ``tol``, ``state`` and ``return_info`` this is K2:
    ``iters`` iterations from zero, returning the sparse ADMM copy w,
    shaped like ``b``.  Any of them routes to K3: ``state`` (leaves
    shaped like ``b``) resumes a solve, ``tol`` gates each column block
    on its max scaled residual every ``check_every`` iterations (capped
    at ``iters``), and ``return_info`` returns the
    :class:`~repro_torch.kernels.dantzig_fused.FusedSolveResult`, whose
    ``iters`` is (..., num_blocks).  The call is planned once
    (:func:`~repro_torch.kernels.dantzig_fused.plan_launch`, ``block_k``
    None: the blocking rule's choice), on every device: its columns per
    block go to ``CALL_BLOCKS``, to the launcher and to the plain K3, so
    the gated blocks are the same on the card and the CPU.
    """
    factor = as_spectral_factor(a)
    *batch, d, k = b.shape
    state_io = tol is not None or state is not None or return_info
    name = "dantzig_fused_state" if state_io else "dantzig_fused"
    bk = plan_launch(d, k, block_k, state_io).block_k
    _called(name, _machines_shape(batch, d, k), (d, k, bk))
    if state_io:
        result = _dantzig_fused_state(factor, b, lam, iters, rho, alpha, bk, tol,
                                      check_every, state)
        return result if return_info else result.beta
    if not _on_card(b):
        return ref.dantzig_fused_ref(factor.sigma, factor.q, factor.inv_eig, b, lam,
                                     iters=iters, rho=rho, alpha=alpha)
    operands = _machines(factor, b, lam, rho)
    out = dantzig_fused_cuda(*operands, iters=iters, alpha=alpha, block_k=bk)
    _count("dantzig_fused", operands[3])
    return out.reshape(*batch, d, k)


def _machines(factor, b, lam, rho):
    """The kernels' operands: every argument as a contiguous (m, ...) tensor."""
    *batch, d, k = b.shape

    def machines(t, *tail):
        return t.expand(*batch, *tail).reshape(-1, *tail).contiguous()

    cols = (*batch, k)
    return (machines(factor.sigma, d, d), machines(factor.q, d, d),
            machines(factor.inv_eig, d), machines(b.to(torch.float32), d, k),
            ref.per_column(lam, b).reshape(cols).contiguous().reshape(-1, k),
            ref.per_column(rho, b).reshape(cols).contiguous().reshape(-1, k))


def _dantzig_fused_state(factor, b, lam, iters, rho, alpha, bk, tol, check_every,
                         state) -> FusedSolveResult:
    """K3 on the card, its plain version on the CPU, with ``bk`` columns per block."""
    if not _on_card(b):
        w, fstate, counts = ref.dantzig_fused_state_ref(
            factor.sigma, factor.q, factor.inv_eig, b, lam, iters=iters, rho=rho,
            alpha=alpha, block_k=bk, tol=tol, check_every=check_every, state=state)
        return FusedSolveResult(w, fstate, counts)
    *batch, d, k = b.shape
    leaves = None
    if state is not None:
        leaves = AdmmState(*(leaf.to(torch.float32).expand(*batch, d, k).reshape(-1, d, k)
                             .contiguous() for leaf in state))
    operands = _machines(factor, b, lam, rho)
    out = dantzig_fused_state_cuda(*operands, leaves, iters=iters, alpha=alpha, tol=tol,
                                   check_every=check_every, block_k=bk)
    _count("dantzig_fused_state", operands[3])
    fstate = AdmmState(*(leaf.reshape(*batch, d, k) for leaf in out.state))
    return FusedSolveResult(fstate.w, fstate, out.iters.reshape(*batch, -1))
