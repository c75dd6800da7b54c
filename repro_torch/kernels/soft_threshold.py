"""K4, the ADMM shrink step as a Triton kernel (twin of ``repro.kernels.soft_threshold``).

``out = sign(x) * max(|x| - t, 0)`` elementwise: one read and one write
per element, bound by device-memory bytes.  Triton's masked block loads
express it completely, so this kernel, unlike K1 and K2, is Triton and
not CUDA C++.  ``t`` is a Python scalar or a per-column tensor: the scan
solver shrinks by ``1/rho`` with one rho per machine and column.

``triton`` is imported on the first launch, not when this module is
imported, so the module imports on machines without Triton.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _launch

BLOCK = 1024

tl = None  # triton.language, bound by _kernel() on the first launch
_KERNEL = None


def _soft_threshold_body(x_ptr, t_ptr, out_ptr, numel, c, rc, t_scalar,
                         PER_COLUMN: tl.constexpr, BLOCK: tl.constexpr):
    offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    mask = offs < numel
    x = tl.load(x_ptr + offs, mask=mask, other=0.0)
    if PER_COLUMN:
        # t is (batch, c): element (b, i, j) of x reads t[b, j]
        t = tl.load(t_ptr + (offs // rc) * c + offs % c, mask=mask, other=0.0)
    else:
        t = t_scalar
    mag = tl.maximum(tl.abs(x) - t, 0.0)
    sign = tl.where(x > 0, 1.0, tl.where(x < 0, -1.0, 0.0))
    tl.store(out_ptr + offs, sign * mag, mask=mask)


def _kernel():
    global tl, _KERNEL
    if _KERNEL is None:
        import triton
        import triton.language

        tl = triton.language
        _KERNEL = triton.jit(_soft_threshold_body)
    return _KERNEL


def soft_threshold_triton(x: torch.Tensor, t) -> torch.Tensor:
    """Launch K4 on a CUDA tensor ``x`` of shape (..., r, c) or (c,).

    ``t`` is a Python number, or a tensor that broadcasts to
    ``x.shape[:-2] + (1, c)`` (one threshold per machine and column).
    """
    if x.device.type != "cuda":
        raise ValueError(f"soft_threshold_triton needs a CUDA tensor, got {x.device}")
    _launch.check_operand("x", x, tuple(x.shape), x.device)
    c = x.shape[-1] if x.ndim else 1
    rc = x.shape[-1] * x.shape[-2] if x.ndim >= 2 else c
    numel = x.numel()
    out = torch.empty_like(x)
    if numel == 0:
        return out
    if isinstance(t, (int, float)):
        per_column, t_tensor, t_scalar = False, x, float(t)
    else:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"t must be a number or a tensor, got {type(t).__name__}")
        batch = tuple(x.shape[:-2])
        rows = (*batch, 1, c) if x.ndim >= 2 else (c,)
        if t.dtype != torch.float32 or t.device != x.device:
            raise TypeError("t must be a float32 tensor on x's device")
        t_tensor = t.expand(rows).contiguous()
        per_column, t_scalar = True, 0.0
    grid = (-(-numel // BLOCK),)
    _kernel()[grid](x, t_tensor, out, numel, c, rc, t_scalar,
                    PER_COLUMN=per_column, BLOCK=BLOCK)
    return out

