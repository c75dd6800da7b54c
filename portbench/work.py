"""The yardstick's frozen arithmetic: the card's peaks and the work K2 has to do.

Peaks are NVIDIA's data sheet for an H100 SXM at its full 700 W power
limit: 67 TFLOP/s in float32 outside the tensor cores, 3.35 TB/s of HBM3.
A roofline share is the least time the card could take for the work,
the larger of operations over the peak rate and bytes over the peak
bandwidth, divided by the time the device took.
"""

from __future__ import annotations

PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def fixed_kernel_work(m: int, d: int, k: int, iters: int) -> tuple[int, int]:
    """(FLOP, bytes) of K2's function on a (m, d, k) batch for ``iters`` iterations.

    Per iteration four (d, d) x (d, k) products and ~20 elementwise
    operations per entry; A, Q, inv, b, lam and rho read once, w written
    once.
    """
    return (iters * m * (8 * d * d * k + 20 * d * k),
            4 * (2 * m * d * d + m * d + 2 * m * d * k + 2 * m * k))


def bound_ms(flops: float, nbytes: float) -> float:
    """The least milliseconds the card could take for this work."""
    return 1e3 * max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES)


def gram_flops(m: int, n: int, d: int) -> int:
    """FLOP of K1's centred gram on (m, n, d) samples: the (d, d) product per machine."""
    return 2 * m * n * d * d


def fit_flops(m: int, n1: int, n2: int, d: int, iters: int) -> int:
    """FLOP one one-shot distributed fit needs, ``eigh`` left out (its count depends on the
    method): K1 on both classes, K2 on the direction (k = 1) and the CLIME block (k = d), and
    the debias products Sigma beta_hat and Theta^T resid on every machine."""
    return (gram_flops(m, n1, d) + gram_flops(m, n2, d)
            + fixed_kernel_work(m, d, 1, iters)[0] + fixed_kernel_work(m, d, d, iters)[0]
            + m * 4 * d * d)
