"""The whole fit's share of the card's float32 peak, in percent.

The operations a fit needs (``work.fit_flops``: K1, K2 on the direction
and the CLIME block, the debias; ``eigh`` left out) times the fits in the
traced window, over the window's length times 67 TFLOP/s.
"""

from portbench import work


def read(tr):
    fits = tr.counts.get("fits")
    if not fits:
        return None
    c = tr.config
    flops = work.fit_flops(c["m"], c["n1"], c["n2"], c["d"], c["max_iters"])
    return 100.0 * flops * fits / (tr.window_s * work.PEAK_FP32_FLOPS)
