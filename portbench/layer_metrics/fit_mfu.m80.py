"""The whole refined fit's share of the card's float32 peak, in percent.

A fit's operations are the one-shot fit's (``work.fit_flops``: K1, K2
on the direction and the CLIME block, the first round's debias;
``eigh`` left out) and, for each later round, the two (d, d) x (d, 1)
products of every machine's correction, 4 d^2 FLOP a machine; times the
fits in the traced window, over the window's length times 67 TFLOP/s.
"""

from portbench import work


def read(tr):
    fits = tr.counts.get("fits")
    if not fits:
        return None
    c = tr.config
    m, d = c["m"], c["d"]
    flops = work.fit_flops(m, c["n1"], c["n2"], d, c["max_iters"]) + (
        (c["rounds"] - 1) * m * 4 * d * d)
    return 100.0 * flops * fits / (tr.window_s * work.PEAK_FP32_FLOPS)
