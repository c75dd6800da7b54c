"""The whole fit's share of the card's float32 peak, in percent, read as ``fit_mfu.fit`` reads it:
``work.fit_flops`` (K1, K2 on the direction and the CLIME block, the debias; ``eigh`` left out)
times the fits in the traced window, over the window's length times 67 TFLOP/s."""

from pathlib import Path

from portbench import spec

read = spec.reader("fit_mfu.fit", Path(__file__).resolve().parents[2])
