"""K2's share of its roofline in the refined fits, in percent, read as ``k2_roofline_share.fit``
reads it: each K2 launch's least time at the configuration's iterations, over the K2 kernels'
device time."""

from pathlib import Path

from portbench import spec

read = spec.reader("k2_roofline_share.fit", Path(__file__).resolve().parents[2])
