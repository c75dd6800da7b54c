"""Device milliseconds a fit spends in ``torch.linalg.eigh`` (cuSOLVER) on the 80 sites'
rank-deficient 200 x 200 covariances, read as ``eigh_ms.fit`` reads it."""

from pathlib import Path

from portbench import spec

read = spec.reader("eigh_ms.fit", Path(__file__).resolve().parents[2])
