"""Device kernels a fit launches: every kernel in the traced window (the port's, PyTorch's and
cuSOLVER's), over the fits."""

from portbench import trace


def read(tr):
    fits = tr.counts.get("fits")
    return len(trace.kernels(tr)) / fits if fits else None
