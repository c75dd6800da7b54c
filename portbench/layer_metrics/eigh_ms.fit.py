"""Device milliseconds a fit spends in ``torch.linalg.eigh`` (cuSOLVER): the device time of
everything launched under ``aten::linalg_eigh`` in the traced window, over the fits."""

from portbench import trace


def read(tr):
    fits = tr.counts.get("fits")
    took = trace.device_ns_under(tr, "aten::linalg_eigh")
    return took / 1e6 / fits if fits and took else None
