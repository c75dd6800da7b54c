"""Device milliseconds a refresh spends in ``torch.linalg.eigh``: the device time of everything
launched under ``aten::linalg_eigh`` in the traced window, over the refreshes."""

from portbench import trace


def read(tr):
    refreshes = tr.counts.get("refreshes")
    took = trace.device_ns_under(tr, "aten::linalg_eigh")
    return took / 1e6 / refreshes if refreshes and took else None
