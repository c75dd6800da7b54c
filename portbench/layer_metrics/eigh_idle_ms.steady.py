"""Milliseconds a refresh's card sits idle inside ``repro_torch.spectral_factor`` (each rung's
``eigh``): the window's idle time under that span, over the refreshes."""

from portbench import spans


def read(tr):
    return spans.idle_ms_per(tr, "repro_torch.spectral_factor", tr.counts.get("refreshes"))
