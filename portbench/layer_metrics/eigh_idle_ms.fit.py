"""Milliseconds a fit's card sits idle inside ``repro_torch.spectral_factor`` (the finiteness
guard and cuSOLVER's batched ``eigh``, with its read-back of the error info): the window's idle
time under that span, over the fits."""

from portbench import spans


def read(tr):
    return spans.idle_ms_per(tr, "repro_torch.spectral_factor", tr.counts.get("fits"))
