"""Milliseconds a fit's card sits idle inside the port's ``repro_torch.rounds`` span (the
refinement rounds, their masked aggregates and the host's work between their launches): the
window's idle time under that span, over the fits."""

from portbench import spans


def read(tr):
    return spans.idle_ms_per(tr, "repro_torch.rounds", tr.counts.get("fits"))
