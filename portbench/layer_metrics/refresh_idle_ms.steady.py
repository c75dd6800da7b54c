"""Milliseconds a refresh's card sits idle inside ``repro_torch.refresh`` (the escalation
ladder's rungs, their verdicts and the publish): the window's idle time under that span, over
the refreshes."""

from portbench import spans


def read(tr):
    return spans.idle_ms_per(tr, "repro_torch.refresh", tr.counts.get("refreshes"))
