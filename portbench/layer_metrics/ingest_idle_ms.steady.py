"""Milliseconds an ingest's card sits idle inside ``repro_torch.ingest`` (screening, the merge
and the read of the verdict): the window's idle time under that span, over those spans."""

from portbench import spans

INGEST = "repro_torch.ingest"


def read(tr):
    return spans.idle_ms_per(tr, INGEST, spans.count(tr, INGEST))
