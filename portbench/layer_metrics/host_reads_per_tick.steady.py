"""Blocking device-to-host reads the serving runtime makes a tick: the
``repro_torch.host_read`` spans in the window (the ladder's verdicts, the ingest's acceptance,
the publish's version), over the ticks."""

from portbench import spans


def read(tr):
    ticks = tr.counts.get("ticks")
    reads = spans.count(tr, "repro_torch.host_read")
    return reads / ticks if ticks and reads else None
