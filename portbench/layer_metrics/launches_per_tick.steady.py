"""Device kernels a serving tick launches: every kernel in the traced window (classify, ingest
and the refreshes' share), over the ticks."""

from portbench import trace


def read(tr):
    ticks = tr.counts.get("ticks")
    return len(trace.kernels(tr)) / ticks if ticks else None
