"""Percent of the traced window of serving ticks in which no kernel, copy or set ran on the
device."""

from portbench import trace


def read(tr):
    return trace.idle_share(tr) if tr.counts.get("ticks") else None
