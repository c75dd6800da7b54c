"""The port's own spans in a traced window: where the card waits inside a step of the program.

The port marks its steps with named spans (``repro_torch.spectral_factor``,
``repro_torch.refresh``, ``repro_torch.host_read``...: ``repro_torch/obs.py``);
the profiler records them as host events on the device trace's clock, and
:func:`portbench.trace.from_events` keeps them as spans.  A program without
them reads as having none: every reduction here then gives ``None``.
"""

from __future__ import annotations

from portbench import trace


def intervals(tr: trace.Trace, name: str) -> list:
    """The spans named ``name``, clipped to the window and merged, as sorted disjoint
    (start, end) ns."""
    lo, hi = tr.window
    merged = []
    for s, e in sorted((max(op.start, lo), min(op.end, hi)) for op in tr.host
                       if op.span and op.name == name):
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [tuple(iv) for iv in merged]


def idle_ns(tr: trace.Trace, name: str) -> int | None:
    """Nanoseconds inside the spans named ``name`` in which nothing ran on the device, or
    ``None`` when the window holds no such span."""
    spans = intervals(tr, name)
    if not spans:
        return None
    busy = trace.busy_intervals(tr)
    overlap, j = 0, 0
    for s, e in spans:
        while j < len(busy) and busy[j][1] <= s:
            j += 1
        k = j
        while k < len(busy) and busy[k][0] < e:
            overlap += min(e, busy[k][1]) - max(s, busy[k][0])
            k += 1
    return sum(e - s for s, e in spans) - overlap


def count(tr: trace.Trace, name: str) -> int:
    """The spans named ``name`` that open inside the window."""
    lo, hi = tr.window
    return sum(1 for op in tr.host if op.span and op.name == name and lo <= op.start < hi)


def idle_ms_per(tr: trace.Trace, name: str, units: int | None) -> float | None:
    """Card-idle milliseconds inside the spans named ``name``, over ``units`` (``None`` when
    ``units`` is 0 or there is no such span)."""
    idle = idle_ns(tr, name)
    return idle / 1e6 / units if units and idle is not None else None
