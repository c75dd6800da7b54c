"""K2 and K3 launches on the streamed template in a traced window, each paired with the port's span.

The port launches its ADMM kernels (K2, K3) from its own C library,
whose runtime calls the profiler does not record: such a kernel links to
no host operation (``DeviceEvent.host`` is -1), so
``trace.device_ns_under`` cannot place it under a span.  The port opens
one ``repro_torch.admm.streamed`` span around each launch on the
streamed template (``repro_torch/kernels/dantzig_fused.py``) and launches
on one stream, so the n-th such span of the window launched its n-th
ADMM kernel.  A program without the span, or a window with a launch on
the cluster template, pairs nothing.
"""

from __future__ import annotations

from portbench import trace

STREAMED = "repro_torch.admm.streamed"


def launches(tr: trace.Trace) -> list | None:
    """``[(span, kernel)]``, a :class:`trace.HostOp` and the :class:`trace.DeviceEvent` it
    launched, for every ADMM kernel of the window in order; ``None`` when the window has no ADMM
    kernel, or its ADMM kernels and streamed spans differ in number.

    The pairing goes by order alone.  Host and device times come from two clocks that the
    profiler aligns only to within some microseconds over a long window, while a kernel can start
    within microseconds of its launch, so a comparison of the two would drop sound pairs."""
    lo, hi = tr.window
    opened = sorted((op for op in tr.host if op.span and op.name == STREAMED
                     and lo <= op.start < hi), key=lambda op: op.start)
    admm = trace.kernels(tr, lambda s: trace.admm_kind(s) is not None)
    if not admm or len(opened) != len(admm):
        return None
    return list(zip(opened, admm))


def device_ms_per_fit(tr: trace.Trace, name: str) -> float | None:
    """Device milliseconds a fit launched inside the spans named ``name``: the operations linked
    to a host operation inside one, and the ADMM kernels whose streamed span opened inside one
    (``None`` when :func:`launches` pairs nothing, or the window holds no fit)."""
    pairs, fits = launches(tr), tr.counts.get("fits")
    if pairs is None or not fits:
        return None
    outer = [(op.thread, op.start, op.end) for op in tr.host if op.name == name]
    admm = sum(ev.end - ev.start for op, ev in pairs
               if any(t == op.thread and s <= op.start <= e for t, s, e in outer))
    return (trace.device_ns_under(tr, name) + admm) / 1e6 / fits
