"""The traced run: one window under ``torch.profiler`` (host and CUDA activity), reduced to plain data.

:func:`capture` runs the window inside a ``record_function`` span and
returns a :class:`Trace`: the device's kernels, copies and sets with
their times, the host's operations and the benchmark's spans, and each
device event's launching host operation.  The per-layer readers in
``layer_metrics/`` and the breakdown read nothing else.  A window in
which no operation ran on the device is an error: no metric falls back
to host time under a device name.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import re
from typing import NamedTuple

WINDOW = "portbench.window"


class DeviceEvent(NamedTuple):
    name: str
    start: int  # ns
    end: int
    kind: str  # "kernel" | "memcpy" | "memset"
    host: int  # start (ns) of the host operation that launched it, -1 when unknown
    thread: int


class HostOp(NamedTuple):
    name: str
    start: int
    end: int
    thread: int
    span: bool  # a benchmark span (record_function), not a library operation


class Trace(NamedTuple):
    window: tuple  # (start, end) ns of the traced window
    device: list
    host: list
    counts: dict  # work done in the window: fits, ticks, refreshes, queries
    launch_shapes: dict  # the port's launches in the window by (kernel, m, d, k)
    config: dict
    # each call's seconds on the host's clock in the same run's untraced window, by call name
    host_timed: dict = {}

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9


def _is_span(e) -> bool:
    return bool(e.is_user_annotation())


def from_events(events, counts: dict, launch_shapes: dict, config: dict) -> Trace:
    """A :class:`Trace` from kineto events (``prof.profiler.kineto_results.events()``).

    A device (CUDA) event is a kernel, a copy or a set, by its name, unless it mirrors a
    benchmark span on the device's timeline.  A host event is a benchmark span, a library
    operation, or a runtime call (``cudaLaunchKernel``...).  A device event's launching
    operation is the host operation whose correlation id it links to.
    """
    device, host, by_corr = [], [], {}
    window = None
    pending = []
    for e in events:
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        if str(e.device_type()).split(".")[-1] == "CUDA":
            if not _is_span(e):
                pending.append((e.name(), start, end, e.linked_correlation_id()))
            continue
        op = HostOp(e.name(), start, end, e.start_thread_id(), _is_span(e))
        host.append(op)
        if e.linked_correlation_id() == 0:
            by_corr[e.correlation_id()] = op
        if op.span and op.name == WINDOW:
            window = (start, end)
    if window is None:
        raise RuntimeError("the trace holds no window span")
    spans = {op.name for op in host if op.span}
    for name, start, end, linked in pending:
        if name in spans:
            continue
        kind = ("memcpy" if name.startswith("Memcpy") else
                "memset" if name.startswith("Memset") else "kernel")
        op = by_corr.get(linked) if linked else None
        device.append(DeviceEvent(name, start, end, kind, op.start if op else -1,
                                  op.thread if op else -1))
    device.sort(key=lambda ev: ev.start)
    host.sort(key=lambda op: op.start)
    return Trace(window, device, host, counts, launch_shapes, config)


def capture(fn, counts_of, launch_shapes, config):
    """``(fn(), Trace)``: ``fn`` runs once under the profiler, inside the window span, and the
    device is synchronised before the span closes.  ``counts_of(result)`` gives the work done,
    ``launch_shapes()`` the port's launch counter now."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    before = dict(launch_shapes())
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            result = fn()
            torch.cuda.synchronize()
    after = launch_shapes()
    delta = {k: n - before.get(k, 0) for k, n in after.items() if n - before.get(k, 0)}
    trace = from_events(prof.profiler.kineto_results.events(), counts_of(result), delta, config)
    if busy_ns(trace) <= 0:
        raise RuntimeError("the profiler saw no device activity in the traced window")
    return result, trace


def spans(on: bool):
    """``name -> context``: a benchmark span in the traced run, nothing otherwise."""
    if not on:
        return lambda name: contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function


def warm_profiler() -> None:
    """One tiny profiled op, so the profiler's own start-up falls in set-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# reductions the readers share
# ---------------------------------------------------------------------------


def busy_intervals(trace: Trace) -> list:
    """The union of device activity inside the window, as sorted disjoint (start, end) ns."""
    lo, hi = trace.window
    merged = []
    for ev in trace.device:
        s, e = max(ev.start, lo), min(ev.end, hi)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [tuple(iv) for iv in merged]


def busy_ns(trace: Trace) -> int:
    return sum(e - s for s, e in busy_intervals(trace))


def idle_share(trace: Trace) -> float:
    """Percent of the window in which nothing ran on the device."""
    lo, hi = trace.window
    return 100.0 * (hi - lo - busy_ns(trace)) / (hi - lo)


_ADMM = re.compile(r"fused_admm_kernel<([^>]*)>")


def admm_kind(name: str) -> str | None:
    """"K2" or "K3" for the port's fused ADMM kernels (the template's last argument is kState)."""
    m = _ADMM.search(name)
    if m is None:
        return None
    return "K3" if m.group(1).split(",")[-1].strip() in ("true", "1") else "K2"


def kernels(trace: Trace, pred=lambda name: True) -> list:
    return [ev for ev in trace.device if ev.kind == "kernel" and pred(ev.name)]


def device_ns_under(trace: Trace, op_name: str) -> int:
    """Device time of the events launched from inside a host operation named ``op_name``."""
    spans = collections.defaultdict(list)
    for op in trace.host:
        if op.name == op_name:
            spans[op.thread].append((op.start, op.end))
    total = 0
    for ev in trace.device:
        if ev.host >= 0 and any(s <= ev.host <= e for s, e in spans.get(ev.thread, ())):
            total += ev.end - ev.start
    return total


def short_name(name: str) -> str:
    """A kernel's name without its return type and argument list."""
    name = re.sub(r"^void ", "", name)
    depth, out = 0, []
    for ch in name:
        if ch == "(" and depth == 0 and out:
            break
        depth += ch == "<"
        depth -= ch == ">"
        out.append(ch)
    return "".join(out)[:160]


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle gaps by what the host
    was doing then: the innermost benchmark span and the innermost host operation at the gap's
    middle."""
    by_op = collections.Counter()
    for ev in trace.device:
        by_op[short_name(ev.name) if ev.kind == "kernel" else ev.name] += ev.end - ev.start
    gaps = collections.Counter()
    lo, hi = trace.window
    edges = [lo]
    for s, e in busy_intervals(trace):
        edges += [s, e]
    edges.append(hi)
    starts = [h.start for h in trace.host]
    for s, e in zip(edges[::2], edges[1::2]):
        if e > s:
            gaps[_host_at(trace.host, starts, (s + e) // 2)] += e - s
    return {"device_ops": [[k, v / 1e9] for k, v in by_op.most_common(top)],
            "idle_gaps": [[k, v / 1e9] for k, v in gaps.most_common(top)]}


def _host_at(host: list, starts: list, t: int) -> str:
    """The innermost span and host operation open at ``t`` (``host`` sorted by start)."""
    i = bisect.bisect_right(starts, t)
    span = op = None
    for j in range(i - 1, max(-1, i - 5001), -1):
        h = host[j]
        if h.end < t:
            continue
        if h.span and h.name != WINDOW:
            span = span or h.name
        elif not h.span:
            op = op or h.name
        if span and op:
            break
    return "/".join(x for x in (span, op) if x) or "host"
