"""Named spans around the runtime's steps, on the profiler's clock.

The fit and the serving runtime mark their steps with :func:`span`:
``repro_torch.suff_stats``, ``.spectral_factor``, ``.solve.direction``,
``.solve.clime`` (or ``.solve.folded``, where the direction's columns
ride in the CLIME launch), ``.debias`` and ``.rounds`` in a fit, and
inside ``.rounds`` one ``repro_torch.rounds.round`` a refinement round,
each around one ``repro_torch.rounds.aggregate`` (the screen, the
masked, trimmed or dense mean and the last-good select), so that their
numbers count the rounds executed (the one-shot round, T = 1 with the
default plan, opens neither);
``repro_torch.classify``, ``.ingest`` (``.ingest.screen``,
``.ingest.merge``), ``.refresh``, ``.rung.warm`` / ``.cold`` /
``.refactor``, ``.verdict`` and ``.publish`` in serving; and
``repro_torch.host_read`` around each blocking read of a device value
by the serving runtime, so that their number counts the reads; and
``repro_torch.admm.streamed`` around each K2 or K3 launch on the
streamed template (``kernels/dantzig_fused.py``, with the A^T and Q^T
it builds), so that their number counts those launches; a launch on the
cluster template has none.  A span's parent is the span that encloses it.

To see them, run the calls under the profiler and export its trace::

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        runtime.classify(z)
        runtime.refresh()
    prof.export_chrome_trace("serving.json")  # chrome://tracing or Perfetto

The spans are the profiler's own host events, on the timeline of its
device events.  With no profiler recording, a span costs one read of
the profiler's flag and enters a shared null context.
"""

from __future__ import annotations

import contextlib

from torch.autograd import profiler as _profiler
from torch.profiler import record_function

_OFF = contextlib.nullcontext()


def span(name: str, on: bool = True):
    """A context that marks ``name`` in the profiler's trace while one records and ``on`` holds;
    else a no-op."""
    if on and _profiler._is_profiler_enabled:
        return record_function(name)
    return _OFF
