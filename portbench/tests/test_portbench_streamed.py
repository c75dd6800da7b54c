"""The readers of the d = 1,000 fit (``layer_metrics/*.d1000.py``, ``portbench/streamed.py``) on a
hand-built trace shaped as the card's: K2 kernels that link to no host operation, each launched
inside the port's ``repro_torch.admm.streamed`` span, the direction solve's span, a K2 kernel with
no span, and a program without the spans."""

import pytest
import torch

from portbench import spec, streamed, trace, work
from test_portbench_spans import Event

torch.set_num_threads(1)

STREAMED, DIRECTION = "repro_torch.admm.streamed", "repro_torch.solve.direction"
K2 = "void (anonymous namespace)::fused_admm_kernel<8, 1, false>(float const*, int)"
COPY = "void at::native::elementwise_kernel<128, 2>(int)"
CONFIG = {"m": 20, "d": 1000, "n1": 250, "n2": 250, "max_iters": 500}
SHAPES = {("dantzig_fused", 20, 1000, 1): 1, ("dantzig_fused", 20, 1000, 1000): 1,
          ("gram", 20, 250, 1000): 2}


def _fit_events(with_spans=True, k2_outside=False):
    """One 10 ms fit: the direction solve (0.5-2 ms) holds a streamed span (0.6-1.9 ms) that
    launches two transposes (10 us each) and K2 (400 us); a second streamed span (3-9 ms) launches
    two transposes and the CLIME block's K2 (6 ms); a copy outside every span.  PyTorch's kernels
    link to the runtime calls (``cudaLaunchKernel``) that launched them; K2, launched from the
    port's C library, links to none.  ``k2_outside`` adds a third K2 with no span."""
    spans = [Event(trace.WINDOW, "user_annotation", 0, 10_000_000, corr=1),
             Event(DIRECTION, "user_annotation", 500_000, 1_500_000, corr=2),
             Event(STREAMED, "user_annotation", 600_000, 1_300_000, corr=3),
             Event(STREAMED, "user_annotation", 3_000_000, 6_000_000, corr=4)]
    if not with_spans:
        spans = spans[:1]
    launches = [  # (host start, kernel, device start, device duration)
        (700_000, COPY, 800_000, 10_000), (710_000, COPY, 810_000, 10_000),
        (720_000, K2, 820_000, 400_000),
        (3_100_000, COPY, 3_200_000, 10_000), (3_110_000, COPY, 3_210_000, 10_000),
        (3_120_000, K2, 3_220_000, 6_000_000),
        (9_600_000, COPY, 9_700_000, 50_000)]
    if k2_outside:
        launches.append((9_650_000, K2, 9_800_000, 100_000))
    events = list(spans)
    for i, (host, name, start, dur) in enumerate(launches):
        if name == K2:
            events.append(Event(name, "kernel", start, dur))
            continue
        corr = 100 + i
        events.append(Event("cudaLaunchKernel", "cuda_runtime", host, 5_000, corr=corr))
        events.append(Event(name, "kernel", start, dur, linked=corr))
    return events


def _trace(fits=1, **kw):
    return trace.from_events(_fit_events(**kw), {"fits": fits}, dict(SHAPES), dict(CONFIG))


def test_each_k2_kernel_pairs_with_the_span_that_launched_it():
    tr = _trace()
    assert [ev.host for ev in trace.kernels(tr, lambda s: s == K2)] == [-1, -1]
    assert [(op.start, ev.start) for op, ev in streamed.launches(tr)] == [
        (600_000, 820_000), (3_000_000, 3_220_000)]
    assert streamed.launches(_trace(k2_outside=True)) is None
    assert streamed.launches(_trace(with_spans=False)) is None
    # the host's and the device's clocks may disagree by more than a launch takes: a span that
    # reads as opening after its kernel started still pairs with it
    late = [Event(e.name(), "user_annotation", 900_000, 1_000_000, corr=3)
            if e.name() == STREAMED and e.start_ns() == 600_000 else e for e in _fit_events()]
    pairs = streamed.launches(trace.from_events(late, {"fits": 1}, {}, dict(CONFIG)))
    assert [(op.start, ev.start) for op, ev in pairs] == [(900_000, 820_000),
                                                          (3_000_000, 3_220_000)]


def test_the_streamed_template_share_of_its_roofline():
    bound = sum(work.bound_ms(*work.fixed_kernel_work(20, 1000, k, 500)) for k in (1, 1000))
    read = spec.reader("k2_stream_roofline_share.d1000")
    assert read(_trace()) == pytest.approx(100.0 * bound / 6.4)
    # a K2 kernel launched outside the span, or a program without the span, reads nothing
    assert read(_trace(k2_outside=True)) is None
    assert read(_trace(with_spans=False)) is None


def test_the_device_time_under_the_streamed_span_and_the_direction_solve():
    stream, direction = spec.reader("k2_stream_ms.d1000"), spec.reader("direction_ms.d1000")
    # K2's 0.4 + 6 ms and the four transposes' 0.04 ms, over two fits
    assert stream(_trace(fits=2)) == pytest.approx(6.44 / 2)
    assert direction(_trace(fits=2)) == pytest.approx(0.42 / 2)
    for read in (stream, direction):
        assert read(_trace(with_spans=False)) is None
        assert read(_trace(fits=0)) is None


def test_the_fit_mfu_reads_as_the_d200_cells_does():
    tr = _trace(fits=3)
    assert spec.reader("fit_mfu.d1000")(tr) == spec.reader("fit_mfu.fit")(tr) > 0
