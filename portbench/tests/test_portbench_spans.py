"""The readers of the port's own spans (``portbench/spans.py`` and its five per-layer metrics) on a
hand-built trace: nested spans, device gaps inside and outside them, spans across the window's
edges, and a program without the spans."""

import pytest
import torch

from portbench import spans, spec, trace

torch.set_num_threads(1)


class Event:
    """The part of a kineto event the reduction reads; ``kind`` as kineto's activity types."""

    def __init__(self, name, kind, start, dur, corr=0, linked=0, thread=1):
        self._v = (name, kind, start, dur, corr, linked, thread)

    def name(self):
        return self._v[0]

    def device_type(self):
        gpu = self._v[1] in ("kernel", "gpu_memcpy", "gpu_memset", "gpu_user_annotation")
        return torch.autograd.DeviceType.CUDA if gpu else torch.autograd.DeviceType.CPU

    def is_user_annotation(self):
        return self._v[1] in ("user_annotation", "gpu_user_annotation")

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def start_thread_id(self):
        return self._v[6]


SF, REFRESH, INGEST, READ = ("repro_torch.spectral_factor", "repro_torch.refresh",
                             "repro_torch.ingest", "repro_torch.host_read")
COUNTS = {"fits": 2, "ticks": 4, "refreshes": 2}


def program_spans():
    """A 1 ms window.  ``spectral_factor`` opens before the window (0-50 us in it) and again
    inside a ``refresh`` (150-250 us); a second ``refresh`` runs past the window's end (900 us
    on); two ``ingest`` spans; three ``host_read`` spans in the window and one that opens before
    it."""
    return [
        Event(trace.WINDOW, "user_annotation", 0, 1_000_000, corr=1),
        Event(SF, "user_annotation", -50_000, 100_000, corr=2),
        Event(REFRESH, "user_annotation", 100_000, 400_000, corr=3),
        Event("repro_torch.rung.warm", "user_annotation", 120_000, 350_000, corr=4),
        Event(SF, "user_annotation", 150_000, 100_000, corr=5),
        Event("repro_torch.verdict", "user_annotation", 300_000, 150_000, corr=6),
        Event(READ, "user_annotation", 310_000, 10_000, corr=7),
        Event(READ, "user_annotation", 330_000, 10_000, corr=8),
        Event(READ, "user_annotation", 460_000, 20_000, corr=9),
        Event(INGEST, "user_annotation", 600_000, 100_000, corr=10),
        Event(INGEST, "user_annotation", 720_000, 40_000, corr=11),
        Event(REFRESH, "user_annotation", 900_000, 300_000, corr=12),
        Event(READ, "user_annotation", -10_000, 15_000, corr=13),
        Event(REFRESH, "gpu_user_annotation", 100_000, 400_000),
    ]


def device_events():
    """Busy 20-40, 180-220, 400-450, 650-720 and 950-1,000 us (a kernel runs past the end)."""
    return [Event(f"k{i}", "kernel", s, e - s) for i, (s, e) in enumerate(
        [(20_000, 40_000), (180_000, 220_000), (400_000, 450_000), (650_000, 720_000),
         (950_000, 1_100_000)])]


def synthetic(with_spans=True, counts=COUNTS):
    # without the program's spans: the window and a span the benchmark opens around a call
    events = program_spans() if with_spans else [
        program_spans()[0], Event("refresh", "user_annotation", 100_000, 400_000, corr=30)]
    return trace.from_events(events + device_events(), dict(counts), {}, {})


def test_spans_clip_to_the_window_and_leave_the_device_busy_time_out():
    tr = synthetic()
    assert spans.intervals(tr, SF) == [(0, 50_000), (150_000, 250_000)]
    assert spans.intervals(tr, REFRESH) == [(100_000, 500_000), (900_000, 1_000_000)]
    # 150 us of spectral_factor less 20 + 40 us busy
    assert spans.idle_ns(tr, SF) == 90_000
    # 500 us of refresh less 40 + 50 + 50 us busy
    assert spans.idle_ns(tr, REFRESH) == 360_000
    # the busy interval 650-720 covers the first ingest's second half and only touches the next
    assert spans.idle_ns(tr, INGEST) == 90_000
    assert spans.count(tr, READ) == 3 and spans.count(tr, INGEST) == 2
    assert spans.idle_ns(tr, "repro_torch.publish") is None


def test_overlapping_spans_of_one_name_count_their_time_once():
    events = program_spans() + [Event(SF, "user_annotation", 200_000, 100_000, corr=20)]
    tr = trace.from_events(events + device_events(), dict(COUNTS), {}, {})
    assert spans.intervals(tr, SF) == [(0, 50_000), (150_000, 300_000)]
    assert spans.idle_ns(tr, SF) == 140_000


@pytest.mark.parametrize("metric,value,per", [
    ("eigh_idle_ms.fit", 0.09 / 2, "fits"),
    ("eigh_idle_ms.steady", 0.09 / 2, "refreshes"),
    ("refresh_idle_ms.steady", 0.36 / 2, "refreshes"),
    ("ingest_idle_ms.steady", 0.09 / 2, None),  # over its own spans
    ("host_reads_per_tick.steady", 3 / 4, "ticks"),
])
def test_each_reader_on_the_synthetic_trace(metric, value, per):
    read = spec.reader(metric)
    assert read(synthetic()) == pytest.approx(value)
    # a program without the spans
    assert read(synthetic(with_spans=False)) is None
    if per:
        assert read(synthetic(counts={**COUNTS, per: 0})) is None
