"""The yardstick's arithmetic: the frozen work counts against the smoke's numbers, and the trace
reduction (busy union, idle share, eigh attribution, K2/K3 names, breakdown) on a synthetic trace."""

import pytest
import torch

from portbench import spec, trace, work

torch.set_num_threads(1)


def test_k2_bounds_at_run_a_shapes_match_the_smoke():
    # run (a): m = 20, d = 200, 500 iterations; PERF.md's K2 row: CLIME 9.672 ms, k = 1 0.0484 ms
    assert work.bound_ms(*work.fixed_kernel_work(20, 200, 200, 500)) == pytest.approx(9.672,
                                                                                       abs=5e-4)
    assert work.bound_ms(*work.fixed_kernel_work(20, 200, 1, 500)) == pytest.approx(0.0484,
                                                                                     abs=5e-5)
    flops, nbytes = work.fixed_kernel_work(20, 200, 200, 500)
    assert flops / work.PEAK_FP32_FLOPS > nbytes / work.PEAK_HBM_BYTES  # bound by operations


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


K2 = "void cluster_fused_admm_kernel<0, false>(float const*, float const*, int)"
K3 = "void fused_admm_kernel<1, 8, true>(float const*, int)"
CONFIG = {"max_iters": 500, "m": 20, "n1": 250, "n2": 250, "d": 200}


def synthetic(counts=None, shapes=None):
    """A 1 ms window: eigh launches 100 us of kernels, K2 runs 400 us and overlaps a copy."""
    events = [
        Event(trace.WINDOW, "user_annotation", 0, 1_000_000, corr=1),
        Event("fit", "user_annotation", 10_000, 980_000, corr=2),
        Event("aten::linalg_eigh", "cpu_op", 20_000, 200_000, corr=3),
        Event("aten::mul", "cpu_op", 30_000, 5_000, corr=4),
        Event("syevj_kernel", "kernel", 100_000, 60_000, linked=3),
        Event("mul_kernel", "kernel", 160_000, 40_000, linked=4),
        Event(K2, "kernel", 300_000, 400_000),
        Event("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 650_000, 100_000),
        Event(K3, "kernel", 800_000, 50_000),
        Event("fit", "gpu_user_annotation", 0, 1_000_000),
        Event("cudaLaunchKernel", "cuda_runtime", 25_000, 3_000, corr=9, linked=3),
    ]
    return trace.from_events(events, counts or {"fits": 2}, shapes or {}, CONFIG)


def test_busy_union_and_idle_share():
    tr = synthetic()
    assert trace.busy_intervals(tr) == [(100_000, 200_000), (300_000, 750_000),
                                        (800_000, 850_000)]
    assert trace.busy_ns(tr) == 600_000
    assert trace.idle_share(tr) == pytest.approx(40.0)
    assert tr.window_s == pytest.approx(1e-3)


def test_device_time_under_an_op_and_kernel_kinds():
    tr = synthetic()
    assert trace.device_ns_under(tr, "aten::linalg_eigh") == 100_000  # its kernel and its child's
    assert [trace.admm_kind(ev.name) for ev in trace.kernels(tr)] == [None, None, "K2", "K3"]
    assert len(trace.kernels(tr)) == 4


def test_readers_on_the_synthetic_trace():
    shapes = {("dantzig_fused", 20, 200, 200): 1, ("gram", 20, 250, 200): 2}
    tr = synthetic({"fits": 2, "ticks": 4, "refreshes": 2}, shapes)

    def read(name):
        return spec.reader(name)(tr)

    bound = work.bound_ms(*work.fixed_kernel_work(20, 200, 200, 500))
    assert read("k2_roofline_share.fit") == pytest.approx(100 * bound / 0.4)
    assert read("eigh_ms.fit") == pytest.approx(0.05)
    assert read("launches_per_fit.fit") == 2.0
    assert read("idle_share.fit") == pytest.approx(40.0)
    assert read("k3_device_ms.steady") == pytest.approx(0.025)
    assert read("eigh_ms.steady") == pytest.approx(0.05)
    assert read("launches_per_tick.steady") == read("launches_per_tick.qps") == 1.0
    assert read("idle_share.steady") == read("idle_share.qps") == pytest.approx(40.0)
    flops = work.fit_flops(20, 250, 250, 200, 500)
    assert read("fit_mfu.fit") == pytest.approx(100 * flops * 2 / (1e-3 * work.PEAK_FP32_FLOPS))


def test_breakdown_names_the_device_ops_and_the_idle_gaps():
    out = trace.breakdown(synthetic())
    assert out["device_ops"][0] == ["cluster_fused_admm_kernel<0, false>", 4e-4]
    gaps = dict(out["idle_gaps"])
    assert gaps["fit"] == pytest.approx(3e-4)
    assert gaps["fit/aten::linalg_eigh"] == pytest.approx(1e-4)
    assert sum(gaps.values()) == pytest.approx(4e-4)


def test_latency_readers_take_the_percentile_of_their_spans():
    # the untraced window's calls on the host's clock; the traced run's spans do not count
    spans = [Event(trace.WINDOW, "user_annotation", 0, 10**9, corr=1)]
    spans += [Event("classify", "user_annotation", 10_000 * i, 9 * 10**6, corr=2 + i)
              for i in range(100)]
    spans.append(Event("k", "kernel", 0, 10))
    tr = trace.from_events(spans, {"ticks": 100, "refreshes": 3}, {}, CONFIG)
    assert spec.reader("query_p95_ms.steady")(tr) is None
    tr = tr._replace(host_timed={"classify": [1e-6 * (i + 1) for i in range(100)],
                                 "refresh": [5e-3, 5e-3, 5e-3]})
    assert spec.reader("query_p95_ms.steady")(tr) == pytest.approx(0.09505)
    assert spec.reader("query_p95_ms.qps")(tr) == pytest.approx(0.09505)
    assert spec.reader("refresh_p95_ms.steady")(tr) == pytest.approx(5.0)
    assert spec.reader("refresh_p95_ms.steady")(tr._replace(host_timed={"classify": [1.0]})) is None
