"""The port's spans (``repro_torch.obs``): none without a profiler, and under one the fit's and
the serving runtime's steps, each inside the span that encloses it, with one ``host_read`` span a
blocking read of a device value."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import test_torch_parity  # noqa: F401  (pins torch to one thread)
from repro_torch import obs
from repro_torch.core import distributed, pipeline, rounds
from repro_torch.core import streaming as st
from repro_torch.core.compression import Compression
from repro_torch.core.dantzig import DantzigConfig
from repro_torch.core.faults import Aggregation, FaultPlan
from repro_torch.core.transport import CommPlan
from repro_torch.stats import synthetic

D = 16
LAM, LAM_P, THRESH = 0.1, 0.2, 1e-3
FIT_SPANS = ["repro_torch.suff_stats", "repro_torch.spectral_factor",
             "repro_torch.solve.direction", "repro_torch.solve.clime", "repro_torch.rounds"]


def _problem():
    return synthetic.make_problem(D, 4, 0.5, device="cpu"), torch.Generator().manual_seed(0)


def _fit():
    prob, gen = _problem()
    xs, ys = synthetic.sample_machines(gen, prob, 3, 40, 40, device="cpu")
    return distributed.simulated_distributed_slda(xs, ys, LAM, LAM, 0.05,
                                                  DantzigConfig(max_iters=60))


def _runtime(max_iters: int = 600):
    """A seed-fitted CPU runtime (K3's tol gate, so a rung's verdict reads the device five
    times), a batch to ingest and a query batch."""
    prob, gen = _problem()
    x0, y0 = synthetic.sample_two_class(gen, prob, 100, 100, device="cpu")
    cfg = DantzigConfig(max_iters=max_iters, tol=1e-2, fused=True)
    rt = st.ServingRuntime(pipeline.suff_stats(x0, y0), LAM, LAM_P, THRESH, cfg=cfg,
                           device="cpu")
    xb, yb = synthetic.sample_two_class(gen, prob, 30, 30, device="cpu")
    return rt, (pipeline.suff_stats(xb, yb), xb, yb), torch.randn(64, D, generator=gen)


def _spans(prof) -> list:
    """``(name, enclosing span's name)`` of each of the port's spans, in the order they open."""
    out = []
    for e in sorted(prof.events(), key=lambda e: e.time_range.start):
        if not e.name.startswith("repro_torch."):
            continue
        parent = e.cpu_parent
        while parent is not None and not parent.name.startswith("repro_torch."):
            parent = parent.cpu_parent
        out.append((e.name, parent.name if parent is not None else None))
    return out


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return _spans(prof)


def test_with_no_profiler_a_span_is_one_shared_null_context(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) built with no profiler")

    monkeypatch.setattr(obs, "record_function", refuse)
    assert obs.span("repro_torch.a") is obs.span("repro_torch.b")
    with obs.span("repro_torch.a") as entered:
        assert entered is None
    _fit()
    rt, batch, z = _runtime()
    rt.classify(z)
    assert rt.ingest_batch(*batch)
    assert rt.refresh()


def test_a_fit_marks_its_steps():
    spans = _profiled(_fit)
    assert [name for name, _ in spans] == FIT_SPANS
    assert all(parent is None for _, parent in spans)


def _refined(comm, faulted: bool, t: int):
    prob, gen = _problem()
    m = 4
    xs, ys = synthetic.sample_machines(gen, prob, m, 40, 40, device="cpu")
    plan = None
    if faulted:
        live = torch.ones(m, t)
        live[1, 0] = 0.0  # machine 1 misses round 1
        zeros = torch.zeros(m, t, dtype=torch.int32)
        plan = FaultPlan(live, zeros, zeros)
    return rounds.simulate_multi_round(pipeline.BinaryHead(), (xs, ys), lam=LAM, lam_prime=LAM,
                                       rounds=t, cfg=DantzigConfig(max_iters=60), comm=comm,
                                       faults=plan, return_all_rounds=True)


@pytest.mark.parametrize("comm,faulted,t", [
    (None, False, 3),
    (CommPlan(aggregation=Aggregation()), True, 3),
    (CommPlan(uplink=Compression(4, "int8"), aggregation=Aggregation()), True, 2),
    (CommPlan(aggregation=Aggregation()), False, 1),
], ids=["dense", "masked", "compressed", "masked_one_round"])
def test_each_refinement_round_marks_its_one_aggregate(comm, faulted, t):
    spans = _profiled(lambda: _refined(comm, faulted, t))
    names = [name for name, _ in spans]
    assert names.count("repro_torch.rounds") == 1
    assert [(n, p) for n, p in spans if n.startswith("repro_torch.rounds.")] == [
        ("repro_torch.rounds.round", "repro_torch.rounds"),
        ("repro_torch.rounds.aggregate", "repro_torch.rounds.round")] * t
    # the one-shot fit (one round, the default plan) opens neither
    assert not any(n.startswith("repro_torch.rounds.") for n, _ in _profiled(_fit))


def test_the_serving_runtime_nests_its_steps():
    rt, batch, z = _runtime()
    spans = _profiled(lambda: (rt.classify(z), rt.ingest_batch(*batch), rt.refresh()))
    parents = {}
    for name, parent in spans:
        parents.setdefault(name, set()).add(parent)
    assert parents["repro_torch.classify"] == {None}
    assert parents["repro_torch.ingest"] == {None}
    assert parents["repro_torch.ingest.screen"] == parents["repro_torch.ingest.merge"] == {
        "repro_torch.ingest"}
    assert parents["repro_torch.refresh"] == {None}
    assert parents["repro_torch.rung.warm"] == {"repro_torch.refresh"}
    for step in ("spectral_factor", "solve.direction", "solve.clime", "debias", "verdict"):
        assert parents[f"repro_torch.{step}"] == {"repro_torch.rung.warm"}
    assert parents["repro_torch.publish"] == {"repro_torch.refresh"}
    assert parents["repro_torch.host_read"] == {"repro_torch.verdict", "repro_torch.ingest",
                                                "repro_torch.publish"}


@pytest.mark.parametrize("max_iters,climbs", [(600, False), (120, True), (80, True)])
def test_a_refresh_reads_the_device_five_times_a_rung_and_once_to_publish(max_iters, climbs):
    rt, batch, _ = _runtime(max_iters)
    rt.ingest_batch(*batch)
    before, published = len(rt.ladder_log), []
    spans = _profiled(lambda: published.append(rt.refresh()))
    rungs = rt.ladder_log[before:]
    assert (len(rungs) > 1) == climbs
    assert [name for name, _ in spans if name.startswith("repro_torch.rung.")] == [
        f"repro_torch.rung.{r['attempt']}" for r in rungs]
    reads = sum(name == "repro_torch.host_read" for name, _ in spans)
    assert reads == 5 * len(rungs) + published[0]
