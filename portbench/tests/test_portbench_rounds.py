"""The refined-fit cell on the CPU at test sizes: the port's masked rounds against the plain
reference (``portbench/reference/rounds.py``) round by round, the reference reducing to the one-shot
fit, the seeded masks, each planted fault coming out not correct, and its per-layer readers on a
hand-built trace."""

import pytest
import torch

from portbench import run, spec, testing, trace, work
from portbench.reference import fit as ref_fit
from portbench.reference import rounds as ref_rounds
from portbench.reference.precision import mm
from portbench.traffic import rounds as driver
from repro_torch.core import faults, rounds
from test_portbench_spans import Event

torch.set_num_threads(1)

CELL = next(w["name"] for w in spec.benchmark()["workloads"] if spec.cell(w["name"]).driver
            == "rounds")
CPU = torch.device("cpu")
SEEDS = (2**31 + 11, 2**31 + 97, 3 * 2**30 + 5)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return testing.tiny_root(tmp_path_factory.mktemp("tiny"))


def _setup(root, seed=SEEDS[0]):
    return driver.setup(spec.cell(CELL, root), CPU, seed, log=lambda msg: None)


@pytest.mark.parametrize("seed", SEEDS)
def test_the_cpu_sizes_keep_fewer_rows_than_features_and_drop_machines(root, seed):
    st = _setup(root, seed)
    c = st.c
    assert c["n1"] + c["n2"] < c["d"] and c["N"] // c["m"] == c["n1"] + c["n2"] + 1
    assert st.live.shape == (st.p["pool"], c["m"], c["rounds"]) == (4, 16, 3)
    # every dataset of the pool misses some uplink, and one seed draws one mask
    assert bool((st.live == 0).any(-1).any(-1).all())
    assert torch.equal(st.live, _setup(root, seed).live)


@pytest.mark.parametrize("seed", SEEDS)
def test_the_port_agrees_with_the_reference_round_by_round(root, seed):
    st = _setup(root, seed)
    limits = spec.cell(CELL, root).limits
    want = driver._reference(st, list(range(st.p["pool"])), mm)
    for i in range(st.p["pool"]):
        traj, beta = st.system.fit(i)
        assert traj.shape == want[i].shape == (st.c["rounds"], st.c["d"])
        assert max(driver.compare.rel_gap(a, b) for a, b in zip(traj, want[i])) <= limits[
            "round_gap"]
        assert driver.compare.thresholded_gap(beta, want[i][-1], st.t, limits["beta_gap"]) <= (
            limits["beta_gap"])
        # the rounds move the aggregate: a planted round fault has something to change
        assert driver.compare.rel_gap(want[i][0], want[i][-1]) > 100 * limits["round_gap"]


def test_with_every_machine_live_one_round_is_the_one_shot_mean(root):
    st = _setup(root)
    xs, ys = st.xs[:2], st.ys[:2]
    live = torch.ones(2, st.c["m"], 1)
    got = ref_rounds.fit_rounds(xs, ys, live, lam=st.lam, lam_prime=st.lam,
                                iters=st.c["max_iters"], mm=mm)
    _, mean = ref_fit.fit(xs, ys, lam=st.lam, lam_prime=st.lam, t=st.t,
                          iters=st.c["max_iters"], mm=mm)
    assert got.shape == (2, 1, st.c["d"])
    torch.testing.assert_close(got[:, 0], mean, rtol=0, atol=1e-6 * float(mean.abs().max()))


def test_a_round_no_machine_reaches_keeps_the_last_good_aggregate(root):
    st = _setup(root)
    s = ref_fit.solves(st.xs[:1], st.ys[:1], st.lam, st.lam, st.c["max_iters"], mm)
    live = torch.ones(1, st.c["m"], 3)
    live[:, :, 0] = 0  # round 1: zeros, and round 2 anchors at zeros
    live[:, :, 2] = 0  # round 3: round 2's aggregate again
    got = ref_rounds.refine(s, live, mm)
    assert bool((got[:, 0] == 0).all()) and bool((got[:, 1] != 0).any())
    assert torch.equal(got[:, 2], got[:, 1])


def _counted_in_the_mean(self, t):
    """Every machine live: a dropped machine's correction reaches the mean."""
    live, stale, code = self.live[..., t - 1], self.stale[..., t - 1], self.corrupt[..., t - 1]
    return torch.ones_like(live), stale, code


def _last_round_skipped(real):
    def loop(drv, *, rounds, **kw):
        out, state = real(drv, rounds=rounds - 1, **kw)
        if kw.get("return_all_rounds"):
            out = torch.cat([out, out[-1:]])  # the skipped round's aggregate is the one before
        return out, state
    return loop


def _second_round_from_the_wrong_anchor(real):
    calls = []

    def broadcast(self, bar):
        calls.append(1)
        # the first broadcast of a fit (round 2's anchor): each machine keeps its own estimate
        return self.ws.beta_hat if len(calls) % 3 == 1 else real(self, bar)
    return broadcast


def _altered_answer(real):
    calls = []

    def fit(*args, **kw):
        out, ws = real(*args, **kw)
        calls.append(1)
        if len(calls) == 3:  # one answer of the window (the first call is the warm-up)
            out = out.clone()
            out[-1, 0] += 0.05 * out[-1].abs().max()
        return out, ws
    return fit


PLANTS = {
    "a dropped machine counted in the mean": lambda mp: mp.setattr(
        faults.FaultPlan, "row", _counted_in_the_mean),
    "one round skipped": lambda mp: mp.setattr(
        rounds, "_refinement_rounds", _last_round_skipped(rounds._refinement_rounds)),
    "a round taken from the wrong anchor": lambda mp: mp.setattr(
        rounds._SimRound, "broadcast", _second_round_from_the_wrong_anchor(
            rounds._SimRound.broadcast)),
    "an answer altered": lambda mp: mp.setattr(
        rounds, "simulate_multi_round", _altered_answer(rounds.simulate_multi_round)),
}


@pytest.mark.parametrize("fault", sorted(PLANTS))
def test_a_planted_round_fault_is_not_correct(root, fault, monkeypatch):
    assert spec.cell(CELL, root).config["rounds"] == 3  # the wrong-anchor plant counts on it
    PLANTS[fault](monkeypatch)
    result = run.run_cell(CELL, SEEDS[0], 0.3, False, CPU, root=root)
    assert not result["correct"], result["checks"]


ROUNDS_SPAN, ROUND, AGG = ("repro_torch.rounds", "repro_torch.rounds.round",
                           "repro_torch.rounds.aggregate")
CONFIG = {"m": 80, "d": 200, "n1": 62, "n2": 62, "max_iters": 600, "rounds": 3}


def _round_events(with_spans=True):
    """A 1 ms window of two fits.  Each fit's ``repro_torch.rounds`` span (100-400 us and
    600-900 us) holds three round spans of 60 us, each launching two kernels of 10 us, then one
    kernel launched after the last round inside the rounds span; a kernel before the first fit
    launches outside every span."""
    events = [Event(trace.WINDOW, "user_annotation", 0, 1_000_000, corr=1)]
    launches = [(20_000, 30_000)]  # (host launch, device start)
    for f, base in enumerate((100_000, 600_000)):
        if with_spans:
            events.append(Event(ROUNDS_SPAN, "user_annotation", base, 300_000, corr=10 + f))
        for r in range(3):
            start = base + 20_000 + 80_000 * r
            if with_spans:
                events += [Event(ROUND, "user_annotation", start, 60_000, corr=20 + 3 * f + r),
                           Event(AGG, "user_annotation", start + 30_000, 20_000,
                                 corr=40 + 3 * f + r)]
            launches += [(start + 5_000, start + 10_000), (start + 35_000, start + 40_000)]
        launches.append((base + 270_000, base + 280_000))
    for i, (host, dev) in enumerate(launches):
        corr = 100 + i
        events.append(Event("cudaLaunchKernel", "cuda_runtime", host, 2_000, corr=corr))
        events.append(Event(f"k{i}", "kernel", dev, 10_000, linked=corr))
    return events


def _trace(fits=2, **kw):
    return trace.from_events(_round_events(**kw), {"fits": fits}, {}, dict(CONFIG))


def test_the_rounds_readers_on_the_synthetic_trace():
    tr = _trace()
    # seven kernels of 10 us in each fit's rounds span
    assert spec.reader("rounds_ms.m80")(tr) == pytest.approx(0.07)
    # six kernels in each fit's three rounds; the kernel after the last round is in none
    assert spec.reader("launches_per_round.m80")(tr) == pytest.approx(2.0)
    # each rounds span: 300 us less seven busy 10 us
    assert spec.reader("rounds_idle_ms.m80")(tr) == pytest.approx(0.23)
    for name in ("rounds_ms.m80", "launches_per_round.m80", "rounds_idle_ms.m80"):
        assert spec.reader(name)(_trace(with_spans=False)) is None
    assert spec.reader("rounds_ms.m80")(_trace(fits=0)) is None


def test_the_refined_fit_mfu_adds_the_later_rounds_products():
    tr = _trace(fits=3)
    one_shot = work.fit_flops(80, 62, 62, 200, 600)
    later = 2 * 80 * 4 * 200 * 200
    assert spec.reader("fit_mfu.m80")(tr) == pytest.approx(
        100.0 * (one_shot + later) * 3 / (tr.window_s * work.PEAK_FP32_FLOPS))
    assert spec.reader("fit_mfu.m80")(tr) > spec.reader("fit_mfu.fit")(tr)
