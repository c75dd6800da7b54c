"""Classify-as-a-service: fixed tick epochs through the port's ``ServingRuntime``.

A session is a seed fit on ``n_seed`` + ``n_seed`` samples, then an
epoch of ``epoch_ticks`` ticks.  Each tick classifies one batch of
``batch`` queries and copies the predictions to the host; every
``ingest_every`` ticks it ingests a batch of ``ingest`` + ``ingest``
samples (statistics, screening and merge); every ``refresh_every``
ticks it refreshes the model (a refit on the escalation ladder, then
the slot is published and synchronised).  An interval of 0 means never.
Set-up draws ``sessions`` sessions from the seed (each its own seed
sample and data batches) and fits each; the window runs their epochs in
turn, each from a copy of its session's seed-fitted runtime, so every
run does the same work in each epoch however fast the program is, and
a run's work is the mean of many draws' (the refits' iteration counts
follow the draw).  The queries cycle through a pool of ``query_pool``
batches (they change no state).  A seed sample that the runtime refuses
(its ladder cannot fit it) is kept, and the next one is drawn; the
check holds each refusal against the reference.  The check replays
``judged_sessions`` sessions, drawn from the seed, on the reference.

Traffic parameters (``workloads/<cell>.json``): ``sessions``,
``judged_sessions``, ``epoch_ticks``, ``batch``, ``ingest``,
``ingest_every``, ``refresh_every``, ``query_pool``, ``sampled_ticks``
(query batches of the judged sessions the check compares, drawn from
the seed) and ``trace_units`` (epochs in the traced window).
The loop is closed and saturates the runtime, so its end-to-end metric
is the queries completed a second.  Each call is also timed alone on
the host's clock (``Record.calls``): ``classify`` from the hand-off of
the batch until its predictions are on the host (the tick ends in that
blocking copy), ``refresh`` until the new slot is published and the
device synchronised.
"""

from __future__ import annotations

import copy
import gc
import math
import random
import statistics
import time
from typing import NamedTuple

import torch

from portbench import compare, sampler, trace
from portbench.reference import serving as ref_serving
from portbench.reference.precision import mm, mm_tf32
from repro_torch.core import pipeline, streaming
from repro_torch.core.dantzig import DantzigConfig
from repro_torch.core.faults import Aggregation


# seed samples drawn at most: a sample whose cold fit fails the ladder is drawn again
SEED_DRAWS = 8
# the CPU tests' epoch, where a cell's is longer than 24 ticks
CPU_TEST_EPOCH = dict(epoch_ticks=32, ingest_every=4, refresh_every=16)


class Setup(NamedTuple):
    c: dict
    p: dict
    device: torch.device
    seed: int
    x0: list  # a session's (n_seed, d) class 1 of its seed fit
    y0: list
    xb: torch.Tensor  # (sessions, batches, ingest, d) each epoch's arriving samples
    yb: torch.Tensor
    queries: torch.Tensor  # (query_pool, batch, d)
    system: list  # a session's system after its seed fit; each epoch runs on a copy
    seed_slot: list  # a session's seed-fit slot (beta, means, priors, version), on the host
    refused: list  # each session draw the system refused (:class:`Refused`), in order
    judged: list  # the sessions the check replays


class Refused(NamedTuple):
    x0: torch.Tensor  # the draw's seed sample
    y0: torch.Tensor
    xb: torch.Tensor  # its epoch's batches
    yb: torch.Tensor
    at_seed: bool  # the seed fit failed (else a refresh of the epoch published nothing)


class Record(NamedTuple):
    window_s: float
    ticks: int
    queries: int
    refreshes: list  # of the judged sessions: (session, epoch position, published, slot...)
    sampled: list  # of the judged sessions: (session, epoch position, query batch, pred, scores)
    calls: dict  # "classify", "refresh": each call's seconds on the host's clock
    ladder_iters: int  # ADMM iterations the refreshes' ladders ran (both solves' maxima summed)
    missed: int  # refreshes that published nothing


class Program:
    """The port's serving runtime behind the benchmark's three calls."""

    def __init__(self, x0, y0, c: dict, device):
        cfg = DantzigConfig(max_iters=c["max_iters"], rho=c["admm_rho"], alpha=c["alpha"],
                            tol=c["tol"], check_every=c["check_every"], fused=c["fused"])
        policy = streaming.EscalationPolicy(c["max_attempts"], 0.0, c["refactor_scale"])
        self.rt = streaming.ServingRuntime(
            pipeline.suff_stats(x0, y0), c["lam"], c["lam_prime"], c["threshold"], cfg=cfg,
            staleness_bound=c["staleness_bound"], escalation=policy,
            ingest=Aggregation(envelope=c["envelope"]), protect=True, ckpt_dir=None,
            device=device)

    def classify(self, z):
        return self.rt.classify(z)

    def ingest(self, x, y) -> bool:
        return self.rt.ingest_batch(pipeline.suff_stats(x, y), x, y)

    def refresh(self) -> bool:
        return self.rt.refresh()

    def slot(self):
        s = self.rt.slot
        return s.beta, s.means, s.priors, s.version

    def ladder_iters(self) -> int:
        return sum(e["iters_beta"] + e["iters_theta"] for e in self.rt.ladder_log)


class Control:
    """The reference in TF32 in the port's place."""

    def __init__(self, x0, y0, c: dict, device):
        self.server = ref_serving.Server(x0, y0, c, mm_tf32, publish_unconverged=True)

    def classify(self, z):
        return self.server.classify(z)

    def ingest(self, x, y) -> bool:
        return self.server.ingest(x, y)

    def refresh(self) -> bool:
        return self.server.refresh()

    def slot(self):
        s = self.server.slot
        return s.beta, s.means, s.priors, s.version

    def ladder_iters(self) -> int:
        return 0


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def shrink_for_cpu_tests(config: dict, traffic: dict) -> None:
    """Shrink, in place, a configuration and a traffic mix of this driver to the CPU tests'
    sizes (``portbench.testing.tiny_root``); a run of a cell never calls it.  The K3 gate
    block is the port's at the small width (one block of all d columns)."""
    config.update(d=24, n_signal=4, n_seed=200, tol=1e-2, gate_block_cols=24)
    traffic.update(batch=256, query_pool=4, sampled_ticks=8, trace_units=2)
    traffic["sessions"] = min(traffic["sessions"], 2)
    traffic["judged_sessions"] = min(traffic["judged_sessions"], 2)
    if traffic["epoch_ticks"] > 24:
        # an interval of 0 (never) stays 0
        traffic.update({k: v for k, v in CPU_TEST_EPOCH.items() if traffic[k]})


def setup(cell, device: torch.device, seed: int, system: str = "program", log=print) -> Setup:
    c, p = cell.config, cell.traffic
    n, batches = p["sessions"], _due(p["epoch_ticks"], p["ingest_every"])
    prob = sampler.problem(c["d"], c["n_signal"], c["rho"], device)
    gen = sampler.generator(seed, device)
    queries = sampler.queries(gen, prob, (p["query_pool"],), p["batch"])
    log(f"inputs: {n} sessions of {batches} batches of {p['ingest']} + {p['ingest']}, "
        f"{p['query_pool']} x {p['batch']} queries, d = {c['d']}")
    drawn, systems, refused = [], [], []
    for session in range(n):
        for attempt in range(1, SEED_DRAWS + 1):
            xb, yb = sampler.two_class(gen, prob, (batches,), p["ingest"], p["ingest"])
            x0, y0 = sampler.two_class(gen, prob, (), c["n_seed"], c["n_seed"])
            # a session the system cannot serve whole is kept for the check and drawn again:
            # its seed fit fails the ladder, or a refresh of its epoch publishes nothing
            try:
                seeded = (Program if system == "program" else Control)(x0, y0, c, device)
            except RuntimeError as err:
                if "did not converge" not in str(err) or attempt == SEED_DRAWS:
                    raise
                refused.append(Refused(x0, y0, xb, yb, True))
                log(f"session {session}, draw {attempt}: {err}")
                continue
            # (the control publishes every refresh by construction)
            if system == "program" and _misses_a_refresh(seeded, xb, yb, p):
                if attempt == SEED_DRAWS:
                    raise RuntimeError(f"session {session}: every draw misses a refresh")
                refused.append(Refused(x0, y0, xb, yb, False))
                log(f"session {session}, draw {attempt}: a refresh of its epoch published nothing")
                continue
            break
        drawn.append((x0, y0, xb, yb))
        systems.append(seeded)
    sync(device)
    log(f"seed fits and epochs checked: {n} sessions, {len(refused)} draws refused")
    x0s, y0s, xbs, ybs = zip(*drawn)
    seed_slots = [tuple(t.detach().cpu() if isinstance(t, torch.Tensor) else t
                        for t in sys_.slot()) for sys_ in systems]
    judged = sorted(random.Random(seed).sample(range(n), p["judged_sessions"]))
    st = Setup(c, p, device, seed, list(x0s), list(y0s), torch.stack(xbs), torch.stack(ybs),
               queries, systems, seed_slots, refused, judged)
    # every session runs the same shapes: one epoch warms them all
    run(st, units=1)
    log(f"warm-up: one epoch of {p['epoch_ticks']} ticks")
    return st


def _misses_a_refresh(system, xb, yb, p: dict) -> bool:
    """Whether a refresh of the session's epoch, run on a copy of ``system`` (the port's or the
    reference's server), publishes nothing."""
    server = copy.deepcopy(system)
    for pos in range(p["epoch_ticks"]):
        if _due(pos + 1, p["ingest_every"]) > _due(pos, p["ingest_every"]):
            j = _due(pos + 1, p["ingest_every"]) - 1
            server.ingest(xb[j], yb[j])
        if _due(pos + 1, p["refresh_every"]) > _due(pos, p["refresh_every"]):
            if not server.refresh():
                return True
    return False


def _due(pos: int, every: int) -> int:
    """Events of an ``every``-tick interval due in the first ``pos`` ticks (0: never)."""
    return pos // every if every else 0


def run(st: Setup, seconds: float | None = None, units: int | None = None,
        traced: bool = False) -> Record:
    """Epochs of ticks until ``seconds`` have passed (the tick in flight finishes), or ``units``
    whole epochs; ``traced`` marks each call with a span."""
    span = trace.spans(traced)
    p = st.p
    pool, ticks_per_epoch = p["query_pool"], p["epoch_ticks"]
    sampler_draw = random.Random(st.seed + 1)
    keep = p["sampled_ticks"]
    judged = set(st.judged)
    refreshes, sampled = [], []
    calls = {"classify": [], "refresh": []}
    iters = missed = 0
    clock = time.perf_counter
    # the predictions land in one pinned host buffer; a sampled tick keeps a copy
    host = torch.empty(p["batch"], dtype=torch.int64, pin_memory=st.device.type == "cuda")
    tick = epoch = seen = 0
    gc.collect()
    gc.disable()  # no collector pauses inside the window: the loop makes no reference cycles
    t0 = clock()
    done = False
    while not done:
        session = epoch % len(st.system)
        kept_here = session in judged
        server = copy.deepcopy(st.system[session])
        iters0 = server.ladder_iters()
        epoch += 1
        for pos in range(ticks_per_epoch):
            q = tick % pool
            a = clock()
            with span("classify"):
                pred, scores = server.classify(st.queries[q])
                host.copy_(pred)
            calls["classify"].append(clock() - a)
            if kept_here:
                # reservoir sample of the judged sessions' query batches the check compares
                j = len(sampled) if len(sampled) < keep else sampler_draw.randrange(seen + 1)
                seen += 1
                if j < keep:
                    kept = (session, pos, q, host.clone(), scores)
                    if j == len(sampled):
                        sampled.append(kept)
                    else:
                        sampled[j] = kept
            if _due(pos + 1, p["ingest_every"]) > _due(pos, p["ingest_every"]):
                j = _due(pos + 1, p["ingest_every"]) - 1
                with span("ingest"):
                    server.ingest(st.xb[session, j], st.yb[session, j])
            if _due(pos + 1, p["refresh_every"]) > _due(pos, p["refresh_every"]):
                a = clock()
                with span("refresh"):
                    ok = server.refresh()
                    sync(st.device)
                calls["refresh"].append(clock() - a)
                missed += not ok
                if kept_here:
                    refreshes.append((session, pos, ok, *server.slot()))
            tick += 1
            if units is None and clock() - t0 >= seconds:
                done = True
                break
        iters += server.ladder_iters() - iters0
        if units is not None and epoch >= units:
            done = True
    window = clock() - t0
    gc.enable()
    return Record(window, tick, tick * p["batch"], refreshes, sampled, calls, iters, missed)


def end_to_end(rec: Record) -> dict:
    return {"queries_per_s": rec.queries / rec.window_s}


def counts(rec: Record) -> dict:
    refreshes = len(rec.calls["refresh"])
    return {"ticks": rec.ticks, "refreshes": refreshes, "queries": rec.queries,
            "ladder_iters": rec.ladder_iters,
            "attempted": rec.ticks + refreshes, "failed": rec.missed}


def timed(rec: Record) -> dict:
    """Each call's seconds on the host's clock, by the call's name."""
    return rec.calls


def to_host(rec: Record) -> Record:
    def host(*ts):
        return tuple(t.detach().cpu() if isinstance(t, torch.Tensor) else t for t in ts)

    return rec._replace(refreshes=[host(*r) for r in rec.refreshes],
                        sampled=[host(*s) for s in rec.sampled])


def judge(st: Setup, rec: Record, limits: dict) -> dict:
    """Replay each judged session's epoch on the reference, then compare its seed fit's slot and
    every slot it published, and every sampled query batch at its position.

    ``slot_gap`` and ``score_gap`` are the widest gaps of a slot or a batch's scores,
    ``slot_gap_median`` and ``score_gap_median`` the median slot's and batch's, ``pred_gap`` the
    widest margin of a served prediction; ``refused_fits`` counts the draws the system refused
    that the reference serves whole.  A publish or a version that differs reads as infinity.
    A cell compares the numbers its limits name.
    """
    p = st.p
    refused_fits = sum(not _reference_refuses(st, r) for r in st.refused)
    slots, scores_, preds = [], [], []
    # a direction entry this near the threshold (relative) may land on either side of it
    band = limits.get("slot_gap", limits.get("slot_gap_median", 0.0))
    for session in st.judged:
        try:
            ref = ref_serving.Server(st.x0[session], st.y0[session], st.c, mm)
        except RuntimeError:  # the reference cannot fit the sample the port started from
            slots.append(math.inf)
            scores_.append(math.inf)
            break
        slot_at, published = [], {-1: (True, ref.slot)}
        for pos in range(p["epoch_ticks"]):
            slot_at.append(ref.slot)
            if _due(pos + 1, p["ingest_every"]) > _due(pos, p["ingest_every"]):
                j = _due(pos + 1, p["ingest_every"]) - 1
                ref.ingest(st.xb[session, j], st.yb[session, j])
            if _due(pos + 1, p["refresh_every"]) > _due(pos, p["refresh_every"]):
                published[pos] = (ref.refresh(), ref.slot)

        mine = [(-1, True, *st.seed_slot[session])]
        mine += [r[1:] for r in rec.refreshes if r[0] == session]
        for pos, ok, beta, means, priors, version in mine:
            slots.append(slot_gap(published[pos], ok, beta, means, priors, version,
                                  st.c["threshold"], band))

        for _, pos, q, pred, scores in (s for s in rec.sampled if s[0] == session):
            ref.slot = slot_at[pos]
            _, want = ref.classify(st.queries[q])
            want = want.cpu()
            scores_.append(compare.rel_gap(scores, want))
            preds.append(compare.pred_gap(pred, want))
    if any(math.isinf(g) for g in slots):  # a publish or a version differs: no slot is sound
        slots = [math.inf]
    return {"slot_gap": max(slots, default=math.inf),
            "slot_gap_median": statistics.median(slots) if slots else math.inf,
            "score_gap": max(scores_, default=math.inf),
            "score_gap_median": statistics.median(scores_) if scores_ else math.inf,
            "pred_gap": max(preds, default=math.inf),
            "refused_fits": refused_fits}


def slot_gap(published, ok, beta, means, priors, version, threshold: float, band: float) -> float:
    """One published slot's gap from the reference's at its position (infinity when the
    publish or the version differs)."""
    want_ok, want = published
    if ok != want_ok or int(version) != want.version:
        return math.inf
    gap = compare.thresholded_gap(2.0 * beta[:, 0], want.raw.cpu(), threshold, band)
    return max(gap, compare.rel_gap(means, want.means.cpu()),
               compare.rel_gap(priors, want.priors.cpu()))


def _reference_refuses(st: Setup, r: Refused) -> bool:
    """Whether the reference refuses a draw the system refused, at the same step: the seed fit, or
    a refresh of the epoch."""
    try:
        ref = ref_serving.Server(r.x0, r.y0, st.c, mm)
    except RuntimeError:
        return True
    return not r.at_seed and _misses_a_refresh(ref, r.xb, r.yb, st.p)

