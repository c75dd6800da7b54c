"""Closed-loop refined fits: T masked refinement rounds under dropout, back to back over a pool of datasets.

Each fit runs ``repro_torch.core.rounds.simulate_multi_round`` (the
machines' solves, then T closed-form rounds whose aggregate is the
liveness-masked mean) on the next dataset of a pool drawn in set-up
(m machines of n1 + n2 rows), with that dataset's (m, T) live mask, and
ends when the hard-thresholded last round is synchronised.  Set-up draws
each dataset's mask from the seed: a machine's uplink arrives in a round
with probability 1 - ``dropout``, independently per machine and round;
nothing straggles and nothing is corrupted.

Traffic parameters (``workloads/<cell>.json``): ``pool`` (datasets),
``dropout`` (the chance a machine misses a round) and ``trace_units``
(fits in the traced window).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from portbench import compare, sampler
from portbench.reference import fit as ref_fit
from portbench.reference import rounds as ref_rounds
from portbench.reference.precision import mm, mm_tf32
from portbench.traffic.fits import Record, counts, end_to_end, run, sync  # noqa: F401
from repro_torch.core import rounds, slda
from repro_torch.core.dantzig import DantzigConfig
from repro_torch.core.faults import Aggregation, FaultPlan
from repro_torch.core.pipeline import BinaryHead
from repro_torch.core.transport import CommPlan

REFERENCE_CHUNK = 8  # datasets the reference solves at once
# the configuration's ``aggregation`` by name: "masked" screens non-finite corrections, trims
# nothing and has no envelope
AGGREGATIONS = {"masked": Aggregation()}


class Setup(NamedTuple):
    c: dict
    p: dict
    device: torch.device
    xs: torch.Tensor  # (pool, m, n1, d)
    ys: torch.Tensor  # (pool, m, n2, d)
    live: torch.Tensor  # (pool, m, T) float32, 1 where a machine's round-t uplink arrives
    lam: float
    t: float
    system: object


class Program:
    """The port's refinement rounds, one dataset of the pool a call: ``(trajectory (T, d),
    the thresholded last round (d,))``."""

    def __init__(self, st: Setup):
        c = st.c
        self.st = st
        self.cfg = DantzigConfig(max_iters=c["max_iters"], rho=c["admm_rho"], alpha=c["alpha"],
                                 fused=c["fused"])
        self.comm = CommPlan(aggregation=AGGREGATIONS[c["aggregation"]])
        self.zeros = torch.zeros(st.live.shape[1:], dtype=torch.int32, device=st.device)

    def fit(self, i: int):
        st = self.st
        traj, _ = rounds.simulate_multi_round(
            BinaryHead(), (st.xs[i], st.ys[i]), lam=st.lam, lam_prime=st.lam,
            rounds=st.c["rounds"], cfg=self.cfg, comm=self.comm,
            faults=FaultPlan(st.live[i], self.zeros, self.zeros), return_all_rounds=True)
        traj = traj[..., 0]
        return traj, slda.hard_threshold(traj[-1], st.t)


class Control:
    """The reference in TF32 in the port's place."""

    def __init__(self, st: Setup):
        self.st = st

    def fit(self, i: int):
        st = self.st
        traj = _reference(st, [i], mm_tf32)[0]
        return traj, ref_fit.hard_threshold(traj[-1], st.t)


def _reference(st: Setup, idx, matmul) -> torch.Tensor:
    """The reference's (len(idx), T, d) aggregates on the datasets ``idx``."""
    return ref_rounds.fit_rounds(st.xs[idx], st.ys[idx], st.live[idx], lam=st.lam,
                                 lam_prime=st.lam, iters=st.c["max_iters"], mm=matmul)


def tuning(c: dict, prob: sampler.Problem) -> tuple[float, float]:
    """(lam, t): lam = lam_scale sqrt(log d / n) ||beta*||_1 at a site's n = N // m rows, as the
    source computes it, t = t_scale sqrt(log d / N) ||beta*||_1 over all N."""
    d = c["d"]
    lam = c["lam_scale"] * math.sqrt(math.log(d) / (c["N"] // c["m"])) * prob.beta_l1
    t = c["t_scale"] * math.sqrt(math.log(d) / c["N"]) * prob.beta_l1
    return lam, t


def shrink_for_cpu_tests(config: dict, traffic: dict) -> None:
    """Shrink, in place, a configuration and a traffic mix of this driver to the CPU tests'
    sizes (``portbench.testing.tiny_root``); a run of a cell never calls it."""
    config.update(d=24, n_signal=4, m=8, n1=15, n2=15, N=240, max_iters=60)
    traffic.update(pool=4, trace_units=2)


def setup(cell, device: torch.device, seed: int, system: str = "program", log=print) -> Setup:
    c, p = cell.config, cell.traffic
    prob = sampler.problem(c["d"], c["n_signal"], c["rho"], device)
    gen = sampler.generator(seed, device)
    xs, ys = sampler.two_class(gen, prob, (p["pool"], c["m"]), c["n1"], c["n2"])
    live = (torch.rand(p["pool"], c["m"], c["rounds"], generator=gen, device=device)
            >= p["dropout"]).to(torch.float32)
    lam, t = tuning(c, prob)
    st = Setup(c, p, device, xs, ys, live, lam, t, None)
    st = st._replace(system=(Program if system == "program" else Control)(st))
    sync(device)
    log(f"inputs: {p['pool']} datasets of {c['m']} x ({c['n1']} + {c['n2']}) x {c['d']}, "
        f"{c['rounds']} rounds, {int((live == 0).sum())} of {live.numel()} uplinks dropped")
    run(st, units=1)
    log("warm-up: one fit")
    return st


def to_host(rec: Record) -> Record:
    return rec._replace(answers=[(i, (traj.detach().cpu(), b.detach().cpu()))
                                 for i, (traj, b) in rec.answers])


def judge(st: Setup, rec: Record, limits: dict) -> dict:
    """Every fit of the window against the reference on its dataset and mask.  ``beta_gap``:
    the widest gap of a thresholded answer from the reference's last round, the threshold's
    near-ties aside; ``round_gap``: the widest gap of any round's aggregate, before the
    threshold, from the reference's."""
    idx = sorted({i for i, _ in rec.answers})
    want = {}
    for start in range(0, len(idx), REFERENCE_CHUNK):
        chunk = idx[start:start + REFERENCE_CHUNK]
        want.update({i: traj.cpu() for i, traj in zip(chunk, _reference(st, chunk, mm))})
    beta_gap = [compare.thresholded_gap(b, want[i][-1], st.t, limits["beta_gap"])
                for i, (_, b) in rec.answers]
    # a trajectory of the wrong length is a wrong answer, not a failed check
    round_gap = [max(compare.rel_gap(got, w) for got, w in zip(traj, want[i]))
                 if traj.shape == want[i].shape else math.inf for i, (traj, _) in rec.answers]
    return {"beta_gap": max(beta_gap, default=math.inf),
            "round_gap": max(round_gap, default=math.inf)}
