"""Closed-loop distributed fits: Algorithm 1 back to back over a pool of datasets.

Each fit runs ``repro_torch.core.distributed.simulated_distributed_slda``
(the one-shot estimator) on the next dataset of a pool drawn in set-up
(m machines of n1 + n2 rows), and ends when its thresholded aggregate is
synchronised.

Traffic parameters (``workloads/<cell>.json``): ``pool`` (datasets) and
``trace_units`` (fits in the traced window).
"""

from __future__ import annotations

import math
import time
from typing import NamedTuple

import torch

from portbench import compare, sampler, trace
from portbench.reference import fit as ref_fit
from portbench.reference.precision import mm, mm_tf32
from repro_torch.core import distributed
from repro_torch.core.dantzig import DantzigConfig

REFERENCE_CHUNK = 8  # datasets the reference solves at once


class Setup(NamedTuple):
    c: dict
    p: dict
    device: torch.device
    xs: torch.Tensor  # (pool, m, n1, d)
    ys: torch.Tensor  # (pool, m, n2, d)
    lam: float
    t: float
    system: object


class Record(NamedTuple):
    answers: list  # (dataset, beta_bar) in the order the fits ended
    window_s: float


class Program:
    """The port's fit entry point, one dataset of the pool a call."""

    def __init__(self, st: Setup):
        c = st.c
        self.st = st
        self.cfg = DantzigConfig(max_iters=c["max_iters"], rho=c["admm_rho"], alpha=c["alpha"],
                                 fused=c["fused"])

    def fit(self, i: int) -> torch.Tensor:
        st = self.st
        return distributed.simulated_distributed_slda(st.xs[i], st.ys[i], st.lam, st.lam, st.t,
                                                      self.cfg)


class Control:
    """The reference in TF32 in the port's place."""

    def __init__(self, st: Setup):
        self.st = st

    def fit(self, i: int) -> torch.Tensor:
        st = self.st
        return _reference(st, [i], mm_tf32)[0][0]


def _reference(st: Setup, idx, matmul):
    """(beta_bar, mean) of the reference on the datasets ``idx``, each (len(idx), d)."""
    return ref_fit.fit(st.xs[idx], st.ys[idx], lam=st.lam, lam_prime=st.lam, t=st.t,
                       iters=st.c["max_iters"], mm=matmul)


def tuning(c: dict, prob: sampler.Problem) -> tuple[float, float]:
    """(lam, t): lam = lam_scale sqrt(log d / n) ||beta*||_1 at a machine's n rows,
    t = t_scale sqrt(log d / N) ||beta*||_1 over all N."""
    d, n = c["d"], c["n1"] + c["n2"]
    lam = c["lam_scale"] * math.sqrt(math.log(d) / n) * prob.beta_l1
    t = c["t_scale"] * math.sqrt(math.log(d) / (c["m"] * n)) * prob.beta_l1
    return lam, t


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def shrink_for_cpu_tests(config: dict, traffic: dict) -> None:
    """Shrink, in place, a configuration and a traffic mix of this driver to the CPU tests'
    sizes (``portbench.testing.tiny_root``); a run of a cell never calls it."""
    config.update(d=24, n_signal=4, m=4, n1=30, n2=30, N=240, max_iters=60)
    traffic.update(pool=4, trace_units=2)


def setup(cell, device: torch.device, seed: int, system: str = "program", log=print) -> Setup:
    c, p = cell.config, cell.traffic
    prob = sampler.problem(c["d"], c["n_signal"], c["rho"], device)
    gen = sampler.generator(seed, device)
    xs, ys = sampler.two_class(gen, prob, (p["pool"], c["m"]), c["n1"], c["n2"])
    lam, t = tuning(c, prob)
    st = Setup(c, p, device, xs, ys, lam, t, None)
    st = st._replace(system=(Program if system == "program" else Control)(st))
    sync(device)
    log(f"inputs: {p['pool']} datasets of {c['m']} x ({c['n1']} + {c['n2']}) x {c['d']}")
    run(st, units=1)
    log("warm-up: one fit")
    return st


def run(st: Setup, seconds: float | None = None, units: int | None = None,
        traced: bool = False) -> Record:
    """Fits back to back until ``seconds`` have passed (the fit in flight finishes), or ``units``
    fits; ``traced`` marks each fit with a span."""
    span = trace.spans(traced)
    answers = []
    pool = st.p["pool"]
    t0 = time.perf_counter()
    while True:
        i = len(answers) % pool
        with span("fit"):
            out = st.system.fit(i)
            sync(st.device)
        answers.append((i, out))
        if (len(answers) >= units) if units is not None else (
                time.perf_counter() - t0 >= seconds):
            break
    return Record(answers, time.perf_counter() - t0)


def end_to_end(rec: Record) -> dict:
    return {"fit_ms": 1e3 * rec.window_s / len(rec.answers)}


def counts(rec: Record) -> dict:
    return {"fits": len(rec.answers), "attempted": len(rec.answers), "failed": 0}


def to_host(rec: Record) -> Record:
    return rec._replace(answers=[(i, b.detach().cpu()) for i, b in rec.answers])


def judge(st: Setup, rec: Record, limits: dict) -> dict:
    """``beta_gap``: the widest gap of any fit's aggregate from the reference's (every fit of the
    window), the threshold's near-ties aside."""
    idx = sorted({i for i, _ in rec.answers})
    raw = {}
    for start in range(0, len(idx), REFERENCE_CHUNK):
        chunk = idx[start:start + REFERENCE_CHUNK]
        _, mean = _reference(st, chunk, mm)
        raw.update({i: row.cpu() for i, row in zip(chunk, mean)})
    gap = max((compare.thresholded_gap(b, raw[i], st.t, limits["beta_gap"])
               for i, b in rec.answers), default=math.inf)
    return {"beta_gap": gap}
