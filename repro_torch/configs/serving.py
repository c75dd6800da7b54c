"""The serving operating point the port's card run drives.

``benchmarks/serving.py --paper``: the binary problem at d = 120
(AR(0.5), 12 signal coordinates), a seed fit on 4d samples a class,
8,192 queries a tick over 24 ticks, 60 samples a class ingested a tick
and a refresh every 2 ticks, lam = 0.1, lam' = 0.2, threshold 1e-3,
``tol=1e-3``, staleness bound 2, and its chaos plan (corrupt 0.4,
diverge 0.5, drop 0.2, seed 5; accuracy slack 0.02); the staleness
curve over 0..4 missed refreshes and a 400 + 400 refreshed refit; the
warm-against-cold refit after a 150 + 150 batch.  The K-class stream is
``src/repro/launch/serve.py``'s (``--classes 5``: n_signal = d // 10,
AR(0.5), a seed of 4 x 60 x 2 = 480 labelled samples, 120 a tick), run
8 ticks with a refresh every 4 and held out on 2,000 draws.  Not
reduced: these are the reference's own sizes.

One knob is not the reference's default: at d = 120, K = 5 the
direction solve needs ~2,500 iterations from cold to reach tol 1e-3
(fixed rho, and ~2,800 under the adaptive-rho scan), so under the
default ladder (600, then 1,200 on the refactor rung) the reference's
own runtime refuses to start (``initial fit did not converge``).  The
K-class stream runs with ``EscalationPolicy(refactor_scale=5)``: its
refactor rung gets 3,000 iterations.
"""

from typing import NamedTuple


class ServingConfig(NamedTuple):
    d: int = 120
    n_signal: int = 12
    rho: float = 0.5
    n_seed: int = 480  # 4d samples a class for the seed fit
    batch: int = 8192  # queries a tick
    ticks: int = 24
    ingest: int = 60  # arriving samples a class a tick
    refit_every: int = 2
    lam: float = 0.1
    lam_prime: float = 0.2
    threshold: float = 1e-3
    tol: float = 1e-3
    staleness_bound: int = 2
    corrupt: float = 0.4
    diverge: float = 0.5
    drop: float = 0.2
    fault_seed: int = 5
    acc_slack: float = 0.02
    max_stale: int = 4  # the staleness curve's missed refreshes
    n_refreshed: int = 400  # samples a class of the refreshed refit
    n_warm: int = 150  # samples a class of the warm-against-cold batch
    warm_drift: float = 2e-2  # the warm refit's budget against the cold one
    classes: int = 5  # the K-class stream
    mc_n_signal: int = 12  # d // 10
    mc_rho: float = 0.5
    mc_refactor_scale: int = 5
    mc_ticks: int = 8
    mc_refit_every: int = 4
    n_test: int = 2000
    qps_reps: int = 20


SERVING = ServingConfig()
