"""Algorithm 1 simulated on one device, one shot (twin of the simulated faces of ``repro.core.distributed``).

Machines are the leading axis of ``xs`` (m, n1, d) and ``ys``
(m, n2, d); every machine's solves run in one batch.  The reference
routes even ``rounds=1`` through its refinement-round core; at T = 1
that is exactly the machine mean of the one-shot debiased estimates,
which is what this module computes.  More rounds and every comms
option (compression, faults, staleness, aggregation, comm plans) come
with a later slice of the port.
"""

from __future__ import annotations

import torch

from repro_torch.core import pipeline, slda
from repro_torch.core.dantzig import DantzigConfig
from repro_torch.core.pipeline import BinaryHead


def _one_shot_only(rounds, compression, faults, staleness, aggregation, comm) -> None:
    if rounds != 1:
        raise NotImplementedError(
            f"rounds={rounds}: refinement rounds come with the port's rounds slice")
    if (compression, faults, aggregation, comm) != (None,) * 4 or staleness:
        raise NotImplementedError(
            "compression, faults, staleness, aggregation and comm plans come with "
            "the port's transport slice")


def simulated_debiased_mean(xs: torch.Tensor, ys: torch.Tensor, lam, lam_prime,
                            cfg: DantzigConfig = DantzigConfig(), rounds: int = 1,
                            compression=None, faults=None, staleness: int = 0,
                            aggregation=None, comm=None, *,
                            use_kernel: bool | None = None) -> torch.Tensor:
    """Mean of the machines' debiased estimates, before the hard threshold: (d,).

    ``use_kernel`` picks the gram path of the statistics as in
    :func:`repro_torch.core.pipeline.suff_stats` (None: K1 on the card).
    """
    _one_shot_only(rounds, compression, faults, staleness, aggregation, comm)
    beta_tilde, _, _ = pipeline.worker_debiased(
        BinaryHead(use_kernel), xs, ys, lam=lam, lam_prime=lam_prime, cfg=cfg)
    return beta_tilde.mean(0)[:, 0]


def simulated_distributed_slda(xs: torch.Tensor, ys: torch.Tensor, lam, lam_prime, t,
                               cfg: DantzigConfig = DantzigConfig(), rounds: int = 1,
                               compression=None, faults=None, staleness: int = 0,
                               aggregation=None, comm=None, *,
                               use_kernel: bool | None = None) -> torch.Tensor:
    """xs: (m, n1, d), ys: (m, n2, d) -> aggregated beta_bar (d,)."""
    return slda.hard_threshold(
        simulated_debiased_mean(xs, ys, lam, lam_prime, cfg, rounds, compression, faults,
                                staleness, aggregation, comm, use_kernel=use_kernel), t)


def simulated_naive_averaged_slda(xs: torch.Tensor, ys: torch.Tensor, lam,
                                  cfg: DantzigConfig = DantzigConfig(), *,
                                  use_kernel: bool | None = None) -> torch.Tensor:
    """Mean over machines of the biased local estimators (no debiasing)."""
    stats = slda.suff_stats(xs, ys, use_kernel)
    return slda.local_slda(stats, lam, cfg).mean(0)
