"""Algorithm 1 simulated on one device (twin of the simulated faces of ``repro.core.distributed``).

Machines are the leading axis of ``xs`` (m, n1, d) and ``ys``
(m, n2, d); every machine's solves run in one batch.  As in the
reference, every face goes through the refinement-round core
(:func:`repro_torch.core.rounds.simulate_multi_round`): ``rounds=1``
with the default plan is the machine mean of the one-shot debiased
estimates, bit for bit, and ``rounds``, ``compression``, ``faults``,
``staleness``, ``aggregation`` and ``comm`` (a
:class:`~repro_torch.core.transport.CommPlan`) configure the rounds
and their wire.  The mesh faces come with a later slice of the port.
"""

from __future__ import annotations

import torch

from repro_torch.core import rounds as rounds_core
from repro_torch.core import slda
from repro_torch.core.dantzig import DantzigConfig
from repro_torch.core.pipeline import BinaryHead


def simulated_debiased_mean(xs: torch.Tensor, ys: torch.Tensor, lam, lam_prime,
                            cfg: DantzigConfig = DantzigConfig(), rounds: int = 1,
                            compression=None, faults=None, staleness: int = 0,
                            aggregation=None, comm=None, *,
                            use_kernel: bool | None = None) -> torch.Tensor:
    """Mean of the machines' debiased estimates after ``rounds`` rounds, before the hard
    threshold: (d,).

    ``use_kernel`` picks the gram path of the statistics as in
    :func:`repro_torch.core.pipeline.suff_stats` (None: K1 on the card).
    """
    beta_bar, _ = rounds_core.simulate_multi_round(
        BinaryHead(use_kernel), (xs, ys), lam=lam, lam_prime=lam_prime, rounds=rounds,
        cfg=cfg, comm=comm, compression=compression, faults=faults, staleness=staleness,
        aggregation=aggregation)
    return beta_bar[:, 0]


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
