"""Algorithm 1 on a ``torch.distributed`` mesh, and simulated on one device (twin of ``repro.core.distributed``).

The mesh faces (``*_shardmap``, the reference's names) run on every
rank of a :class:`~torch.distributed.device_mesh.DeviceMesh`
(:mod:`repro_torch.launch.mesh`):

* the paper's m machines are the ranks of the data axes (``("pod",
  "data")``); every rank receives the global (N, d) arrays, as the
  reference's callers pass them, and takes its own contiguous block of
  N / m rows in machine order, the split ``P(data_axes, None)`` makes;
  it then runs the whole worker pipeline with no communication;
* the model axis shards one machine's CLIME columns (pad-and-mask, so
  any (d, |model|) pair is exact) and one gather over it reassembles
  the correction;
* each round's mean is one ``all_reduce`` over the data axes (the
  compressed and fault-tolerant rounds gather payloads or blocks
  instead); the hard threshold runs replicated and every rank returns
  the same result.

A :class:`~repro_torch.core.faults.FaultSchedule` is materialized
identically on every rank (a seeded CPU generator) and each rank takes
its machine's row.  Every argument is checked before the solves.

The simulated faces take machines as the leading axis of ``xs``
(m, n1, d) and ``ys`` (m, n2, d); every machine's solves run in one
batch.  Both kinds go through the refinement-round core
(:mod:`repro_torch.core.rounds`): ``rounds=1`` with the default plan
is the machine mean of the one-shot debiased estimates, and
``rounds``, ``compression``, ``faults``, ``staleness``,
``aggregation`` and ``comm`` (a
:class:`~repro_torch.core.transport.CommPlan`) configure the rounds
and their wire.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Sequence

import torch

from repro_torch.analysis.contracts import (
    AxisPayloadBits,
    CollectiveContract,
    DtypePolicy,
    GramLaunches,
    Param,
    PrimitiveBudget,
    SmemConformance,
)
from repro_torch.analysis.registry import trace_contract
from repro_torch.core import collectives
from repro_torch.core import rounds as rounds_core
from repro_torch.core import slda
from repro_torch.core.dantzig import DantzigConfig
from repro_torch.core.faults import FaultPlan
from repro_torch.core.pipeline import BinaryHead, MulticlassHead
from repro_torch.core.transport import CommPlan
from repro_torch.launch.mesh import axis_size, mesh_device


def _materialize_plan(faults, mesh, data_axes, rounds: int, staleness: int,
                      device: str | torch.device = "cuda"):
    """``faults`` as the full (m, rounds) :class:`FaultPlan` of this mesh's m machines.

    A schedule is drawn here, the same on every rank; a plan is checked.
    """
    m = 1
    for ax in data_axes:
        m *= axis_size(mesh, ax)
    return rounds_core._round_plan(m, rounds, None, None, faults, staleness, None, device,
                                   "_materialize_plan")[1]


class RankView(NamedTuple):
    """One rank's place on the mesh: the data axes (:class:`~repro_torch.core.collectives.Axis`),
    its machine and the machine count, the model axis (None: no model axis) and its size,
    its device."""

    groups: tuple
    machine: int
    m: int
    model: Any
    model_size: int
    device: torch.device

    def block(self, a, where: str) -> torch.Tensor:
        """This machine's contiguous block of the global rows of ``a``, on the rank's device."""
        n = a.shape[0]
        if n % self.m:
            raise ValueError(f"{where}: {n} rows do not split over {self.m} machines")
        per = n // self.m
        return torch.as_tensor(a[self.machine * per:(self.machine + 1) * per]).to(self.device)


def rank_view(mesh, data_axes: Sequence[str] = ("data",), model_axis: str | None = None
              ) -> RankView:
    """This rank's :class:`RankView` of ``mesh``."""
    groups = tuple(collectives.Axis(ax, mesh.get_group(ax)) for ax in data_axes)
    model = (collectives.Axis(model_axis, mesh.get_group(model_axis))
             if model_axis is not None else None)
    return RankView(groups, collectives.machine_index(groups), collectives.machine_count(groups),
                    model, axis_size(mesh, model_axis) if model_axis is not None else 1,
                    mesh_device(mesh))


def _mesh_setup(mesh, data_axes, model_axis, comm, faults, compression, staleness,
                aggregation, rounds: int, where: str):
    """The checked arguments of a mesh face, before any solve: ``(view, worker comm, this
    machine's FaultPlan row or None)``."""
    if comm is not None and faults is not None:
        raise TypeError(f"{where}: pass the fault schedule inside comm=CommPlan(faults=...), "
                        "not alongside it")
    view = rank_view(mesh, data_axes, model_axis)
    comm, plan = rounds_core._round_plan(view.m, rounds, comm, compression, faults, staleness,
                                         aggregation, view.device, where)
    row = None if plan is None else FaultPlan(*(leaf[view.machine].to(view.device)
                                                for leaf in plan))
    return view, comm, row


@trace_contract(
    "distributed.slda_shardmap",
    contracts=(
        PrimitiveBudget("eigh", exact=1),
        # Algorithm 1's dense uplink: one (d, 1) psum per dense round --
        # nothing else crosses the data axis (0 psums when compressed)
        CollectiveContract("psum", count=Param("dense_psums"), axis="data",
                           shape=Param("psum_payload"), dtype="float32"),
        # the DESIGN §11 liveness mask: one scalar f32 psum per masked
        # dense round (0 on the legacy path), and nothing else -- the
        # total psum budget closes the loophole
        CollectiveContract("psum", count=Param("live_psums"), axis="data",
                           shape=(), dtype="float32"),
        PrimitiveBudget("psum", exact=Param("total_psums")),
        CollectiveContract("all_gather", count=Param("rounds"),
                           axis="model"),
        # compressed uplink: the payload gathers, and the exact bits
        # per direction -- uplink payloads on all_gathers, dense psums
        # + liveness masks + downlink payloads on psums (DESIGN.md §13)
        CollectiveContract("all_gather", count=Param("data_gathers"),
                           axis="data"),
        AxisPayloadBits("data", exact_bits=Param("data_gather_bits"),
                        prims=("all_gather",)),
        AxisPayloadBits("data", exact_bits=Param("data_psum_bits"),
                        prims=("psum",)),
        AxisPayloadBits("data", exact_bits=Param("data_total_bits")),
        PrimitiveBudget("is_finite", exact=Param("screen_ops")),
        PrimitiveBudget("pallas_call", exact=Param("pallas_calls")),
        GramLaunches(Param("gram_launches")),
        DtypePolicy(),
        SmemConformance(),
    ),
)
def distributed_slda_shardmap(mesh, x, y, lam, lam_prime, t,
                              cfg: DantzigConfig = DantzigConfig(),
                              data_axes: Sequence[str] = ("data",),
                              model_axis: str | None = "model", rounds: int = 1,
                              comm: CommPlan | None = None, compression=None, faults=None,
                              staleness: int = 0, aggregation=None, *,
                              use_kernel: bool | None = None) -> torch.Tensor:
    """Distributed sparse LDA on the mesh (one shot, or T refined rounds), on every rank.

    ``x`` (N1, d) and ``y`` (N2, d) are the global class samples; each
    machine takes its N1 / m and N2 / m rows.  ``comm`` and the
    separate ``compression`` / ``faults`` / ``staleness`` /
    ``aggregation`` as in the simulated face; ``faults`` also takes an
    (m, rounds) :class:`FaultPlan`.  ``use_kernel`` picks the gram path
    of the statistics (None: K1 on the card).  Returns the replicated
    beta_bar (d,) after the hard threshold.
    """
    where = "distributed_slda_shardmap"
    view, comm, row = _mesh_setup(mesh, data_axes, model_axis, comm, faults, compression,
                                  staleness, aggregation, rounds, where)
    beta_bar, _ = rounds_core.worker_rounds(
        BinaryHead(use_kernel), view.block(x, where), view.block(y, where), lam=lam,
        lam_prime=lam_prime, rounds=rounds, cfg=cfg, data_axes=view.groups,
        model_axis=view.model, model_axis_size=view.model_size, comm=comm, faults=row)
    return slda.hard_threshold(beta_bar[:, 0], t)


@trace_contract(
    "distributed.mc_slda_shardmap",
    contracts=(
        PrimitiveBudget("eigh", exact=1),
        # one (d, K) direction psum per DENSE round over the data axis
        # (0 when compressed) ...
        CollectiveContract("psum", count=Param("dense_psums"), axis="data",
                           shape=Param("direction_payload"),
                           dtype="float32"),
        # ... plus exactly one (K, d) class-means psum, and nothing else
        CollectiveContract("psum", count=1, axis="data",
                           shape=Param("means_payload"), dtype="float32"),
        # the liveness-mask scalar psum of masked rounds (DESIGN §11)
        CollectiveContract("psum", count=Param("live_psums"), axis="data",
                           shape=(), dtype="float32"),
        PrimitiveBudget("psum", exact=Param("total_psums")),
        CollectiveContract("all_gather", count=Param("rounds"),
                           axis="model"),
        # compressed uplink: the payload gathers, and the exact bits
        # everything moves over the data axis, split by direction
        # (the one-time means psum counts on the psum side)
        CollectiveContract("all_gather", count=Param("data_gathers"),
                           axis="data"),
        AxisPayloadBits("data", exact_bits=Param("data_gather_bits"),
                        prims=("all_gather",)),
        AxisPayloadBits("data", exact_bits=Param("data_psum_bits"),
                        prims=("psum",)),
        AxisPayloadBits("data", exact_bits=Param("data_total_bits")),
        PrimitiveBudget("is_finite", exact=Param("screen_ops")),
        PrimitiveBudget("pallas_call", exact=Param("pallas_calls")),
        GramLaunches(Param("gram_launches")),
        DtypePolicy(),
        SmemConformance(),
    ),
)
def distributed_mc_slda_shardmap(mesh, x, labels, num_classes: int, lam, lam_prime, t,
                                 cfg: DantzigConfig = DantzigConfig(),
                                 data_axes: Sequence[str] = ("data",),
                                 model_axis: str | None = "model", rounds: int = 1,
                                 comm: CommPlan | None = None, compression=None, faults=None,
                                 staleness: int = 0, aggregation=None
                                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Distributed K-class sparse LDA on the mesh: ``(beta_bar (d, K), means (K, d))``,
    replicated.

    Each round moves one (d, K) direction block; the (K, d) class means
    ride one extra dense mean once, not fault-masked, as in the reference.
    """
    where = "distributed_mc_slda_shardmap"
    view, comm, row = _mesh_setup(mesh, data_axes, model_axis, comm, faults, compression,
                                  staleness, aggregation, rounds, where)
    beta_bar, ws = rounds_core.worker_rounds(
        MulticlassHead(num_classes), view.block(x, where), view.block(labels, where), lam=lam,
        lam_prime=lam_prime, rounds=rounds, cfg=cfg, data_axes=view.groups,
        model_axis=view.model, model_axis_size=view.model_size, comm=comm, faults=row)
    means = collectives.all_reduce_sum(ws.stats.aux.means, view.groups) / view.m
    return slda.hard_threshold(beta_bar, t), means


def naive_averaged_slda_shardmap(mesh, x, y, lam, cfg: DantzigConfig = DantzigConfig(),
                                 data_axes: Sequence[str] = ("data",), *,
                                 use_kernel: bool | None = None) -> torch.Tensor:
    """Baseline on the mesh: the mean of the biased local estimators (no debias, no HT)."""
    where = "naive_averaged_slda_shardmap"
    view = rank_view(mesh, data_axes)
    stats = slda.suff_stats(view.block(x, where), view.block(y, where), use_kernel)
    return collectives.all_reduce_sum(slda.local_slda(stats, lam, cfg), view.groups) / view.m


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
