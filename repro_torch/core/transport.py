"""The two-way transport layer: one comms config for both wires (twin of ``repro.core.transport``).

* :class:`CommPlan` -- one hashable config: the uplink and downlink
  codecs, a :class:`BitBudget` schedule, the fault schedule, the
  staleness bound and the aggregation policy.  ``CommPlan()`` is the
  dense path.  The separate ``compression=`` / ``faults=`` /
  ``staleness=`` / ``aggregation=`` arguments of the entry points are
  packed into one by :func:`resolve_comm`.
* :class:`BitBudget` -- per-round ``(uplink, downlink)`` codecs under a
  total bit budget (``constant``, ``taper`` or ``adaptive`` shares),
  planned on the host in integer arithmetic: the planned ``k_top``
  pairs equal the reference's.
* :class:`Transport` -- a plan resolved against one run's (d, K, T): a
  :class:`Link` pair per round and the exact per-direction bit totals.

On the mesh the downlink crosses the wire by :func:`psum_broadcast`;
in the simulation machine 0 is the aggregator.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Sequence

import torch

from repro_torch.core import collectives
from repro_torch.core import compression as compression_core
from repro_torch.core.compression import (
    QUANTIZE_MODES,
    SCALE_BITS,
    Compression,
    dense_uplink_bits,
    index_bits,
    uplink_bits,
)
from repro_torch.core.faults import Aggregation, FaultSchedule


class BitBudget(NamedTuple):
    """A round-adaptive codec schedule under a fixed TOTAL bit budget.

    ``total_bits`` is one machine's link over all ``rounds`` and both
    directions.  Round t's share is even (``constant``), proportional to
    ``taper**(t-1)`` (``taper``) or to ``weights[t-1]`` (``adaptive``);
    ``down_fraction`` of it goes to the downlink, and each direction's
    bits invert to the largest ``k_top`` whose wire cost fits.
    """

    total_bits: int
    mode: str = "taper"
    taper: float = 0.5
    quantize: str | None = "int8"
    down_fraction: float = 0.5
    weights: tuple[float, ...] | None = None

    def validate(self, rounds: int) -> None:
        if self.total_bits < 1:
            raise ValueError(f"total_bits must be >= 1, got {self.total_bits}")
        if self.mode not in ("constant", "taper", "adaptive"):
            raise ValueError(f"unknown schedule mode {self.mode!r}")
        if self.quantize not in QUANTIZE_MODES:
            raise ValueError(f"unknown quantize mode {self.quantize!r}")
        if not 0.0 <= self.down_fraction <= 1.0:
            raise ValueError(f"down_fraction must be in [0, 1], got {self.down_fraction}")
        if self.mode == "taper" and not self.taper > 0:
            raise ValueError(f"taper ratio must be > 0, got {self.taper}")
        if self.mode == "adaptive":
            if self.weights is None or len(self.weights) != rounds:
                raise ValueError(
                    f"adaptive mode needs weights of length rounds={rounds}, "
                    f"got {self.weights!r}")
            if not all(w > 0 for w in self.weights):
                raise ValueError(f"weights must be positive: {self.weights}")

    def round_shares(self, rounds: int) -> tuple[float, ...]:
        """Fraction of ``total_bits`` each round gets (sums to 1)."""
        self.validate(rounds)
        if self.mode == "constant":
            w = [1.0] * rounds
        elif self.mode == "taper":
            w = [self.taper ** t for t in range(rounds)]
        else:
            w = list(self.weights)
        s = sum(w)
        return tuple(wi / s for wi in w)

    def plan_rounds(self, d: int, num_cols: int,
                    rounds: int) -> tuple[tuple[Compression, Compression], ...]:
        """The realized per-round ``(uplink, downlink)`` codec pairs, ``k_top`` in [1, d]."""
        out = []
        for share in self.round_shares(rounds):
            bits_t = self.total_bits * share
            up = _fit_codec(bits_t * (1.0 - self.down_fraction), d, num_cols, self.quantize)
            down = _fit_codec(bits_t * self.down_fraction, d, num_cols, self.quantize)
            out.append((up, down))
        return tuple(out)


def _fit_codec(budget_bits: float, d: int, num_cols: int,
               quantize: str | None) -> Compression:
    """Largest ``k_top`` whose :func:`~repro_torch.core.compression.uplink_bits` fits."""
    per_coord = num_cols * (QUANTIZE_MODES[quantize] + index_bits(d))
    overhead = num_cols * SCALE_BITS if quantize == "int8" else 0
    k = int((budget_bits - overhead) // per_coord)
    return Compression(max(1, min(k, d)), quantize)


class CommPlan(NamedTuple):
    """One hashable config for everything on the wire; ``CommPlan()`` is the dense path.

    ``faults`` holds a :class:`FaultSchedule` only (a materialized
    :class:`~repro_torch.core.faults.FaultPlan` is data and rides as
    its own argument); ``schedule`` excludes fixed codecs.
    """

    uplink: Compression | None = None
    downlink: Compression | None = None
    schedule: BitBudget | None = None
    faults: FaultSchedule | None = None
    staleness: int = 0
    aggregation: Aggregation | None = None

    def validate(self) -> None:
        if self.schedule is not None and (self.uplink is not None
                                          or self.downlink is not None):
            raise ValueError(
                "CommPlan.schedule replans both directions per round; "
                "fixed uplink/downlink codecs cannot be combined with it")
        if self.staleness < 0:
            raise ValueError(f"staleness must be >= 0, got {self.staleness}")


def resolve_comm(comm: CommPlan | None, *, compression: Compression | None = None,
                 faults: FaultSchedule | None = None, staleness: int = 0,
                 aggregation: Aggregation | None = None,
                 where: str = "this entry point") -> CommPlan:
    """The separate arguments packed into one :class:`CommPlan`; an explicit ``comm``
    excludes them."""
    if comm is None:
        comm = CommPlan(uplink=compression, faults=faults, staleness=staleness,
                        aggregation=aggregation)
    elif not isinstance(comm, CommPlan):
        raise TypeError(f"{where}: comm must be a CommPlan, got {type(comm).__name__}")
    elif (compression is not None or faults is not None or staleness
          or aggregation is not None):
        raise TypeError(
            f"{where}: pass comm=CommPlan(...) OR the compression=/faults=/staleness=/"
            "aggregation= arguments, not both")
    comm.validate()
    return comm


class Link(NamedTuple):
    """One direction of one round: the codec, or dense (``comp=None``)."""

    comp: Compression | None

    @property
    def compressed(self) -> bool:
        return self.comp is not None

    def bits(self, d: int, num_cols: int) -> int:
        """What this link moves in one round, at wire dtypes."""
        return link_bits(self.comp, d, num_cols)

    def encode(self, u, ref):
        return compression_core.encode(self.comp, u, ref)

    def decode(self, payload, ref, *, screen_nonfinite: bool = True):
        return compression_core.decode(self.comp, payload, ref,
                                       screen_nonfinite=screen_nonfinite)

    def ef_step(self, message, residual, ref):
        return compression_core.ef_step(self.comp, message, residual, ref)


def link_bits(comp: Compression | None, d: int, num_cols: int) -> int:
    """Per-round per-machine bits of one direction (dense when None)."""
    if comp is None:
        return dense_uplink_bits(d, num_cols)
    return uplink_bits(comp, d, num_cols)


class TransportState(NamedTuple):
    """The carries a split round stream needs to resume bit for bit: the per-machine
    (m, d, K) uplink residual and the aggregator's (d, K) downlink residual (None on an
    uncompressed direction)."""

    up_residual: Any = None
    down_residual: Any = None


class Transport:
    """A :class:`CommPlan` resolved against one run's (d, K, T)."""

    def __init__(self, comm: CommPlan, d: int, num_cols: int, rounds: int):
        comm.validate()
        self.comm = comm
        self.d, self.num_cols, self.rounds = d, num_cols, rounds
        if comm.schedule is not None:
            self.links = comm.schedule.plan_rounds(d, num_cols, rounds)
        else:
            self.links = ((comm.uplink, comm.downlink),) * rounds
        for up, down in self.links:
            if up is not None:
                up.validate(d)
            if down is not None:
                down.validate(d)
        self.any_up = any(up is not None for up, _ in self.links)
        self.any_down = any(down is not None for _, down in self.links)

    @property
    def staleness(self) -> int:
        return self.comm.staleness

    @property
    def aggregation(self) -> Aggregation | None:
        return self.comm.aggregation

    def up(self, t: int) -> Link:
        """Round t's uplink (1-indexed, like the round loop)."""
        return Link(self.links[t - 1][0])

    def down(self, t: int) -> Link:
        """Round t's downlink (1-indexed)."""
        return Link(self.links[t - 1][1])

    def uplink_total_bits(self) -> int:
        """Per-machine uplink bits over all rounds."""
        return sum(link_bits(up, self.d, self.num_cols) for up, _ in self.links)

    def downlink_total_bits(self) -> int:
        """Downlink bits over all rounds (0 when dense: the replicated broadcast
        never touches the wire)."""
        return sum(link_bits(down, self.d, self.num_cols)
                   for _, down in self.links if down is not None)


def psum_broadcast(payload, data_axes: Sequence):
    """Broadcast the master's payload leaves over the data axes.

    Machine 0 of the data axes is the aggregator; every other machine
    sends exact zeros, so the sum is the master's leaf bit for bit
    (x + 0.0 == x, except that -0.0 lands as +0.0, as in the
    reference).  A sum, not a broadcast: it puts the downlink on the
    wire every machine reads, where a fault can hit it.  int16 indices
    sum as bytes (one non-zero operand, see
    :func:`repro_torch.core.collectives.all_reduce_bytes`).
    """
    is_master = collectives.machine_index(data_axes) == 0

    def send(leaf):
        if leaf is None:
            return None
        x = leaf if is_master else torch.zeros_like(leaf)
        if x.dtype == torch.int16:
            return collectives.all_reduce_bytes(x, data_axes)
        return collectives.all_reduce_sum(x, data_axes)

    return type(payload)(*(send(leaf) for leaf in payload))
