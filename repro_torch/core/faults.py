"""Fault-tolerant aggregation for the refinement rounds (twin of ``repro.core.faults``).

* :class:`FaultSchedule` -- seedable per-machine, per-round fault rates
  (dropout, straggle by s rounds, wire corruption); :meth:`plan`
  materializes a :class:`FaultPlan` of (m, rounds) tensors.  The port
  draws on a ``torch.Generator`` seeded from ``seed`` (on the CPU, so
  one seed gives one plan on every device).  The reference draws from
  ``jax.random``, which the port does not reproduce: a parity test
  hands the reference's materialized plan to both packages.
* :class:`Aggregation` -- screening, the liveness-masked mean (divide
  by the live count, not m) and the per-coordinate trimmed mean; an
  all-screened round falls back to the last good aggregate.
* wire-fault injection (:func:`corrupt_block`, :func:`corrupt_payload`).

Every masked path *selects* with ``torch.where`` and never multiplies
by a mask: 0 * NaN would re-poison the sum.  Machines lead every
tensor in the simulation; on the mesh a rank holds one machine's
block and :func:`gather_machines` stacks them.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from repro_torch.core import collectives
from repro_torch.core.compression import Compression, Payload
from repro_torch.device import require_device

# corruption codes carried in FaultPlan.corrupt
CORRUPT_NONE = 0
CORRUPT_NAN = 1
CORRUPT_INF = 2
CORRUPT_GARBAGE = 3

_CORRUPT_CODES = {"nan": CORRUPT_NAN, "inf": CORRUPT_INF, "garbage": CORRUPT_GARBAGE}
CORRUPT_MODES = (*_CORRUPT_CODES, "mix")

# magnitude of garbage corruption: finite, so only the envelope screen
# or the trimmed mean catches it
GARBAGE_MAGNITUDE = 1e12

# wire width of the per-round liveness mask on the dense masked path
LIVENESS_BITS = 32


class FaultPlan(NamedTuple):
    """Materialized per-machine, per-round fault outcomes: (m, rounds) leaves.

    ``live``: float32 1/0 (0: the machine's round-t uplink is dropped and
    its error-feedback carry untouched).  ``stale``: int32 requested
    staleness, clipped to the round loop's bound at use.  ``corrupt``:
    int32 ``CORRUPT_*`` code applied on the wire.
    """

    live: torch.Tensor
    stale: torch.Tensor
    corrupt: torch.Tensor

    @property
    def rounds(self) -> int:
        return self.live.shape[-1]

    def row(self, t: int):
        """Round-``t`` (1-indexed) slice: per-machine (live, stale, code)."""
        return self.live[..., t - 1], self.stale[..., t - 1], self.corrupt[..., t - 1]


class FaultSchedule(NamedTuple):
    """Seedable per-machine / per-round fault rates; :meth:`plan` draws the outcomes."""

    dropout: float = 0.0
    straggle: float = 0.0
    corrupt: float = 0.0
    corrupt_mode: str = "nan"
    seed: int = 0

    def validate(self) -> None:
        if self.corrupt_mode not in CORRUPT_MODES:
            raise ValueError(
                f"corrupt_mode must be one of {CORRUPT_MODES}, got {self.corrupt_mode!r}")
        for name, p in (("dropout", self.dropout), ("straggle", self.straggle),
                        ("corrupt", self.corrupt)):
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {p}")

    def plan(self, m: int, rounds: int, max_staleness: int = 1, *,
             device: str | torch.device = "cuda") -> FaultPlan:
        """Materialize the (m, rounds) outcomes on ``device``.

        Dropout, straggle and corruption are independent per cell;
        stragglers draw a staleness uniformly in [1, max_staleness].
        """
        self.validate()
        dev = require_device(device)
        gen = torch.Generator().manual_seed(self.seed)
        shape = (m, rounds)
        live = (torch.rand(shape, generator=gen) >= self.dropout).to(torch.float32)
        strag = torch.rand(shape, generator=gen) < self.straggle
        s = torch.randint(1, max(max_staleness, 1) + 1, shape, generator=gen)
        stale = torch.where(strag, s, 0).to(torch.int32)
        hit = torch.rand(shape, generator=gen) < self.corrupt
        if self.corrupt_mode == "mix":
            code = 1 + (torch.arange(m)[:, None] + torch.arange(rounds)[None, :]) % 3
        else:
            code = torch.full(shape, _CORRUPT_CODES[self.corrupt_mode])
        corrupt = torch.where(hit, code, CORRUPT_NONE).to(torch.int32)
        return FaultPlan(live.to(dev), stale.to(dev), corrupt.to(dev))


class Aggregation(NamedTuple):
    """Robust-aggregation policy: ``trim`` per-side fraction in [0, 0.5) (0: the masked mean),
    ``screen`` non-finite contributions, ``envelope`` an optional ceiling on |coordinate|."""

    trim: float = 0.0
    screen: bool = True
    envelope: float | None = None

    def validate(self) -> None:
        if not 0.0 <= self.trim < 0.5:
            raise ValueError(f"trim must be in [0, 0.5), got {self.trim}")
        if self.envelope is not None and not self.envelope > 0:
            raise ValueError(f"envelope must be positive, got {self.envelope}")


def _per_machine(code: torch.Tensor, x: torch.Tensor, trailing: int) -> torch.Tensor:
    """A (...,) per-machine code broadcast over the ``trailing`` axes of ``x``."""
    code = torch.as_tensor(code, device=x.device)
    return code.reshape(code.shape + (1,) * trailing)


def _garbage_like(x: torch.Tensor) -> torch.Tensor:
    """Deterministic finite garbage: +-GARBAGE_MAGNITUDE by row parity (axis -2)."""
    rows = torch.arange(x.shape[-2], device=x.device)
    sign = torch.where(rows % 2 == 0, 1.0, -1.0).to(torch.float32).unsqueeze(-1)
    return (GARBAGE_MAGNITUDE * sign * torch.ones_like(x, dtype=torch.float32)).to(x.dtype)


def corrupt_block(code: torch.Tensor, block: torch.Tensor) -> torch.Tensor:
    """Apply the per-machine corruption ``code`` (...,) to the (..., rows, K) ``block``."""
    c = _per_machine(code, block, 2)
    # Python scalars, never a tensor built from one: that is a copy to the device a call
    out = torch.where(c == CORRUPT_NAN, float("nan"), block)
    out = torch.where(c == CORRUPT_INF, float("inf"), out)
    return torch.where(c == CORRUPT_GARBAGE, _garbage_like(block), out)


def corrupt_payload(comp: Compression, code: torch.Tensor, payload: Payload) -> Payload:
    """Wire corruption of a compressed uplink: int8 corrupts the float32 scales (garbage
    inflates them by GARBAGE_MAGNITUDE), float modes the values, as :func:`corrupt_block`."""
    if comp.quantize == "int8":
        s = payload.scales
        c = _per_machine(code, s, 1)
        bad = torch.where(c == CORRUPT_NAN, torch.full_like(s, float("nan")), s)
        bad = torch.where(c == CORRUPT_INF, torch.full_like(s, float("inf")), bad)
        bad = torch.where(c == CORRUPT_GARBAGE, s * GARBAGE_MAGNITUDE, bad)
        return payload._replace(scales=bad)
    return payload._replace(values=corrupt_block(code, payload.values))


def screen_weight(agg: Aggregation, block: torch.Tensor) -> torch.Tensor:
    """Per-machine weight in {0., 1.} of a (..., d, K) block: 0 where any entry is non-finite
    (``agg.screen``) or beyond ``agg.envelope``; 1. when both checks are off."""
    ok = None
    if agg.screen:
        ok = torch.isfinite(block).all(-1).all(-1)
    if agg.envelope is not None:
        in_env = (block.abs() <= agg.envelope).all(-1).all(-1)
        ok = in_env if ok is None else ok & in_env
    if ok is None:
        return torch.ones(block.shape[:-2], dtype=block.dtype, device=block.device)
    return ok.to(block.dtype)


def masked_mean(stack: torch.Tensor, w: torch.Tensor):
    """Liveness-masked mean over the machine axis of an (m, d, K) stack: ``(mean, count)``.

    Zero-weight machines are selected out (never multiplied) and the
    divisor is the live count; with ``count == 0`` the mean is 0.
    """
    keep = (w > 0).reshape(w.shape + (1,) * (stack.ndim - 1))
    den = w.sum()
    num = torch.where(keep, stack, 0.0).sum(0)
    return num / den.clamp_min(1.0), den


def trimmed_mean(stack: torch.Tensor, w: torch.Tensor, trim: float):
    """Per-coordinate trimmed mean over the machine axis: ``(mean, live count)``.

    Dead or screened machines sort to the top as +inf and the rank mask
    drops them; the per-side cut floor(trim * m) shrinks to
    floor((live - 1) / 2) so at least one value survives.
    """
    m = stack.shape[0]
    keep = (w > 0).reshape(w.shape + (1,) * (stack.ndim - 1))
    srt = torch.sort(torch.where(keep, stack, float("inf")), dim=0).values
    den = w.sum()
    k_eff = torch.clamp(torch.floor((den - 1.0) / 2.0), 0, int(trim * m)).to(torch.int32)
    ranks = torch.arange(m, dtype=torch.int32, device=stack.device)
    mask = (ranks >= k_eff) & (ranks.to(torch.float32) < den - k_eff.to(torch.float32))
    mask = mask.reshape((m,) + (1,) * (stack.ndim - 1))
    count = den - 2.0 * k_eff.to(torch.float32)
    num = torch.where(mask, srt, 0.0).sum(0)
    return num / count.clamp_min(1.0), den


def select_anchor(history: Sequence[torch.Tensor], stale: torch.Tensor, t: int,
                  bound: int) -> torch.Tensor:
    """Per-machine round-``t`` anchor under bounded staleness.

    ``history[j - 1]`` is the round-j anchor: (m, d, K) with (m,)
    ``stale`` in the simulation, one machine's (d, K) with a scalar
    ``stale`` on the mesh.  A straggler with requested staleness s
    anchors at round t - s_eff, s_eff clipped into [0, min(t - 1, bound)].
    """
    stacked = torch.stack(list(history)[:t])  # (t, [m,] d, K)
    idx = (t - 1) - torch.clamp(stale, 0, min(t - 1, bound))
    if stacked.ndim == 3:  # mesh: one machine's scalar request
        return stacked[idx.long()]
    return stacked[idx.long(), torch.arange(stacked.shape[1], device=stacked.device)]


def gather_machines(x: torch.Tensor, data_axes: Sequence) -> torch.Tensor:
    """Machine-stack ``x`` over the data axes: (...) -> (m, ...).

    The mesh twin of the simulation's machine axis, for the trimmed mean
    (every machine's block) and the masked compressed path (the
    liveness weights beside the payload); rows in machine order,
    row-major over ``("pod", "data")``.
    """
    return collectives.all_gather_stack(x, data_axes)
