"""Top-k error-feedback compressed uplinks with exact bit accounting (twin of ``repro.core.compression``).

The codec, per machine, per round, per direction column:

* **Selection** is top-k on the delta ``|u - ref|``, where ``u =
  message + residual`` and ``ref`` is the round's shared reference (the
  previous received aggregate; zeros in round 1).  Ties go to the lower
  row index, as ``lax.top_k`` orders them: a stable descending sort
  keeps that order, where ``torch.topk`` promises none, so the indices
  on the wire equal the reference's exactly.
* **Transmission** sends the absolute values ``u[idx]`` and the
  receiver *sets* them into ``ref``, so ``k_top = d`` in float32 is the
  identity codec bit for bit.  int8 quantizes the selected *deltas*
  (one float32 scale per column, ``round`` half to even, a true
  division by the scale) and the receiver *adds* them.
* **Error feedback**: the residual ``u - decode(payload)`` rides into
  the next round's message.
* **Bit accounting** (:func:`uplink_bits` / :func:`dense_uplink_bits`):
  what one machine puts on the wire, at the wire dtypes; integer
  arithmetic equal to the reference's.

Machines lead every tensor: a payload's leaves are (..., k_top, K)
(scales (..., K)) and decode against a shared (d, K) reference gives
(..., d, K).  On the mesh, :func:`gather_payloads` moves each
machine's payload across the data axes at its wire dtypes and
:func:`sparse_mean_mesh` reconstructs the mean from it on every rank.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from repro_torch.core import collectives

# wire width of one transmitted value, per quantization mode
QUANTIZE_MODES = {None: 32, "bf16": 16, "int8": 8}
# int8 mode ships one float32 scale per direction column
SCALE_BITS = 32


def wire_index_dtype(d: int) -> torch.dtype:
    """The narrowest integer dtype for row indices [0, d): int16 up to d = 32767, else int32."""
    return torch.int16 if d <= torch.iinfo(torch.int16).max else torch.int32


def index_bits(d: int) -> int:
    """Wire width of one transmitted row index (see :func:`wire_index_dtype`)."""
    return torch.iinfo(wire_index_dtype(d)).bits


class Compression(NamedTuple):
    """Static description of the per-round codec.

    ``k_top``: coordinates kept per direction column (1 <= k_top <= d;
    ``d`` is the identity codec).  ``quantize``: ``None`` (float32
    absolute values), ``"bf16"`` (bfloat16 absolute values) or
    ``"int8"`` (8-bit symmetric per-column delta quantization).
    """

    k_top: int
    quantize: str | None = None

    def validate(self, d: int) -> None:
        if self.quantize not in QUANTIZE_MODES:
            raise ValueError(
                f"quantize must be one of {sorted(map(str, QUANTIZE_MODES))}, "
                f"got {self.quantize!r}")
        if not 1 <= self.k_top <= d:
            raise ValueError(f"k_top must be in [1, d={d}], got {self.k_top}")


class Payload(NamedTuple):
    """One machine's (or a machine stack's) per-round uplink, at wire dtypes."""

    values: torch.Tensor  # (..., k_top, K) float32 | bfloat16 | int8
    indices: torch.Tensor  # (..., k_top, K) int16/int32 row indices into [0, d)
    scales: torch.Tensor | None  # (..., K) float32, int8 mode only


def wire_value_dtype(comp: Compression) -> torch.dtype:
    """The dtype the value payload travels as."""
    return {None: torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}[comp.quantize]


def uplink_bits(comp: Compression, d: int, num_cols: int) -> int:
    """Bits ONE machine puts on the wire in ONE compressed round.

    values (k_top, K) at the wire width + indices (k_top, K) at
    :func:`index_bits` [+ the (K,) float32 scales in int8 mode].
    """
    comp.validate(d)
    bits = comp.k_top * num_cols * (QUANTIZE_MODES[comp.quantize] + index_bits(d))
    if comp.quantize == "int8":
        bits += num_cols * SCALE_BITS
    return bits


def dense_uplink_bits(d: int, num_cols: int) -> int:
    """Bits one machine moves per dense round: the (d, K) float32 mean."""
    return d * num_cols * 32


def compression_ratio(comp: Compression, d: int, num_cols: int) -> float:
    """Compressed / dense per-round uplink bits (< 1 means smaller)."""
    return uplink_bits(comp, d, num_cols) / dense_uplink_bits(d, num_cols)


def encode(comp: Compression, u: torch.Tensor, ref: torch.Tensor) -> Payload:
    """Select the top-k of ``|u - ref|`` per column and emit wire values.

    ``u`` is (..., d, K) float32 and ``ref`` broadcasts against it.
    float32/bf16 transmit the absolute ``u`` at the selected rows; int8
    quantizes the selected deltas.
    """
    d = u.shape[-2]
    comp.validate(d)
    delta = u - ref
    # stable descending sort: equal magnitudes keep the lower row first,
    # as lax.top_k does (NaN sorts first in both)
    idx = torch.sort(delta.abs(), dim=-2, descending=True, stable=True).indices[..., :comp.k_top, :]
    wire_idx = idx.to(wire_index_dtype(d))
    if comp.quantize == "int8":
        dvals = torch.take_along_dim(delta, idx, dim=-2)  # (..., k_top, K)
        amax = dvals.abs().amax(-2)  # (..., K)
        scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax)).to(torch.float32)
        # a true division: a multiplication by 1/scale moves codes at the halves
        q = torch.clamp(torch.round(dvals / scale.unsqueeze(-2)), -127, 127)
        return Payload(q.to(torch.int8), wire_idx, scale)
    vals = torch.take_along_dim(u, idx, dim=-2)
    return Payload(vals.to(wire_value_dtype(comp)), wire_idx, None)


def decode(comp: Compression, payload: Payload, ref: torch.Tensor, *,
           screen_nonfinite: bool = True) -> torch.Tensor:
    """The dense (..., d, K) reconstruction against ``ref``.

    Float modes *set* the selected rows to the transmitted values (the
    identity codec reproduces the encoded block bit for bit); int8 adds
    the dequantized deltas.  ``screen_nonfinite`` puts ``ref`` back
    where the reconstruction is not finite (a NaN scale would otherwise
    poison the aggregate); the masked aggregation of the rounds decodes
    raw so its per-machine screen sees the poison.
    """
    rows = payload.indices.long()  # widen off the wire for the scatter
    shape = torch.broadcast_shapes(rows.shape[:-2] + ref.shape[-2:], ref.shape)
    base = ref.expand(shape)
    if comp.quantize == "int8":
        deltas = payload.values.to(torch.float32) * payload.scales.unsqueeze(-2)
        out = base + torch.zeros_like(base).scatter_add(-2, rows, deltas)
    else:
        out = base.scatter(-2, rows, payload.values.to(torch.float32))
    if screen_nonfinite:
        out = torch.where(torch.isfinite(out), out, base)
    return out


def ef_step(comp: Compression, message: torch.Tensor, residual: torch.Tensor,
            ref: torch.Tensor) -> tuple[Payload, torch.Tensor]:
    """One error-feedback step: encode ``message + residual``; the new residual is what the
    receiver will not see (the unselected delta and any quantization error)."""
    u = message + residual
    payload = encode(comp, u, ref)
    return payload, u - decode(comp, payload, ref)


def decode_stack(comp: Compression, payloads: Payload, ref: torch.Tensor, *,
                 screen_nonfinite: bool = True) -> torch.Tensor:
    """Every machine's reconstruction against the shared reference: (m, k_top, K) -> (m, d, K)."""
    return decode(comp, payloads, ref, screen_nonfinite=screen_nonfinite)


def decode_mean(comp: Compression, payloads: Payload, ref: torch.Tensor) -> torch.Tensor:
    """Mean over machines of the reconstructions: the dense path's mean, so the identity
    codec keeps it bit for bit."""
    return decode_stack(comp, payloads, ref).mean(0)


def gather_payloads(comp: Compression, payload: Payload, data_axes: Sequence) -> Payload:
    """Gather one machine's payload leaves over the data axes: (m, ...) leaves.

    The only data a compressed round moves between machines, at the
    wire dtypes (int8 values and float32 scales in int8 mode; int16
    indices as their bytes, see :mod:`repro_torch.core.collectives`).
    """
    return Payload(collectives.all_gather_stack(payload.values, data_axes),
                   collectives.all_gather_stack(payload.indices, data_axes),
                   collectives.all_gather_stack(payload.scales, data_axes)
                   if comp.quantize == "int8" else None)


def sparse_mean_mesh(comp: Compression, payload: Payload, ref: torch.Tensor,
                     data_axes: Sequence) -> torch.Tensor:
    """The compressed round's aggregate on the mesh: the payload gather, then every rank's
    :func:`decode_mean` of it (replicated (d, K))."""
    return decode_mean(comp, gather_payloads(comp, payload, data_axes), ref)
