"""Multi-round refinement around the master's aggregate (twin of ``repro.core.rounds``).

With anchor_1 = beta_hat (each machine's local estimate), every round
t = 1..T is the same closed-form map

    beta_tilde_t^i = anchor_t^i - Theta_i^T (Sigma_i anchor_t^i - rhs_i)
    beta_bar_t     = mean_i beta_tilde_t^i
    anchor_{t+1}^i = beta_bar_t

so T = 1 is the paper's one-shot estimator, bit for bit (the same
products as :func:`repro_torch.core.pipeline.worker_debiased` and the
same machine mean).  A round reuses the machines' one factorization and
both solves (:class:`~repro_torch.core.pipeline.WorkerSolves`): two
(d, d) x (d, K) products per machine, no eigendecomposition, no ADMM.

The round body is written once, :func:`_refinement_rounds`;
:class:`_SimRound` supplies the machine-axis operations of the
simulation, :class:`_MeshRound` the collectives of one rank of the mesh
(:func:`worker_rounds`), as the reference's twins do.  It threads the uplink/downlink codecs,
fault injection, screening, masked and trimmed aggregation, bounded
staleness and the last-good fallback of
:mod:`repro_torch.core.compression`, :mod:`repro_torch.core.faults`
and :mod:`repro_torch.core.transport`.  Every tensor stays on the
device of the solves.

``collect_info=True`` runs both solves through the full dispatched
result, so the returned solves carry warm rho, ADMM states and
executed iterations; passing them back resumes each solve (K3 with
``cfg.tol``).
"""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch import obs
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
from repro_torch.core import compression as compression_core
from repro_torch.core import faults as faults_core
from repro_torch.core import pipeline
from repro_torch.core import transport as transport_core
from repro_torch.core.compression import Compression
from repro_torch.core.dantzig import DantzigConfig
from repro_torch.core.faults import Aggregation, FaultPlan, FaultSchedule
from repro_torch.core.pipeline import WorkerSolves
from repro_torch.core.transport import CommPlan, Transport, TransportState, resolve_comm
from repro_torch.kernels.dantzig_fused import AdmmState

# the spans of one refinement round and of its aggregation (the screen, the masked, trimmed or
# dense mean and the last-good select), inside ``repro_torch.rounds``; their counts are the
# rounds and the aggregates a call executed
ROUND_SPAN = "repro_torch.rounds.round"
AGGREGATE_SPAN = "repro_torch.rounds.aggregate"


def refine_step(ws: WorkerSolves, anchor: torch.Tensor, model_axis=None) -> torch.Tensor:
    """Every machine's closed-form debias correction around ``anchor`` (..., d, K):
    ``anchor - Theta^T (Sigma anchor - rhs)``; a sharded CLIME block (``model_axis``)
    reassembles through the masked gather of the one-shot path."""
    resid = ws.stats.sigma @ anchor - ws.stats.rhs
    return anchor - pipeline.apply_correction(ws.theta, ws.valid, resid, model_axis)


class _MeshRound:
    """One rank's view of a round: it holds one machine, collectives aggregate."""

    def __init__(self, ws: WorkerSolves, model_axis, data_axes: Sequence):
        self.ws = ws
        self.model_axis = model_axis
        self.data_axes = tuple(data_axes)
        self.m = collectives.machine_count(self.data_axes)

    def correction(self, anchor):
        return refine_step(self.ws, anchor, self.model_axis)

    def mean(self, x):
        return collectives.all_reduce_sum(x, self.data_axes) / self.m

    def sum(self, x):
        return collectives.all_reduce_sum(x, self.data_axes)

    def stack(self, x):
        return faults_core.gather_machines(x, self.data_axes)

    def expand(self, w):
        return w  # this machine's scalar weight broadcasts against (d, K)

    def corrupt(self, code, block):
        return faults_core.corrupt_block(code, block)

    def screen(self, agg, block):
        return faults_core.screen_weight(agg, block)

    def broadcast(self, bar):
        return bar  # already this rank's replicated copy

    def agg_zeros(self, anchor):
        return torch.zeros_like(anchor)

    def ef(self, comp, message, resid, ref):
        return compression_core.ef_step(comp, message, resid, ref)

    def corrupt_payload(self, comp, code, payload):
        return faults_core.corrupt_payload(comp, code, payload)

    def sparse_mean(self, comp, payload, ref):
        return compression_core.sparse_mean_mesh(comp, payload, ref, self.data_axes)

    def stack_payload(self, comp, payload):
        return compression_core.gather_payloads(comp, payload, self.data_axes)

    def downlink_wire(self, comp, payload, code):
        """The aggregator's broadcast: ``code`` is this rank's corruption code, and only the
        master's survives the master-masked sum, so every receiver reads the same wire."""
        if code is not None:
            payload = faults_core.corrupt_payload(comp, code, payload)
        return transport_core.psum_broadcast(payload, self.data_axes)


class _SimRound:
    """Machines are the leading axis; the round's reductions are local."""

    def __init__(self, ws: WorkerSolves):
        self.ws = ws
        self.m = ws.beta_hat.shape[0]

    def correction(self, anchor):
        return refine_step(self.ws, anchor)

    def mean(self, x):
        return x.mean(0)  # the round's one "pmean"

    def sum(self, x):
        return x.sum(0)

    def stack(self, x):
        return x  # the machine axis is already there

    def expand(self, w):
        return w.reshape(w.shape + (1, 1))

    def corrupt(self, code, block):
        return faults_core.corrupt_block(code, block)

    def screen(self, agg, block):
        return faults_core.screen_weight(agg, block)

    def broadcast(self, bar):
        return bar.expand(self.m, *bar.shape)

    def agg_zeros(self, anchor):
        return torch.zeros(anchor.shape[1:], dtype=anchor.dtype, device=anchor.device)

    def ef(self, comp, message, resid, ref):
        return compression_core.ef_step(comp, message, resid, ref)

    def corrupt_payload(self, comp, code, payload):
        return faults_core.corrupt_payload(comp, code, payload)

    def sparse_mean(self, comp, payload, ref):
        return compression_core.decode_mean(comp, payload, ref)

    def stack_payload(self, comp, payload):
        return payload

    def downlink_wire(self, comp, payload, code):
        """Machine 0 is the aggregator: its fault row corrupts the wire."""
        if code is not None:
            payload = faults_core.corrupt_payload(comp, code[0], payload)
        return payload


def _refinement_rounds(drv, *, rounds: int, anchor: torch.Tensor, transport: Transport,
                       plan: FaultPlan | None = None, state: TransportState | None = None,
                       ref: torch.Tensor | None = None, return_all_rounds: bool = False):
    """The one T-round body.

    With a default plan (no codecs, no faults, no aggregation) a round
    is exactly the machine mean of the corrections.  ``ref`` seeds the
    shared delta reference on re-entry (None: zeros, round 1).  The
    downlink close: the aggregator EF-encodes the aggregate against
    ``ref``, the payload crosses the wire (where corruption can hit
    it), and every machine screens the same decoded block; a poisoned
    round rolls every machine back to ``ref`` and drops the
    aggregator's residual.

    Returns ``(bar or the (T, d, K) trajectory, final TransportState)``.
    """
    with obs.span("repro_torch.rounds"):
        aggregation = transport.aggregation
        staleness = transport.staleness
        masked = aggregation is not None
        faulted = plan is not None
        if masked:
            aggregation.validate()
            last_good = drv.agg_zeros(anchor)
        resid = state.up_residual if state is not None else None
        down_resid = state.down_residual if state is not None else None
        if transport.any_up and resid is None:
            resid = torch.zeros_like(anchor)
        if transport.any_down and down_resid is None:
            down_resid = drv.agg_zeros(anchor)
        if (transport.any_up or transport.any_down) and ref is None:
            ref = drv.agg_zeros(anchor)
        history = [anchor]  # entry j-1 = the round-j anchor
        bars = []
        # the one-shot round (T = 1, the default plan) is the paper's estimator, no refinement
        # round: it opens neither round span
        marked = rounds > 1 or masked or faulted or transport.any_up or transport.any_down
        for t in range(1, rounds + 1):
            with obs.span(ROUND_SPAN, marked):
                compression = transport.up(t).comp
                live = code = None
                if faulted:
                    live, stale, code = plan.row(t)
                a = history[-1]
                if faulted and staleness > 0 and t > 1:
                    a = faults_core.select_anchor(history, stale, t, staleness)
                beta_tilde = drv.correction(a)
                if compression is None:
                    wire = drv.corrupt(code, beta_tilde) if faulted else beta_tilde
                    with obs.span(AGGREGATE_SPAN, marked):
                        if not masked and not faulted:
                            bar = drv.mean(wire)  # the one-shot round, bit for bit
                        elif not masked:
                            # the fragile baseline: a dropped machine adds zeros, the
                            # divisor stays m, corrupt payloads reach the mean
                            bar = drv.mean(torch.where(drv.expand(live) > 0, wire, 0.0))
                        else:
                            w = drv.screen(aggregation, wire)
                            if faulted:
                                w = live * w
                            if aggregation.trim > 0:
                                bar, den = faults_core.trimmed_mean(drv.stack(wire), drv.stack(w),
                                                                    aggregation.trim)
                            else:
                                # select, never multiply: 0 * NaN would re-poison the sum
                                num = drv.sum(torch.where(drv.expand(w) > 0, wire, 0.0))
                                den = drv.sum(w)
                                bar = num / den.clamp_min(1.0)
                            bar = torch.where(den > 0, bar, last_good)
                else:
                    payload, new_resid = drv.ef(compression, beta_tilde, resid, ref)
                    if faulted:
                        # a dropped machine computed nothing: its carry is untouched;
                        # corruption hits the wire, after the honest residual update
                        resid = torch.where(drv.expand(live) > 0, new_resid, resid)
                        payload = drv.corrupt_payload(compression, code, payload)
                    else:
                        resid = new_resid
                    with obs.span(AGGREGATE_SPAN, marked):
                        if not masked and not faulted:
                            bar = drv.sparse_mean(compression, payload, ref)
                        else:
                            stacked = drv.stack_payload(compression, payload)
                            w_live = drv.stack(live) if faulted else None
                            if masked:
                                # decode raw: the screen must see the poison to zero the machine
                                dense = compression_core.decode_stack(compression, stacked, ref,
                                                                      screen_nonfinite=False)
                                w = faults_core.screen_weight(aggregation, dense)
                                if w_live is not None:
                                    w = w_live * w
                                if aggregation.trim > 0:
                                    bar, den = faults_core.trimmed_mean(dense, w, aggregation.trim)
                                else:
                                    bar, den = faults_core.masked_mean(dense, w)
                                bar = torch.where(den > 0, bar, last_good)
                            else:
                                # fragile baseline: a dropped machine's payload decodes to the
                                # reference, still diluting the mean by the full m
                                dense = compression_core.decode_stack(compression, stacked, ref)
                                keep = (w_live > 0).reshape(w_live.shape + (1, 1))
                                bar = torch.where(keep, dense, ref).mean(0)
                # the downlink close: the aggregate back down the wire, EF-compressed
                # against the same reference
                down = transport.down(t)
                if down.compressed:
                    u = bar + down_resid
                    payload = down.encode(u, ref)
                    wire = drv.downlink_wire(down.comp, payload, code)
                    decoded = down.decode(wire, ref, screen_nonfinite=False)
                    ok = torch.isfinite(decoded).all()
                    honest = down.decode(payload, ref, screen_nonfinite=False)
                    # rejected: drop the carry, the rolled-back anchors regenerate the step
                    down_resid = torch.where(ok, u - honest, torch.zeros_like(u))
                    bar = torch.where(ok, decoded, ref)
                if transport.any_up or transport.any_down:
                    ref = bar  # the received aggregate seeds both wires' deltas
                if masked:
                    last_good = bar
                bars.append(bar)
                history.append(drv.broadcast(bar))
        out = torch.stack(bars) if return_all_rounds else bars[-1]
        return out, TransportState(resid if transport.any_up else None,
                                   down_resid if transport.any_down else None)


def _check_plan(faults, expect_shape, where: str) -> None:
    if faults is None:
        return
    if isinstance(faults, FaultSchedule):
        raise TypeError(
            f"{where} takes a materialized FaultPlan (FaultSchedule.plan(m, rounds, "
            "staleness)); got a schedule")
    if tuple(faults.live.shape) != tuple(expect_shape):
        raise ValueError(f"{where}: FaultPlan leaves must be {tuple(expect_shape)}, got "
                         f"{tuple(faults.live.shape)}")


@trace_contract(
    "rounds.worker_rounds",
    contracts=(
        # refinement rounds reuse the round-one SpectralFactor
        PrimitiveBudget("eigh", exact=1),
        # the DENSE uplink: one (d, K) f32 psum per dense round over the
        # data axis -- count AND payload are pinned (0 when compressed:
        # a compressed call must hold NO dense data-axis psum at all)
        CollectiveContract("psum", count=Param("dense_psums"), axis="data",
                           shape=Param("psum_payload"), dtype="float32"),
        # the liveness mask of DESIGN.md §11: one scalar f32 psum (the
        # live count) per masked dense round, nothing on the legacy path
        CollectiveContract("psum", count=Param("live_psums"), axis="data",
                           shape=(), dtype="float32"),
        PrimitiveBudget("psum", exact=Param("total_psums")),
        # intra-machine CLIME reassembly: one model-axis gather per round
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
def worker_rounds(head, *data: torch.Tensor, lam, lam_prime, rounds: int = 1,
                  cfg: DantzigConfig = DantzigConfig(), data_axes: Sequence = (),
                  model_axis=None, model_axis_size: int = 1, comm: CommPlan | None = None,
                  compression: Compression | None = None,
                  ef_residual: torch.Tensor | None = None,
                  down_residual: torch.Tensor | None = None,
                  resume_from: torch.Tensor | None = None, faults: FaultPlan | None = None,
                  staleness: int = 0, aggregation: Aggregation | None = None,
                  rho_beta=None, rho_theta=None, state_beta: AdmmState | None = None,
                  state_theta: AdmmState | None = None, collect_info: bool = False,
                  return_ef_residual: bool = False, return_transport_state: bool = False):
    """The T-round refined aggregate on one rank of the mesh.

    ``data`` is this rank's machine's samples; ``data_axes`` are the
    mesh's data axes (:class:`~repro_torch.core.collectives.Axis`) and
    ``model_axis`` its model axis (None: this rank solves every CLIME
    column).  Runs
    :func:`~repro_torch.core.pipeline.worker_solves` once (warm from the
    ``rho_*`` / ``state_*`` carries of an earlier call's solves), then
    ``rounds`` closed-form rounds whose means are collectives over the
    data axes.  ``comm`` (or the separate ``compression`` /
    ``staleness`` / ``aggregation``) configures the wire;
    ``comm.faults`` must be None: the faces materialize the schedule and
    pass this machine's row as ``faults`` ((rounds,) leaves).
    ``resume_from`` re-enters a round stream with the carried residuals.

    Every argument is checked before the solves.  Returns
    ``(beta_bar, solves)``: the replicated (d, K) aggregate, before the
    hard threshold, and this rank's solves; ``return_ef_residual``
    appends the uplink residual and ``return_transport_state`` the
    :class:`~repro_torch.core.transport.TransportState`.
    """
    comm, faults = _round_plan(None, rounds, comm, compression, faults, staleness, aggregation,
                               None, "worker_rounds")
    ws = pipeline.worker_solves(head, *data, lam=lam, lam_prime=lam_prime, cfg=cfg,
                                model_axis=model_axis, model_axis_size=model_axis_size,
                                rho_beta=rho_beta, rho_theta=rho_theta, state_beta=state_beta,
                                state_theta=state_theta, full=collect_info)
    anchor = ws.beta_hat if resume_from is None else resume_from
    tr = Transport(comm, anchor.shape[0], anchor.shape[1], rounds)
    anchor, tstate = _refinement_rounds(
        _MeshRound(ws, model_axis, data_axes), rounds=rounds, anchor=anchor, transport=tr,
        plan=faults, state=TransportState(ef_residual, down_residual), ref=resume_from)
    out = [anchor, ws]
    if return_ef_residual:
        out.append(tstate.up_residual)
    if return_transport_state:
        out.append(tstate)
    return tuple(out)


def _round_plan(m: int | None, rounds: int, comm, compression, faults, staleness,
                aggregation, dev: torch.device | None, where: str):
    """The checked round arguments, before any solve: ``(comm, plan)``.

    The one copy of the rules that the simulated faces, the mesh faces
    and :func:`worker_rounds` share.  For ``m`` machines a schedule (in
    ``faults`` or ``comm.faults``) is materialized on ``dev`` to an
    (m, rounds) plan; ``m`` None is one mesh rank, which takes only its
    machine's materialized (rounds,) row.  The returned comm carries no
    faults: the plan goes beside it.
    """
    if rounds < 1:
        raise ValueError(f"rounds must be >= 1, got {rounds}")
    if comm is not None and isinstance(faults, FaultSchedule):
        raise TypeError(
            f"{where}: pass the fault schedule inside comm=CommPlan(faults=...), "
            "not alongside it (a materialized FaultPlan may ride next to comm)")
    comm = resolve_comm(comm, compression=compression, staleness=staleness,
                        aggregation=aggregation, where=where)
    plan = faults if faults is not None else comm.faults
    if m is None:
        if comm.faults is not None:
            raise TypeError(
                f"{where}: CommPlan.faults is a schedule -- the faces materialize it; pass "
                "this machine's FaultPlan row via faults=")
        _check_plan(plan, (rounds,), where)
    else:
        if isinstance(plan, FaultSchedule):
            plan = plan.plan(m, rounds, max(comm.staleness, 1), device=dev)
        _check_plan(plan, (m, rounds), where)
    return comm._replace(faults=None), plan


def simulate_round_loop(ws: WorkerSolves, *, rounds: int, comm: CommPlan | None = None,
                        compression: Compression | None = None,
                        ef_residual: torch.Tensor | None = None,
                        down_residual: torch.Tensor | None = None,
                        resume_from: torch.Tensor | None = None,
                        faults: FaultPlan | FaultSchedule | None = None, staleness: int = 0,
                        aggregation: Aggregation | None = None,
                        return_all_rounds: bool = False, return_ef_residual: bool = False,
                        return_transport_state: bool = False):
    """The T refinement rounds alone, on machine-stacked solves ``ws``.

    One set of per-machine solves (the expensive part) drives any
    number of round schedules.  ``comm`` is the one
    :class:`~repro_torch.core.transport.CommPlan` (its fault schedule is
    materialized here against m); the separate ``compression`` /
    ``faults`` / ``staleness`` / ``aggregation`` arguments pack into
    one, and ``faults`` also takes a materialized
    :class:`~repro_torch.core.faults.FaultPlan` ((m, rounds) leaves).
    ``resume_from`` re-enters a round stream: it seeds the round-1
    anchor and the shared delta reference with the previous received
    aggregate.

    Returns ``beta_bar`` (d, K), or the (rounds, d, K) trajectory with
    ``return_all_rounds``; ``return_ef_residual`` appends the final
    (m, d, K) uplink residual and ``return_transport_state`` the
    :class:`~repro_torch.core.transport.TransportState`.
    """
    drv = _SimRound(ws)
    comm, plan = _round_plan(drv.m, rounds, comm, compression, faults, staleness,
                             aggregation, ws.beta_hat.device, "simulate_round_loop")
    anchor = ws.beta_hat if resume_from is None else drv.broadcast(resume_from)
    tr = Transport(comm, anchor.shape[1], anchor.shape[2], rounds)
    out, tstate = _refinement_rounds(drv, rounds=rounds, anchor=anchor, transport=tr,
                                     plan=plan, state=TransportState(ef_residual, down_residual),
                                     ref=resume_from, return_all_rounds=return_all_rounds)
    res = [out]
    if return_ef_residual:
        res.append(tstate.up_residual)
    if return_transport_state:
        res.append(tstate)
    return tuple(res) if len(res) > 1 else out


def simulate_multi_round(head, data: Sequence[torch.Tensor], *, lam, lam_prime,
                         rounds: int = 1, cfg: DantzigConfig = DantzigConfig(),
                         comm: CommPlan | None = None, compression: Compression | None = None,
                         ef_residual: torch.Tensor | None = None,
                         faults: FaultPlan | FaultSchedule | None = None, staleness: int = 0,
                         aggregation: Aggregation | None = None, rho_beta=None, rho_theta=None,
                         state_beta: AdmmState | None = None,
                         state_theta: AdmmState | None = None, collect_info: bool = False,
                         return_all_rounds: bool = False) -> tuple[torch.Tensor, WorkerSolves]:
    """The machines' solves (one batch, one ``eigh``), then :func:`simulate_round_loop`.

    ``data`` holds the head's samples with machines on the leading axis
    (``(xs, ys)`` for the binary head, ``(xs, labels)`` for the K-class
    one).  Warm carries are the (m, ...) fields of a previous call's
    returned :class:`~repro_torch.core.pipeline.WorkerSolves`
    (``collect_info=True`` fills them).  Every argument is checked
    before the solves.  Returns ``(beta_bar, solves)`` with
    ``beta_bar`` (d, K), or (rounds, d, K) with ``return_all_rounds``.
    """
    comm, plan = _round_plan(data[0].shape[0], rounds, comm, compression, faults, staleness,
                             aggregation, data[0].device, "simulate_multi_round")
    ws = pipeline.worker_solves(head, *data, lam=lam, lam_prime=lam_prime, cfg=cfg,
                                rho_beta=rho_beta, rho_theta=rho_theta, state_beta=state_beta,
                                state_theta=state_theta, full=collect_info)
    out = simulate_round_loop(ws, rounds=rounds, comm=comm, ef_residual=ef_residual,
                              faults=plan, return_all_rounds=return_all_rounds)
    return out, ws
