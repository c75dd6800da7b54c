"""Representative calls for every contracted entry point (twin of ``repro.analysis.cases``).

Each case builds ``(fn, args)`` for :func:`~repro_torch.analysis.counts.count_ops`
plus the params dict that resolves the entry's
:class:`~repro_torch.analysis.contracts.Param` placeholders: the same
entries, case names and params as the reference's, with one more key,
``gram_launches``, the K1 launches of the statistics on the card (the
reference's CPU trace never reaches its gram kernel).  Inputs are drawn
from numpy seeds; the counts do not depend on the draw.

An in-process case's ``build(device)`` puts its inputs on ``device``.
A mesh case (``mesh=(data, model)``) runs on every rank of a spawned
mesh (:func:`repro_torch.launch.mesh.run_on_mesh`, gloo):
:func:`run_mesh_cases` builds it there with ``build(mesh)``, counts it
on each rank and hands rank 0 every rank's counts.

Importing this module imports the core entry points, which is what
populates the contract registry.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.analysis.counts import count_ops
from repro_torch.core import compression as compression_core
from repro_torch.core import path as rpath
from repro_torch.core import pipeline, rounds, streaming
from repro_torch.core import transport as transport_core
from repro_torch.core.compression import Compression
from repro_torch.core.dantzig import DantzigConfig
from repro_torch.core.distributed import (
    distributed_mc_slda_shardmap,
    distributed_slda_shardmap,
    rank_view,
)
from repro_torch.core.faults import Aggregation, FaultPlan, FaultSchedule
from repro_torch.core.solver_dispatch import solve_dantzig_full
from repro_torch.kernels.spectral import spectral_factor


class Case(NamedTuple):
    entry: str
    name: str
    params: dict
    build: Callable  # in process: build(device); on a mesh: build(mesh) -> (fn, args)
    mesh: Optional[Tuple[int, int]] = None  # (data, model) ranks; None: in process


_CASES: Dict[str, List[Case]] = {}


def case(entry: str, name: str, params: dict, *, mesh: Optional[Tuple[int, int]] = None):
    def register(build):
        _CASES.setdefault(entry, []).append(Case(entry, name, dict(params), build, mesh))
        return build
    return register


def cases_for(entry: str) -> List[Case]:
    return list(_CASES.get(entry, []))


def all_cases() -> Dict[str, List[Case]]:
    return {k: list(v) for k, v in _CASES.items()}


def _normal(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _labels(seed: int, n: int, num_classes: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, num_classes, n)


def _spd(d: int, seed: int, device="cuda") -> torch.Tensor:
    g = torch.from_numpy(_normal(seed, (2 * d, d))).to(device)
    return g.mT @ g / (2 * d) + 0.5 * torch.eye(d, device=device)


def _on(*arrays, device="cuda"):
    return tuple(torch.from_numpy(a).to(device) for a in arrays)


SCAN = DantzigConfig(max_iters=40, adapt_rho=False)
FUSED = DantzigConfig(max_iters=40, adapt_rho=False, fused=True)
FUSED_TOL = DantzigConfig(max_iters=40, adapt_rho=False, fused=True, tol=1e-3)

# K1 launches of one binary head's statistics on the card (both classes)
BINARY_GRAMS = 2


# ---------------------------------------------------------------------------
# pipeline.worker_debiased
# ---------------------------------------------------------------------------

def _worker_debiased_case(cfg):
    def build(device="cuda"):
        def fn(x, y):
            return pipeline.worker_debiased(pipeline.BinaryHead(), x, y, lam=0.1,
                                            lam_prime=0.1, cfg=cfg)
        return fn, _on(_normal(0, (40, 12)), _normal(1, (44, 12)), device=device)
    return build


case("pipeline.worker_debiased", "binary-scan-d12",
     {"pallas_calls": 0, "gram_launches": BINARY_GRAMS})(_worker_debiased_case(SCAN))
case("pipeline.worker_debiased", "binary-fused-d12",
     {"pallas_calls": 2, "gram_launches": BINARY_GRAMS})(_worker_debiased_case(FUSED))
case("pipeline.worker_debiased", "binary-fused-tol-d12",
     {"pallas_calls": 2, "gram_launches": BINARY_GRAMS})(_worker_debiased_case(FUSED_TOL))


@case("pipeline.worker_debiased", "multiclass-fused-d10-K3",
      {"pallas_calls": 2, "gram_launches": 0})
def _worker_debiased_mc(device="cuda"):
    def fn(x, labels):
        return pipeline.worker_debiased(pipeline.MulticlassHead(3), x, labels, lam=0.1,
                                        lam_prime=0.1, cfg=FUSED)
    return fn, _on(_normal(2, (60, 10)), _labels(3, 60, 3), device=device)


# ---------------------------------------------------------------------------
# rounds.worker_rounds (on one rank of a (1, 1) mesh)
# ---------------------------------------------------------------------------

def _comm_params(comm, t_rounds, d, num_cols, extra_bits=0):
    """Collective counts + per-direction exact bits for a fault-free, unmasked
    :class:`~repro_torch.core.transport.CommPlan` (the reference's accounting).

    Walks the resolved :class:`~repro_torch.core.transport.Transport`
    round by round (a :class:`~repro_torch.core.transport.BitBudget`
    schedule changes codecs per round): a dense uplink is one (d, K) f32
    psum; a compressed uplink is 2 payload all_gathers (3 with int8
    scales) + 2 decode-sanitize is_finite; a compressed downlink is 2
    payload psums (3 with int8 scales) + ONE whole-block receiver screen
    (a dense downlink never touches the wire -- the aggregate is already
    replicated).  ``extra_bits`` covers one-off psum payloads like the
    K-class means.
    """
    tr = transport_core.Transport(comm, d, num_cols, t_rounds)
    dense_psums = down_psums = data_gathers = screen_ops = 0
    gather_bits, psum_bits = 0, extra_bits
    for t in range(1, t_rounds + 1):
        up, down = tr.up(t), tr.down(t)
        if up.compressed:
            data_gathers += 3 if up.comp.quantize == "int8" else 2
            gather_bits += up.bits(d, num_cols)
            screen_ops += 2
        else:
            dense_psums += 1
            psum_bits += compression_core.dense_uplink_bits(d, num_cols)
        if down.compressed:
            down_psums += 3 if down.comp.quantize == "int8" else 2
            psum_bits += down.bits(d, num_cols)
            screen_ops += 1
    return {
        "rounds": t_rounds,
        "dense_psums": dense_psums,
        "live_psums": 0,
        "total_psums": dense_psums + down_psums,
        "screen_ops": screen_ops,
        "data_gathers": data_gathers,
        "data_gather_bits": gather_bits,
        "data_psum_bits": psum_bits,
        "data_total_bits": gather_bits + psum_bits,
    }


def _round_params(t_rounds, d, num_cols, comp=None, extra_bits=0, down=None):
    """Fixed-codec shorthand over :func:`_comm_params`."""
    return _comm_params(transport_core.CommPlan(uplink=comp, downlink=down),
                        t_rounds, d, num_cols, extra_bits=extra_bits)


def _masked_round_params(t_rounds, d, num_cols, comp=None, *, faulted=False, trim=False,
                         extra_bits=0, down=None):
    """The masked-aggregation counterparts (DESIGN §11).

    Masked dense rounds close with a (d, K) psum + the scalar liveness
    psum (trimmed mode gathers per-machine blocks + weights instead);
    masked compressed rounds gather the payload as before plus, when a
    fault plan rides along, the per-machine liveness scalar.  Screening
    is one is_finite per round on the dense wire, or (compressed) one
    on the ef_step decode + one on the raw decoded stack.  The downlink
    close keeps its :func:`_comm_params` accounting.
    """
    base = _round_params(t_rounds, d, num_cols, comp, extra_bits=extra_bits, down=down)
    scalar_bits = 32  # one f32 liveness scalar per round on the wire
    dl_psums = 0 if down is None else t_rounds * (3 if down.quantize == "int8" else 2)
    dl_bits = (0 if down is None
               else t_rounds * compression_core.uplink_bits(down, d, num_cols))
    dl_screens = 0 if down is None else t_rounds
    if comp is None:
        dense_bits = t_rounds * compression_core.dense_uplink_bits(d, num_cols)
        if trim:
            # all_gather of the (d, K) block + the weight scalar; the
            # trimmed reduction itself is replicated local math
            base.update({
                "dense_psums": 0, "live_psums": 0,
                "total_psums": dl_psums,
                "data_gathers": 2 * t_rounds,
                "screen_ops": t_rounds + dl_screens,
                "data_gather_bits": dense_bits + t_rounds * scalar_bits,
                "data_psum_bits": extra_bits + dl_bits,
            })
        else:
            base.update({
                "live_psums": t_rounds,
                "total_psums": base["total_psums"] + t_rounds,
                "screen_ops": t_rounds + dl_screens,
                "data_psum_bits": base["data_psum_bits"] + t_rounds * scalar_bits,
            })
    else:
        extra_gathers = t_rounds if faulted else 0
        base.update({
            "data_gathers": base["data_gathers"] + extra_gathers,
            "data_gather_bits": base["data_gather_bits"] + extra_gathers * scalar_bits,
        })
    base["data_total_bits"] = base["data_gather_bits"] + base["data_psum_bits"]
    return base


def _worker_rounds_case(cfg, t_rounds, comp=None, agg=None, faults=False, staleness=0,
                        comm=None):
    def build(mesh):
        view = rank_view(mesh, ("data",), "model")
        x, y = (view.block(a, "worker_rounds case") for a in (_normal(4, (30, 12)),
                                                              _normal(5, (30, 12))))
        row = None
        if faults:
            plan = FaultSchedule(dropout=0.3, seed=0).plan(
                1, t_rounds, max(staleness, 1), device=view.device)
            row = FaultPlan(*(leaf[view.machine] for leaf in plan))

        def fn(x, y):
            beta, _ = rounds.worker_rounds(
                pipeline.BinaryHead(), x, y, lam=0.2, lam_prime=0.2, rounds=t_rounds, cfg=cfg,
                data_axes=view.groups, model_axis=view.model, model_axis_size=1, comm=comm,
                compression=comp, faults=row, staleness=staleness, aggregation=agg)
            return beta
        return fn, (x, y)
    return build


_ROUNDS = "rounds.worker_rounds"
_DENSE = {"psum_payload": (12, 1), "pallas_calls": 0, "gram_launches": BINARY_GRAMS}
case(_ROUNDS, "rounds3-mesh1x1-d12", {**_round_params(3, 12, 1), **_DENSE},
     mesh=(1, 1))(_worker_rounds_case(SCAN, 3))
case(_ROUNDS, "rounds3-mesh1x1-d12-top5",
     {**_round_params(3, 12, 1, Compression(5)), **_DENSE}, mesh=(1, 1))(
    _worker_rounds_case(SCAN, 3, Compression(5)))
case(_ROUNDS, "rounds2-mesh1x1-d12-top4-int8",
     {**_round_params(2, 12, 1, Compression(4, "int8")), **_DENSE}, mesh=(1, 1))(
    _worker_rounds_case(SCAN, 2, Compression(4, "int8")))
# masked aggregation: the liveness scalar psum + one screening is_finite
# per round join the budget
case(_ROUNDS, "rounds3-mesh1x1-d12-masked", {**_masked_round_params(3, 12, 1), **_DENSE},
     mesh=(1, 1))(_worker_rounds_case(SCAN, 3, agg=Aggregation()))
case(_ROUNDS, "rounds2-mesh1x1-d12-masked-faulted-stale",
     {**_masked_round_params(2, 12, 1), **_DENSE}, mesh=(1, 1))(
    _worker_rounds_case(SCAN, 2, agg=Aggregation(), faults=True, staleness=1))
# trimmed mode trades the psums for per-machine block + weight gathers
case(_ROUNDS, "rounds2-mesh1x1-d12-trimmed",
     {**_masked_round_params(2, 12, 1, trim=True), **_DENSE}, mesh=(1, 1))(
    _worker_rounds_case(SCAN, 2, agg=Aggregation(trim=0.1)))
# masked compressed + faults: payload gathers + the liveness gather
case(_ROUNDS, "rounds2-mesh1x1-d12-top4-int8-masked-faulted",
     {**_masked_round_params(2, 12, 1, Compression(4, "int8"), faulted=True), **_DENSE},
     mesh=(1, 1))(
    _worker_rounds_case(SCAN, 2, Compression(4, "int8"), agg=Aggregation(envelope=1e6),
                        faults=True))
# two-way transport: the compressed downlink rides the master-masked psum
# broadcast (values + indices, + scales when int8) and adds ONE
# whole-block receiver screen per round
case(_ROUNDS, "rounds2-mesh1x1-d12-top5-down4-int8",
     {**_round_params(2, 12, 1, Compression(5), down=Compression(4, "int8")), **_DENSE},
     mesh=(1, 1))(
    _worker_rounds_case(SCAN, 2, comm=transport_core.CommPlan(
        uplink=Compression(5), downlink=Compression(4, "int8"))))


# ---------------------------------------------------------------------------
# distributed faces
# ---------------------------------------------------------------------------

def _slda_face_case(cfg, t_rounds, d, n_per=30, comp=None, faults=None, staleness=0, agg=None,
                    comm=None):
    def build(mesh):
        n = n_per * mesh.shape[0]

        def fn(x, y):
            return distributed_slda_shardmap(
                mesh, x, y, 0.2, 0.2, 0.05, cfg, rounds=t_rounds, comm=comm, compression=comp,
                faults=faults, staleness=staleness, aggregation=agg)
        return fn, (_normal(6, (n, d)), _normal(7, (n, d)))
    return build


_SLDA = "distributed.slda_shardmap"
_FUSED12 = {**_DENSE, "pallas_calls": 2}
_FUSED70 = {"psum_payload": (70, 1), "pallas_calls": 2, "gram_launches": BINARY_GRAMS}
for _t in (1, 3):
    case(_SLDA, f"scan-rounds{_t}-mesh1x1-d12", {**_round_params(_t, 12, 1), **_DENSE},
         mesh=(1, 1))(_slda_face_case(SCAN, _t, 12))
case(_SLDA, "fused-rounds2-mesh1x1-d12", {**_round_params(2, 12, 1), **_FUSED12},
     mesh=(1, 1))(_slda_face_case(FUSED, 2, 12))
# the PR-1 regression shape: d % model_axis != 0 (70 over 4 -> pad 72)
case(_SLDA, "fused-rounds3-mesh2x4-d70-remainder", {**_round_params(3, 70, 1), **_FUSED70},
     mesh=(2, 4))(_slda_face_case(FUSED, 3, 70))
# compressed uplinks: the call moves the (k_top, 1) payload, no dense
# psum, and exactly the declared bits -- one f32 and one int8 config,
# plus the 8-rank remainder shape under compression
case(_SLDA, "scan-rounds3-mesh1x1-d12-top5",
     {**_round_params(3, 12, 1, Compression(5)), **_DENSE}, mesh=(1, 1))(
    _slda_face_case(SCAN, 3, 12, comp=Compression(5)))
case(_SLDA, "scan-rounds2-mesh1x1-d12-top4-int8",
     {**_round_params(2, 12, 1, Compression(4, "int8")), **_DENSE}, mesh=(1, 1))(
    _slda_face_case(SCAN, 2, 12, comp=Compression(4, "int8")))
case(_SLDA, "fused-rounds3-mesh2x4-d70-remainder-top16-bf16",
     {**_round_params(3, 70, 1, Compression(16, "bf16")), **_FUSED70}, mesh=(2, 4))(
    _slda_face_case(FUSED, 3, 70, comp=Compression(16, "bf16")))
# the fault-tolerant face (DESIGN §11): masked aggregation with a fault
# plan, dense and on the 8-rank mesh
case(_SLDA, "scan-rounds3-mesh1x1-d12-masked-faulted",
     {**_masked_round_params(3, 12, 1), **_DENSE}, mesh=(1, 1))(
    _slda_face_case(SCAN, 3, 12, faults=FaultSchedule(dropout=0.2, seed=1), staleness=1,
                    agg=Aggregation()))
case(_SLDA, "scan-rounds2-mesh1x1-d12-trimmed",
     {**_masked_round_params(2, 12, 1, trim=True), **_DENSE}, mesh=(1, 1))(
    _slda_face_case(SCAN, 2, 12, faults=FaultSchedule(corrupt=0.2, seed=2),
                    agg=Aggregation(trim=0.25)))
# DESIGN §13: compressed downlinks -- dense uplink + compressed downlink,
# both directions compressed, and on the 8-rank remainder mesh (k < d
# keeps the (k, 1) downlink psum distinct from the dense (d, 1) psum the
# dense_psums contract counts)
case(_SLDA, "scan-rounds3-mesh1x1-d12-down6",
     {**_round_params(3, 12, 1, down=Compression(6)), **_DENSE}, mesh=(1, 1))(
    _slda_face_case(SCAN, 3, 12, comm=transport_core.CommPlan(downlink=Compression(6))))
case(_SLDA, "scan-rounds2-mesh1x1-d12-top5-down4-int8",
     {**_round_params(2, 12, 1, Compression(5), down=Compression(4, "int8")), **_DENSE},
     mesh=(1, 1))(
    _slda_face_case(SCAN, 2, 12, comm=transport_core.CommPlan(
        uplink=Compression(5), downlink=Compression(4, "int8"))))
case(_SLDA, "fused-rounds3-mesh2x4-d70-top16-bf16-down8-int8",
     {**_round_params(3, 70, 1, Compression(16, "bf16"), down=Compression(8, "int8")),
      **_FUSED70}, mesh=(2, 4))(
    _slda_face_case(FUSED, 3, 70, comm=transport_core.CommPlan(
        uplink=Compression(16, "bf16"), downlink=Compression(8, "int8"))))
# DESIGN §13 bit-budget schedules: the BitBudget planner re-plans both
# directions per round on the host; the pinned bits are the REALIZED
# schedule totals.  Budgets keep every planned k_top < d: a k = d
# downlink would put a (d, 1) psum on the wire, which the dense_psums
# contract's shape filter counts
_TAPER = transport_core.BitBudget(total_bits=1100, mode="taper", taper=0.5, quantize="int8")
case(_SLDA, "scan-rounds3-mesh1x1-d12-taper1100",
     {**_comm_params(transport_core.CommPlan(schedule=_TAPER), 3, 12, 1), **_DENSE},
     mesh=(1, 1))(
    _slda_face_case(SCAN, 3, 12, comm=transport_core.CommPlan(schedule=_TAPER)))
_CONST = transport_core.BitBudget(total_bits=1500, mode="constant", quantize=None,
                                  down_fraction=0.25)
case(_SLDA, "scan-rounds2-mesh1x1-d12-const1500",
     {**_comm_params(transport_core.CommPlan(schedule=_CONST), 2, 12, 1), **_DENSE},
     mesh=(1, 1))(
    _slda_face_case(SCAN, 2, 12, comm=transport_core.CommPlan(schedule=_CONST)))
case(_SLDA, "fused-rounds3-mesh2x4-d70-masked-faulted",
     {**_masked_round_params(3, 70, 1), **_FUSED70}, mesh=(2, 4))(
    _slda_face_case(FUSED, 3, 70,
                    faults=FaultSchedule(dropout=0.3, straggle=0.2, corrupt=0.1,
                                         corrupt_mode="mix", seed=3),
                    staleness=2, agg=Aggregation(envelope=1e6)))


def _mc_face_case(cfg, t_rounds, d=10, num_classes=3, comp=None, faults=None, staleness=0,
                  agg=None):
    def build(mesh):
        def fn(x, labels):
            return distributed_mc_slda_shardmap(
                mesh, x, labels, num_classes, 0.2, 0.2, 0.05, cfg, rounds=t_rounds,
                compression=comp, faults=faults, staleness=staleness, aggregation=agg)
        return fn, (_normal(8, (60, d)), _labels(9, 60, num_classes))
    return build


def _mc_params(t_rounds, d=10, num_classes=3, comp=None, masked=False, faulted=False):
    # the (K, d) class means ride one dense f32 mean regardless of the
    # direction compression (and outside the fault mask)
    means_bits = num_classes * d * 32
    maker = _masked_round_params if masked else _round_params
    kw = {"faulted": faulted} if masked else {}
    p = maker(t_rounds, d, num_classes, comp, extra_bits=means_bits, **kw)
    return {**p, "total_psums": p["total_psums"] + 1,
            "direction_payload": (d, num_classes),
            "means_payload": (num_classes, d), "pallas_calls": 0, "gram_launches": 0}


_MC = "distributed.mc_slda_shardmap"
for _t in (1, 3):
    case(_MC, f"scan-rounds{_t}-mesh1x1-d10-K3", _mc_params(_t), mesh=(1, 1))(
        _mc_face_case(SCAN, _t))
case(_MC, "scan-rounds2-mesh1x1-d10-K3-top3", _mc_params(2, comp=Compression(3)),
     mesh=(1, 1))(_mc_face_case(SCAN, 2, comp=Compression(3)))
case(_MC, "scan-rounds2-mesh1x1-d10-K3-masked-faulted",
     _mc_params(2, masked=True, faulted=True), mesh=(1, 1))(
    _mc_face_case(SCAN, 2, faults=FaultSchedule(dropout=0.2, seed=4), staleness=1,
                  agg=Aggregation()))


# ---------------------------------------------------------------------------
# path.solve_dantzig_path / path.worker_debiased_path
# ---------------------------------------------------------------------------

def _lams(n, device="cuda"):
    return torch.linspace(0.05, 0.4, n, device=device)


@case("path.solve_dantzig_path", "fused-factor-fed-d16-k3-L4",
      {"eighs": 0, "pallas_calls": 1})
def _path_factor_fed(device="cuda"):
    def fn(factor, b):
        return rpath.solve_dantzig_path(factor, b, _lams(4, device), FUSED)
    return fn, (spectral_factor(_spd(16, 10, device)), *_on(_normal(11, (16, 3)), device=device))


@case("path.solve_dantzig_path", "scan-raw-d16-k2-L4", {"eighs": 1, "pallas_calls": 0})
def _path_raw_scan(device="cuda"):
    def fn(a, b):
        return rpath.solve_dantzig_path(a, b, _lams(4, device), SCAN)
    return fn, (_spd(16, 12, device), *_on(_normal(13, (16, 2)), device=device))


@case("path.solve_dantzig_path", "fused-tol-raw-d16-k2-L4", {"eighs": 1, "pallas_calls": 1})
def _path_raw_fused_tol(device="cuda"):
    def fn(a, b):
        return rpath.solve_dantzig_path(a, b, _lams(4, device), FUSED_TOL)
    return fn, (_spd(16, 14, device), *_on(_normal(15, (16, 2)), device=device))


def _worker_path_case(cfg):
    def build(device="cuda"):
        def fn(x, y):
            return rpath.worker_debiased_path(pipeline.BinaryHead(), x, y,
                                              lams=_lams(6, device), lam_prime=0.1, cfg=cfg)
        return fn, _on(_normal(16, (40, 12)), _normal(17, (44, 12)), device=device)
    return build


case("path.worker_debiased_path", "scan-d12-L6",
     {"pallas_calls": 0, "gram_launches": BINARY_GRAMS})(_worker_path_case(SCAN))
case("path.worker_debiased_path", "fused-tol-d12-L6",
     {"pallas_calls": 2, "gram_launches": BINARY_GRAMS})(_worker_path_case(FUSED_TOL))


# ---------------------------------------------------------------------------
# solver_dispatch.solve_dantzig_full
# ---------------------------------------------------------------------------

@case("solver_dispatch.solve_dantzig_full", "fused-factor-fed-d16-k4",
      {"eighs": 0, "pallas_calls": 1})
def _full_factor_fed(device="cuda"):
    def fn(factor, b):
        return solve_dantzig_full(factor, b, 0.1, FUSED)
    return fn, (spectral_factor(_spd(16, 18, device)), *_on(_normal(19, (16, 4)), device=device))


@case("solver_dispatch.solve_dantzig_full", "scan-raw-d16-k4",
      {"eighs": 1, "pallas_calls": 0})
def _full_raw_scan(device="cuda"):
    def fn(a, b):
        return solve_dantzig_full(a, b, 0.1, SCAN)
    return fn, (_spd(16, 20, device), *_on(_normal(21, (16, 4)), device=device))


# ---------------------------------------------------------------------------
# streaming.classify_batch / streaming.refit_step (the serving runtime)
# ---------------------------------------------------------------------------

@case("streaming.classify_batch", "B32-d16-K3-priors", {})
def _classify_batch_priors(device="cuda"):
    priors = torch.full((3,), 1.0 / 3.0, device=device)
    return streaming.classify_batch, (*_on(_normal(22, (32, 16)), _normal(23, (16, 3)),
                                           _normal(24, (3, 16)), device=device), priors)


@case("streaming.classify_batch", "B8-d12-K2-equal-priors", {})
def _classify_batch_binary(device="cuda"):
    def fn(z, beta, means):
        return streaming.classify_batch(z, beta, means, None)
    return fn, _on(_normal(25, (8, 12)), _normal(26, (12, 2)), _normal(27, (2, 12)), device=device)


def _refit_case(cfg, warm: bool):
    def build(device="cuda"):
        x, y = _on(_normal(28, (40, 12)), _normal(29, (44, 12)), device=device)
        stats = streaming.head_stats_of(pipeline.suff_stats(x, y))
        if warm:
            carry = streaming.refit_step(stats, 0.1, 0.1, cfg).carry

            def fn(stats, carry):
                return streaming.refit_step(stats, 0.1, 0.1, cfg, carry=carry)
            return fn, (stats, carry)

        def fn(stats):
            return streaming.refit_step(stats, 0.1, 0.1, cfg)
        return fn, (stats,)
    return build


case("streaming.refit_step", "cold-scan-d12", {"pallas_calls": 0})(
    _refit_case(SCAN, warm=False))
case("streaming.refit_step", "warm-scan-d12", {"pallas_calls": 0})(
    _refit_case(SCAN, warm=True))
case("streaming.refit_step", "cold-fused-tol-d12", {"pallas_calls": 2})(
    _refit_case(FUSED_TOL, warm=False))


# ---------------------------------------------------------------------------
# mesh cases: counted on every rank
# ---------------------------------------------------------------------------

def find_case(entry: str, name: str) -> Case:
    for c in _CASES.get(entry, []):
        if c.name == name:
            return c
    raise KeyError(f"no case {name!r} registered for {entry!r}")


def run_mesh_cases(mesh, keys) -> dict:
    """The rank function of a lint spawn: count each ``(entry, name)`` case on this rank;
    rank 0 returns ``{(entry, name): [OpCounts of rank 0, 1, ...]}``."""
    out = {}
    for entry, name in keys:
        fn, args = find_case(entry, name).build(mesh)
        _, counts = count_ops(fn, *args)
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, counts)  # outside the counted call
        out[(entry, name)] = every
    return out


__all__ = ["Case", "all_cases", "case", "cases_for", "find_case", "run_mesh_cases"]
