"""Drive the mesh faces case by case on every rank, and report what each rank did.

:func:`run_cases` is the rank function of a checking run
(``run_on_mesh(run_cases, data, model, arrays, cases, ...)``): one
spawn of the mesh serves every case.  For each :class:`MeshCase` every
rank resets its kernel launch counts (:data:`repro_torch.kernels.ops.LAUNCHES`
and their split by shape, ``LAUNCH_SHAPES``), its wire tally
(:data:`repro_torch.core.collectives.TALLY`) and its collective records,
runs the face, and rank 0
collects, beside the replicated result, each rank's launches and
launch shapes, the bits its data- and model-axis collectives put on
the wire, its seconds in collectives and its wall seconds.
"""

from __future__ import annotations

import time
from typing import Any, NamedTuple

import torch
import torch.distributed as dist

from repro_torch.core import collectives, distributed
from repro_torch.core import rounds as rounds_core
from repro_torch.core.pipeline import BinaryHead
from repro_torch.kernels import ops
from repro_torch.launch.mesh import data_axes, mesh_device

FACES = ("binary", "multiclass", "naive", "reentry", "resume", "plan", "raises")


class MeshCase(NamedTuple):
    """One face call: ``face`` in :data:`FACES` and its keyword arguments.

    ``"raises"`` calls the face ``kwargs["call"]`` (on the first
    ``kwargs["rows"]`` rows of every array, where given) and reports the
    name of the TypeError or ValueError it raised, or None.
    """

    name: str
    face: str
    kwargs: dict


def _cpu(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_cpu(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_cpu(v) for v in x)
    if isinstance(x, dict):
        return {k: _cpu(v) for k, v in x.items()}
    return x


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _face(mesh, arrays: dict, face: str, kw: dict):
    if face == "binary":
        return distributed.distributed_slda_shardmap(mesh, arrays["x"], arrays["y"], **kw)
    if face == "multiclass":
        return distributed.distributed_mc_slda_shardmap(mesh, arrays["xk"], arrays["labels"],
                                                        **kw)
    if face == "naive":
        return distributed.naive_averaged_slda_shardmap(mesh, arrays["x"], arrays["y"], **kw)
    if face == "reentry":
        return _reentry(mesh, arrays, **kw)
    if face == "resume":
        return _resume(mesh, arrays, **kw)
    if face == "plan":
        return _plan(mesh, **kw)
    if face == "raises":
        call = dict(kw)
        rows = call.pop("rows", None)  # cut every array to this many rows first
        if rows is not None:
            arrays = {k: v[:rows] for k, v in arrays.items()}
        try:
            _face(mesh, arrays, call.pop("call"), call)
        except (TypeError, ValueError) as exc:
            return type(exc).__name__
        return None
    raise ValueError(f"face must be one of {FACES}, got {face!r}")


def _worker(mesh, arrays, model_axis):
    """This rank's binary samples and the ``worker_rounds`` axis arguments."""
    view = distributed.rank_view(mesh, data_axes(mesh), model_axis)
    return (view.block(arrays["x"], "worker"), view.block(arrays["y"], "worker"),
            dict(data_axes=view.groups, model_axis=view.model, model_axis_size=view.model_size))


def _reentry(mesh, arrays, *, lam, lam_prime, cfg, rounds: int = 1, model_axis="model"):
    """A tol-gated ``collect_info`` solve, then the same solve warm from its carries.

    Returns ``(bar_cold, bar_warm, iterations_cold, iterations_warm)``;
    the iterations are the executed ADMM column-iterations summed over
    every rank (a model rank counts the replicated direction solve too).
    """
    x, y, axes = _worker(mesh, arrays, model_axis)
    kw = dict(lam=lam, lam_prime=lam_prime, rounds=rounds, cfg=cfg, collect_info=True, **axes)
    cold, ws = rounds_core.worker_rounds(BinaryHead(), x, y, **kw)
    warm, ws_warm = rounds_core.worker_rounds(
        BinaryHead(), x, y, rho_beta=ws.rho_beta, rho_theta=ws.rho_theta,
        state_beta=ws.state_beta, state_theta=ws.state_theta, **kw)

    mine = [int(w.iters_beta.sum()) + int(w.iters_theta.sum()) for w in (ws, ws_warm)]
    # a check's own exchange, outside the port's wire, its tally and its records
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    return cold, warm, sum(r[0] for r in every), sum(r[1] for r in every)


def _resume(mesh, arrays, *, lam, lam_prime, cfg, rounds: int, split: int, comm,
            model_axis="model"):
    """A ``rounds``-round stream, and the same stream cut after ``split`` rounds and
    resumed from the received aggregate and both wires' residuals: ``(whole, resumed)``."""
    x, y, axes = _worker(mesh, arrays, model_axis)
    kw = dict(lam=lam, lam_prime=lam_prime, cfg=cfg, comm=comm, **axes)
    whole, _ = rounds_core.worker_rounds(BinaryHead(), x, y, rounds=rounds, **kw)
    head, _, state = rounds_core.worker_rounds(BinaryHead(), x, y, rounds=split,
                                               return_transport_state=True, **kw)
    resumed, _ = rounds_core.worker_rounds(
        BinaryHead(), x, y, rounds=rounds - split, resume_from=head,
        ef_residual=state.up_residual, down_residual=state.down_residual, **kw)
    return whole, resumed


def _plan(mesh, *, schedule, rounds: int, staleness: int = 1):
    """This rank's materialized plan of ``schedule`` for the mesh's machines."""
    return distributed._materialize_plan(schedule, mesh, data_axes(mesh), rounds, staleness,
                                         mesh_device(mesh))


def run_cases(mesh, arrays: dict, cases) -> dict[str, dict[str, Any]]:
    """Run every case on this rank; rank 0 returns ``{name: report}``.

    A report holds ``out`` (rank 0's result, on the CPU; every face's
    result is replicated) and, one entry a rank, ``launches``,
    ``launch_shapes`` (``{(kernel, *shape): n}``), ``data_bits``,
    ``model_bits``, ``collective_s``, ``wall_s`` and ``same_as_rank0`` (the rank's result equals rank 0's bit for bit).
    ``started`` is each rank's clock when the cases began.
    """
    dev = mesh_device(mesh)
    started = time.time()
    reports = {}
    for case in cases:
        ops.reset_launches()
        collectives.TALLY.reset()
        collectives.reset_records()
        _sync(dev)
        t0 = time.perf_counter()
        out = _cpu(_face(mesh, arrays, case.face, case.kwargs))
        _sync(dev)
        wall = time.perf_counter() - t0
        mine = dict(launches=dict(ops.LAUNCHES), launch_shapes=dict(ops.LAUNCH_SHAPES),
                    data_bits=collectives.TALLY.bits["data"],
                    model_bits=collectives.TALLY.bits["model"],
                    collective_s=collectives.TALLY.seconds, wall_s=wall, out=out)
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, mine)
        same = [_equal(r["out"], out) for r in every]
        reports[case.name] = dict(out=every[0]["out"], same_as_rank0=same,
                                  **{k: [r[k] for r in every] for k in mine if k != "out"})
    starts = [None] * dist.get_world_size()
    dist.all_gather_object(starts, started)
    reports["_started"] = starts
    return reports


def _equal(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.shape == b.shape and bool(
            torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)))
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_equal(u, v) for u, v in zip(a, b))
    return a == b
