"""The device mesh on ``torch.distributed`` (twin of ``repro.launch.mesh``).

A mesh is a :class:`~torch.distributed.device_mesh.DeviceMesh` with
``mesh_dim_names`` ``("data", "model")``, or ``("pod", "data",
"model")``: the paper's machines are the data axes, the CLIME columns
of one machine shard over the model axis.  The mesh functions are
called inside an initialized process group, on every rank.

JAX fakes many host devices in one process; torch has no counterpart,
so :func:`run_on_mesh` starts the processes: ``data x model`` ranks by
the ``spawn`` start method, one process group over a ``FileStore`` in a
temporary directory, and one mesh in each rank, which then runs
``fn(mesh, *args)``.  The backend is the caller's explicit choice:
gloo on the CPU, and for several ranks on one card (NCCL refuses two
ranks on one GPU); NCCL where each rank has its own card.
"""

from __future__ import annotations

import io
import os
import queue as queue_module
import tempfile
import time
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.device import require_device
from repro_torch.kernels import build

BACKENDS = ("gloo", "nccl")


def _mesh(device_type: str, shape: tuple, names: tuple) -> DeviceMesh:
    world = dist.get_world_size()
    size = 1
    for n in shape:
        size *= n
    if size != world:
        raise ValueError(f"a {shape} mesh needs {size} ranks; the process group has {world}")
    return DeviceMesh(device_type, torch.arange(world).reshape(shape), mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda") -> DeviceMesh:
    """16 x 16 ranks per pod; 2 pods when ``multi_pod``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(require_device(device).type, shape, names)


def make_host_mesh(data: int | None = None, model: int = 1, *,
                   device: str = "cuda") -> DeviceMesh:
    """A (data, model) mesh over the process group's ranks (``data`` None: all of them)."""
    if data is None:
        data = dist.get_world_size() // model
    return _mesh(require_device(device).type, (data, model), ("data", "model"))


def mesh_axis_names(mesh: DeviceMesh) -> tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def data_axes(mesh: DeviceMesh) -> tuple[str, ...]:
    return tuple(ax for ax in mesh.mesh_dim_names if ax in ("pod", "data"))


def axis_size(mesh: DeviceMesh, name: str) -> int:
    return mesh.shape[mesh.mesh_dim_names.index(name)]


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank computes on: its current card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _to_bytes(result) -> bytes:
    buf = io.BytesIO()
    torch.save(result, buf)
    return buf.getvalue()


def _rank_main(rank: int, world: int, store: str, backend: str, device_type: str,
               shape: tuple, timeout_s: float, fn, args, results) -> None:
    """One rank: pin its threads and card, join the group, build the mesh, run ``fn``."""
    torch.set_num_threads(1)
    build.forbid_builds()  # the parent built every kernel; a rank only loads
    if device_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    try:
        dist.init_process_group(backend, init_method=f"file://{store}", rank=rank,
                                world_size=world, timeout=timedelta(seconds=timeout_s))
        try:
            mesh = make_host_mesh(*shape, device=device_type)
            out = fn(mesh, *args)
            results.put((rank, "ok", _to_bytes(out) if rank == 0 else b""))
        finally:
            dist.destroy_process_group()
    except BaseException:  # reported to the parent, which fails the call
        results.put((rank, "error", traceback.format_exc()))
        raise


def run_on_mesh(fn, data: int, model: int, *args, device: str = "cuda", backend: str,
                timeout: float = 900.0):
    """Run ``fn(mesh, *args)`` on every rank of a fresh (data, model) mesh; rank 0's result.

    ``fn`` is a top-level function (the ranks import it by name) and
    ``args`` are pickled to every rank: pass CPU tensors or numpy
    arrays, and let ``fn`` move them to ``mesh_device(mesh)``.  Each
    rank pins torch to one thread; on the card every rank runs on card
    ``rank % device_count`` (all on ``cuda:0`` on one card).  The
    kernels are built here, before the ranks start, and the ranks only
    load them.  Rank 0's result comes back through ``torch.save``.  A
    rank that raises, dies or outlasts ``timeout`` seconds fails the
    call: every rank is stopped and the rank's traceback is raised.
    """
    dev = require_device(device)
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    world = data * model
    if dev.type == "cuda":
        if backend == "nccl" and world > torch.cuda.device_count():
            raise ValueError(f"nccl needs a card a rank: {world} ranks, "
                             f"{torch.cuda.device_count()} cards")
        build.build()
    elif backend == "nccl":
        raise ValueError("nccl runs on the card only; use gloo on the CPU")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = []
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        try:
            for rank in range(world):
                p = ctx.Process(target=_rank_main, daemon=True,
                                args=(rank, world, store, backend, dev.type, (data, model),
                                      timeout, fn, args, results))
                p.start()
                procs.append(p)
            return _collect(procs, results, time.monotonic() + timeout)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()


def _collect(procs, results, deadline: float):
    """Rank 0's result, once every rank has reported; raise on the first failure."""
    done, out = set(), None
    while len(done) < len(procs):
        try:
            rank, status, payload = results.get(timeout=1.0)
        except queue_module.Empty:
            dead = [r for r, p in enumerate(procs) if r not in done and p.exitcode not in (None, 0)]
            if dead:
                raise RuntimeError(f"mesh rank {dead[0]} exited with code "
                                   f"{procs[dead[0]].exitcode} and reported nothing")
            if time.monotonic() > deadline:
                raise TimeoutError(f"mesh ranks {sorted(set(range(len(procs))) - done)} "
                                   "did not finish in time")
            continue
        if status == "error":
            raise RuntimeError(f"mesh rank {rank} failed:\n{payload}")
        done.add(rank)
        if rank == 0:
            out = torch.load(io.BytesIO(payload), weights_only=False)
    return out
