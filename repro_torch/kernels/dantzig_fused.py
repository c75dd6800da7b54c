"""K2 and K3, the fused ADMM solves on Hopper (twin of ``repro.kernels.dantzig_fused``).

K2 runs a fixed number of iterations from the zero state; K3 resumes
from a warm :class:`AdmmState`, hands the final state back, and with a
``tol`` stops each column block once its max scaled residual is at most
``tol``.  The CUDA C++ source and its design notes are in
``csrc/dantzig_fused.cu``: both kernels are instantiations of one
template, which comes in two forms, the cluster template and the
streamed one.  This module holds the two models that shape a launch
and the launchers.

Blocking model (the column blocks).  The TPU kernel keeps A and Q
resident in VMEM next to the column block, so its model
(``fused_block_vmem_bytes`` / ``pick_block_k`` in the reference) has a
capacity cliff: when A and Q alone exceed the budget, the dispatcher
falls back to the scan solver (d >~ 1250 on the TPU).  The port sizes
its column blocks by a shared-memory footprint against the 227 KB a
block may use (:func:`fused_block_smem_bytes`).  A K2 launch at a d
where no cluster fits even one column (d >= 545) can only take the
streamed template, and is sized by that template's own footprint: two
(d, W) product buffers plus per-column lam and 1/rho
(:func:`streamed_smem_bytes`; its state lives in device memory), so
d = 1,000 takes the widest tile that fits, 24 columns: they put ~3
machines' A^T, Q and Q^T (~37 MB) in L2 at once where 16 would put ~2
(~25 MB), and ran 14% faster than 16 on the card (PERF.md).  Every
other launch keeps the first port's footprint, whose streamed block
held its state in shared memory: seven (d, W) f32 arrays plus lam and
1/rho, and for K3 (``state_io``) a rho row and a reduction scratch.  So
every shape the cluster template takes keeps its blocking (40-column
tiles at d = 200), and so does K3 everywhere.  ``W`` is one of the
kernels' compile-time column tiles.  There is no fallback:
``cfg.fused=True`` runs these kernels at every d where one column fits
(K2 d <= 29,055, K3 d <~ 8300), and raises beyond.  K3 gates each block
on its own, as the TPU kernel does, so with ``tol`` set a column's
iteration count depends on its block-mates: the blocking is computed
the same way on every device and for both templates
(:func:`resolve_block_k`), and the CPU's plain version gates the same
blocks.

Cluster model (the template).  Each (machine, column block) runs as a
thread-block cluster of CS blocks that split the d rows and keep their
row slices of A, Q^T and Q resident in shared memory
(:func:`cluster_smem_bytes`), or, where no cluster size fits, as one
block that streams A and Q from L2 (the streamed template, CS = 0).
:func:`pick_cluster_size` makes that choice from the shape alone; a
launch never switches templates on an error.  A launch on the streamed
template, with the A^T and Q^T it builds, runs inside the span
``repro_torch.admm.streamed`` (:data:`STREAMED_SPAN`), so a profiled
trace tells the two templates apart and counts the streamed launches.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch import obs
from repro_torch.kernels import _launch

# Dynamic shared memory one block may use on an H100 (232,448 bytes).
SMEM_BYTES = 227 * 1024
# The kernels' compile-time column tiles (csrc/dantzig_fused.cu).
TILE_WIDTHS = (1, 8, 16, 24, 32, 40, 48)
# K3's block-wide max reduction: one partial per warp of 256 threads, and the result.
REDUCE_FLOATS = 256 // 32 + 1

# The cluster sizes a launch may take; 16 is beyond the portable 8 and set
# per kernel (cudaFuncAttributeNonPortableClusterSizeAllowed).
CLUSTER_SIZES = (2, 4, 8, 16)
# K3's cluster reduction scratch: a partial per warp, a slot per cluster block.
CLUSTER_REDUCE_FLOATS = 256 // 32 + CLUSTER_SIZES[-1]
# The two mbarriers of the product buffers (static shared memory).
CLUSTER_STATIC_SMEM_BYTES = 16
# Threads per block, each owning one micro-tile.
THREADS = 256
# The streamed template's state arrays in device memory: z, w, u1, u2 and b (csrc kStateSlabs).
STATE_SLABS = 5
# The span around each launch on the streamed template, with the A^T and Q^T it builds.
STREAMED_SPAN = "repro_torch.admm.streamed"


class AdmmState(NamedTuple):
    """The full two-block ADMM state of a (..., d, k) batch."""

    z: torch.Tensor  # box-constrained copy of A beta - b
    w: torch.Tensor  # sparse copy of beta (the solution estimate)
    u1: torch.Tensor  # scaled dual for A beta - z = b
    u2: torch.Tensor  # scaled dual for beta - w = 0

    @classmethod
    def zeros(cls, *shape: int, device: str | torch.device = "cpu") -> "AdmmState":
        z = torch.zeros(shape, dtype=torch.float32, device=device)
        return cls(z, z, z, z)


class FusedSolveResult(NamedTuple):
    """K3's outputs."""

    beta: torch.Tensor  # (..., d, k) the sparse ADMM copy w
    state: AdmmState  # full final state, resumable
    iters: torch.Tensor  # (..., num_blocks) int32 executed iterations per block


def _per_column_floats(width: int, state_io: bool) -> int:
    """lam and 1/rho, and K3's rho and reduction scratch."""
    return 3 * width + REDUCE_FLOATS if state_io else 2 * width


def streamed_smem_bytes(d: int, width: int, state_io: bool = False) -> int:
    """Shared memory of one block of the streamed template (csrc ``smem_floats``): the two
    (d, W) product buffers and the per-column rows."""
    return 4 * (2 * d * width + _per_column_floats(width, state_io))


def streamed_only(d: int) -> bool:
    """Whether no cluster fits a K2 launch at this d even with one column."""
    return pick_cluster_size(d, 1) == 0


def fused_block_smem_bytes(d: int, width: int, state_io: bool = False) -> int:
    """The footprint the blocking model sizes a block of column tile ``width`` by: a K2
    launch where only the streamed template can run takes that template's own shared
    memory; every other launch, K3 with ``state_io`` included, the first port's streamed
    block, seven (d, W) arrays and the per-column rows."""
    if not state_io and streamed_only(d):
        return streamed_smem_bytes(d, width)
    return 4 * (7 * d * width + _per_column_floats(width, state_io))


def max_block_k(d: int, budget: int = SMEM_BYTES, state_io: bool = False) -> int:
    """The widest column tile that fits ``budget`` at this d; raises when none does."""
    fits = [w for w in TILE_WIDTHS if fused_block_smem_bytes(d, w, state_io) <= budget]
    if not fits:
        raise ValueError(
            f"dantzig_fused: one column at d={d} needs "
            f"{fused_block_smem_bytes(d, 1, state_io)} bytes of shared memory, over the "
            f"budget of {budget}")
    return fits[-1]


def pick_block_k(d: int, k: int, budget: int = SMEM_BYTES, state_io: bool = False) -> int:
    """Columns per block: the whole batch when it fits, else equal blocks of at most the widest tile."""
    widest = max_block_k(d, budget, state_io)
    if k <= widest:
        return k
    blocks = -(-k // widest)
    return -(-k // blocks)


def resolve_block_k(d: int, k: int, block_k: int | None, state_io: bool = False) -> int:
    """The columns per block a launch uses: the model's choice, or ``block_k`` capped to fit."""
    if block_k is None:
        return pick_block_k(d, k, state_io=state_io)
    return max(1, min(block_k, k, max_block_k(d, state_io=state_io)))


def _round4(n: int) -> int:
    return -(-n // 4) * 4


def cluster_tile(d: int, width: int, cluster: int) -> str | None:
    """The cluster template's micro-tile at a shape (csrc ``tile_kind``): "row" (1 x 1,
    up to 16 columns) or "block" (2 x 4), the first whose tiles each get a thread."""
    rows = -(-d // cluster)
    if width <= 16 and rows * width <= THREADS:
        return "row"
    if width % 4 == 0 and -(-rows // 2) * (width // 4) <= THREADS:
        return "block"
    return None


def cluster_smem_bytes(d: int, width: int, cluster: int, state_io: bool = False) -> int:
    """Dynamic shared memory of one cluster block (csrc ``cluster_smem_floats``): three
    resident row slices, two (d, W) product buffers and K3's reduction scratch."""
    tile = cluster_tile(d, width, cluster)
    if tile is None:
        raise ValueError(f"no cluster micro-tile fits d={d}, W={width} at {cluster} blocks")
    rows = -(-d // cluster)
    if tile == "row":
        stride = _round4(d) + (4 if _round4(d) // 4 % 2 == 0 else 0)
        slice_, buffer = rows * stride, width * _round4(d)
    else:
        slice_, buffer = _round4(d * -(-rows // 2) * 2), _round4(d * width)
    red = _round4(CLUSTER_REDUCE_FLOATS) if state_io else 0
    return 4 * (3 * slice_ + 2 * buffer + red)


def cluster_fits(d: int, width: int, cluster: int, state_io: bool = False) -> bool:
    """Whether a cluster of this size can run the shape: at most one block per row, a
    micro-tile whose tiles each get a thread, and a block within the shared memory."""
    return (cluster <= d and cluster_tile(d, width, cluster) is not None
            and cluster_smem_bytes(d, width, cluster, state_io) + CLUSTER_STATIC_SMEM_BYTES
            <= SMEM_BYTES)


def pick_cluster_size(d: int, width: int, state_io: bool = False) -> int:
    """The template of a launch: the smallest cluster size that fits with the 1 x 1 tile,
    else the smallest that fits with the 2 x 4 one, else 0, the streamed template.

    The 1 x 1 tile loads less shared memory per FMA, and a smaller cluster
    pushes each product's rows into fewer blocks; at d = 200 this picks
    what the card ran fastest of every cluster size (PERF.md).
    """
    fits = [cs for cs in CLUSTER_SIZES if cluster_fits(d, width, cs, state_io)]
    rows = [cs for cs in fits if cluster_tile(d, width, cs) == "row"]
    return (rows or fits or [0])[0]


def resolve_cluster(d: int, width: int, cluster: int | None, state_io: bool = False) -> int:
    """The cluster size a launch uses: the model's, or ``cluster`` (0: streamed)."""
    if cluster is None:
        return pick_cluster_size(d, width, state_io)
    if cluster and cluster not in CLUSTER_SIZES:
        raise ValueError(f"cluster must be 0 or one of {CLUSTER_SIZES}, got {cluster}")
    return cluster


def tile_width(bk: int) -> int:
    """The narrowest compile-time tile that holds ``bk`` columns."""
    for w in TILE_WIDTHS:
        if w >= bk:
            return w
    raise ValueError(f"block of {bk} columns is wider than the widest tile {TILE_WIDTHS[-1]}")


_K2 = _launch.CFunction("dantzig_fused", "dantzig_fused_launch",
                        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_float] * 2
                        + [ctypes.c_void_p])
_K3 = _launch.CFunction("dantzig_fused", "dantzig_fused_state_launch",
                        [ctypes.c_void_p] * 18 + [ctypes.c_int] * 7 + [ctypes.c_float] * 2
                        + [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_INFO = _launch.CFunction("dantzig_fused", "dantzig_fused_cluster_info",
                          [ctypes.c_int] * 4 + [ctypes.c_void_p])


class ClusterInfo(NamedTuple):
    """What the card reports for a cluster launch shape."""

    max_active_clusters: int  # cudaOccupancyMaxActiveClusters
    smem_bytes: int  # dynamic shared memory per block
    registers: int  # per thread
    local_bytes: int  # spilled, per thread
    tile: int  # the micro-tile: 1 the 1 x 1 "row", 2 the 2 x 4 "block"


def cluster_info(d: int, width: int, cluster: int, state_io: bool = False) -> ClusterInfo:
    """The card's occupancy and resource use of one cluster launch shape."""
    info = (ctypes.c_int * 5)()
    _launch.raise_on_error("dantzig_fused_cluster_info",
                           _INFO(d, width, cluster, int(state_io), ctypes.addressof(info)))
    return ClusterInfo(*info)


def _transposes(a, q, cluster):
    """A^T and Q^T for the streamed template; the cluster template transposes on the card."""
    if cluster:
        return None, None
    return a.mT.contiguous(), q.mT.contiguous()


def _scratch(m, d, k, bk, width, cluster, device):
    """The streamed template's state in device memory: STATE_SLABS (W, d) slabs per (machine,
    column block); none for a cluster launch, which keeps its state in registers."""
    if cluster:
        return None
    return torch.empty(m * -(-k // bk) * STATE_SLABS * width * d, dtype=torch.float32,
                       device=device)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _streamed(launch):
    """``launch()`` inside :data:`STREAMED_SPAN`: a launch on the streamed template shows in a
    profiled trace, and the cluster template's path does not even enter a null context.  The
    launch allocates and launches in the order it did before the span existed."""
    with obs.span(STREAMED_SPAN):
        return launch()


def _check_operands(a, q, inv_eig, b, lam, rho):
    """(m, d, k, device) of a launch, after checking every operand."""
    if b.ndim != 3:
        raise ValueError(f"b must be (m, d, k), got shape {tuple(b.shape)}")
    m, d, k = b.shape
    dev = b.device
    if dev.type != "cuda":
        raise ValueError(f"the fused kernels need CUDA tensors, got {dev}")
    for name, t, shape in (("a", a, (m, d, d)), ("q", q, (m, d, d)),
                           ("inv_eig", inv_eig, (m, d)), ("b", b, (m, d, k)),
                           ("lam", lam, (m, k)), ("rho", rho, (m, k))):
        _launch.check_operand(name, t, shape, dev)
    return m, d, k, dev


def dantzig_fused_cuda(a, q, inv_eig, b, lam, rho, *, iters: int, alpha: float,
                       block_k: int | None = None, cluster: int | None = None) -> torch.Tensor:
    """Launch K2 once for every machine and column block.

    a, q: (m, d, d); inv_eig: (m, d); b: (m, d, k); lam, rho: (m, k);
    all f32 on one card.  ``block_k`` None sizes the blocks with
    :func:`pick_block_k`; ``cluster`` None picks the template with
    :func:`pick_cluster_size`, else it is the cluster size (0: the
    streamed template).  Returns w: (m, d, k).
    """
    m, d, k, dev = _check_operands(a, q, inv_eig, b, lam, rho)
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    bk = resolve_block_k(d, k, block_k)
    width = tile_width(bk)
    cs = resolve_cluster(d, width, cluster)

    def launch():
        at, qt = _transposes(a, q, cs)
        out = torch.empty((m, d, k), dtype=torch.float32, device=dev)
        scratch = _scratch(m, d, k, bk, width, cs, dev)
        code = _K2(a.data_ptr(), q.data_ptr(), _ptr(at), _ptr(qt),
                   *(t.data_ptr() for t in (inv_eig, b, lam, rho, out)), _ptr(scratch),
                   m, d, k, bk, width, cs, iters, alpha, 1.0 - alpha, _launch.stream(dev))
        _launch.raise_on_error("dantzig_fused", code)
        return out

    return launch() if cs else _streamed(launch)


def dantzig_fused_state_cuda(a, q, inv_eig, b, lam, rho, state: AdmmState | None = None, *,
                             iters: int, alpha: float, tol: float | None = None,
                             check_every: int = 10, block_k: int | None = None,
                             cluster: int | None = None) -> FusedSolveResult:
    """Launch K3 once for every machine and column block.

    Operands as :func:`dantzig_fused_cuda`; ``state`` None starts from
    zero, else its leaves are (m, d, k) f32 on the card.  ``tol`` None
    runs exactly ``iters`` iterations; otherwise ``check_every``-iteration
    chunks until the block's max scaled residual is at most ``tol``,
    capped at ``iters``.  ``cluster`` as :func:`dantzig_fused_cuda`.
    Returns w (m, d, k), the final state and the executed iterations
    (m, num_blocks) int32.
    """
    m, d, k, dev = _check_operands(a, q, inv_eig, b, lam, rho)
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    if tol is not None and check_every < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")
    if state is not None:
        for name, leaf in zip(AdmmState._fields, state):
            _launch.check_operand(f"state.{name}", leaf, (m, d, k), dev)
    bk = resolve_block_k(d, k, block_k, state_io=True)
    width = tile_width(bk)
    cs = resolve_cluster(d, width, cluster, state_io=True)

    def launch():
        at, qt = _transposes(a, q, cs)
        w, z, u1, u2 = (torch.empty((m, d, k), dtype=torch.float32, device=dev)
                        for _ in range(4))
        counts = torch.empty((m, -(-k // bk)), dtype=torch.int32, device=dev)
        scratch = _scratch(m, d, k, bk, width, cs, dev)
        state_in = (None,) * 4 if state is None else tuple(leaf.data_ptr() for leaf in state)
        code = _K3(
            a.data_ptr(), q.data_ptr(), _ptr(at), _ptr(qt),
            *(t.data_ptr() for t in (inv_eig, b, lam, rho)), *state_in,
            *(t.data_ptr() for t in (w, z, u1, u2, counts)), _ptr(scratch),
            m, d, k, bk, width, cs, iters, alpha, 1.0 - alpha,
            int(tol is not None), 0.0 if tol is None else tol, check_every, _launch.stream(dev))
        _launch.raise_on_error("dantzig_fused_state", code)
        return FusedSolveResult(w, AdmmState(z, w, u1, u2), counts)

    return launch() if cs else _streamed(launch)
