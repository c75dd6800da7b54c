"""K2 and K3, the fused ADMM solves on Hopper (twin of ``repro.kernels.dantzig_fused``).

K2 runs a fixed number of iterations from the zero state; K3 resumes
from a warm :class:`AdmmState`, hands the final state back, and with a
``tol`` stops each column block once its max scaled residual is at most
``tol``.  The CUDA C++ source and its design notes are in
``csrc/dantzig_fused.cu``: both kernels are instantiations of one
template, which comes in two forms.  The cluster template runs each
(machine, column block) as a thread-block cluster of 2-16 blocks that
split the d rows and keep their row slices of A, Q^T and Q resident in
shared memory (:func:`cluster_smem_bytes`).  The streamed template runs
it as one block that reads A^T, Q and Q^T from L2 and keeps its state in
a device scratch, with only two product buffers in shared memory
(:func:`streamed_smem_bytes`).

:func:`plan_launch` is the one place a launch is decided: the columns
per block, the compile-time column tile that holds them, the template
and the shared memory a block takes.  The launchers, ``ops``, the solver
dispatch, the shared-memory contract and the smoke all read its
:class:`LaunchPlan`.  Its rules:

- Blocking.  A K2 launch at a d where no cluster fits even one column
  (d >= 545) can only take the streamed template, and is sized by that
  template's footprint, so d = 1,000 takes 24 columns: the widest tile
  that fits, and 14% faster than 16 on the card (PERF.md).  Every other
  launch is sized by :func:`blocking_smem_bytes`, 28·d·W bytes plus the
  per-column rows.  That rule is kept on purpose: K3 gates each block on
  its own, so with ``tol`` its blocks are part of its answer, and the
  cluster shapes were tuned at the widths it gives (40-column tiles at
  d = 200).  The batch runs as one block when it fits the widest tile,
  else as equal blocks; a ``block_k`` override is capped to that tile.
  The blocking is the same on every device and template, and the CPU's
  plain version gates the same blocks.
- Template.  The smallest cluster size that fits with the 1 x 1
  micro-tile, else the smallest that fits with the 2 x 4 one, else the
  streamed template (:func:`pick_cluster_size`); ``cluster=`` forces one
  (0: streamed), and every choice is bit-identical.  A launch never
  switches templates on an error.

There is no fallback to the scan solver, as the TPU kernel's VMEM model
has: ``cfg.fused=True`` runs these kernels at every d where one column
fits (K2 d <= 29,055, K3 d <~ 8300), and raises beyond.  A launch on the
streamed template, with the A^T and Q^T it builds, runs inside the span
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


def blocking_smem_bytes(d: int, width: int, state_io: bool = False) -> int:
    """The footprint the blocking rule sizes every launch by but a streamed-only K2: seven
    (d, W) f32 arrays and the per-column rows."""
    return 4 * (7 * d * width + _per_column_floats(width, state_io))


def pick_block_k(k: int, widest: int) -> int:
    """Columns per block: the whole batch when it fits the widest tile, else equal blocks of at
    most that tile."""
    if k <= widest:
        return k
    blocks = -(-k // widest)
    return -(-k // blocks)


def tile_width(bk: int) -> int:
    """The narrowest compile-time tile that holds ``bk`` columns."""
    for w in TILE_WIDTHS:
        if w >= bk:
            return w
    raise ValueError(f"block of {bk} columns is wider than the widest tile {TILE_WIDTHS[-1]}")


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


class LaunchPlan(NamedTuple):
    """How one K2/K3 launch runs: the C launchers receive its first three fields."""

    block_k: int  # columns per block
    width: int  # the compile-time column tile that holds them
    cluster: int  # blocks a cluster; 0 the streamed template
    smem_bytes: int  # dynamic shared memory one block takes

    @property
    def streamed(self) -> bool:
        return self.cluster == 0


def plan_launch(d: int, k: int, block_k: int | None = None, state_io: bool = False,
                budget: float = SMEM_BYTES, cluster: int | None = None) -> LaunchPlan:
    """The launch of a (d, k) K2 (K3 with ``state_io``) batch, by the rules of the module
    docstring: ``block_k`` None sizes the blocks against ``budget``, else it is capped to the
    widest tile that fits; ``cluster`` None picks the template, else forces it (0: streamed).
    Raises where not even one column fits ``budget``."""
    if cluster and cluster not in CLUSTER_SIZES:
        raise ValueError(f"cluster must be 0 or one of {CLUSTER_SIZES}, got {cluster}")
    footprint = (streamed_smem_bytes if not state_io and pick_cluster_size(d, 1) == 0
                 else blocking_smem_bytes)
    fits = [w for w in TILE_WIDTHS if footprint(d, w, state_io) <= budget]
    if not fits:
        raise ValueError(
            f"dantzig_fused: one column at d={d} needs {footprint(d, 1, state_io)} bytes of "
            f"shared memory, over the budget of {budget}")
    bk = pick_block_k(k, fits[-1]) if block_k is None else max(1, min(block_k, k, fits[-1]))
    width = tile_width(bk)
    cs = pick_cluster_size(d, width, state_io) if cluster is None else cluster
    smem = (cluster_smem_bytes(d, width, cs, state_io) if cs
            else streamed_smem_bytes(d, width, state_io))
    return LaunchPlan(bk, width, cs, smem)


def rides_in_tail(d: int, k: int, extra: int, state_io: bool = False, block_k: int | None = None,
                  budget: float = SMEM_BYTES) -> bool:
    """Whether ``extra`` columns appended to a (d, k) K2 batch run in lanes its launch already
    runs: the (d, k + extra) plan is the (d, k) plan, with as many column blocks, so the joined
    launch has the same grid, tiles and template, and its added columns fill the masked lanes of
    the last block of each machine.  ``block_k`` and ``budget`` as :func:`plan_launch`.

    Always False for K3 (``state_io``): with ``tol`` its blocks stop together, so a column added
    to a block is part of the block's answer."""
    if state_io:
        return False
    plan = plan_launch(d, k, block_k, budget=budget)
    return (plan_launch(d, k + extra, block_k, budget=budget) == plan
            and -(-(k + extra) // plan.block_k) == -(-k // plan.block_k))


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


def check_on_card(d: int, plan: LaunchPlan,
                  state_io: bool = False) -> tuple[ClusterInfo, list[str]]:
    """``(info, mismatches)``: what the card reports for a cluster plan (:func:`cluster_info`),
    and a message for each way it departs from the plan: shared memory per block, micro-tile,
    and no cluster resident."""
    info = cluster_info(d, plan.width, plan.cluster, state_io)
    tile = cluster_tile(d, plan.width, plan.cluster)
    at = f"d={d} W={plan.width} cluster {plan.cluster}"
    mismatches = [msg for ok, msg in (
        (info.smem_bytes == plan.smem_bytes,
         f"{at}: the card reports {info.smem_bytes} bytes of shared memory a block, the plan "
         f"{plan.smem_bytes}"),
        (info.tile == {"row": 1, "block": 2}.get(tile),
         f"{at}: the card's micro-tile {info.tile} is not the plan's {tile}"),
        (info.max_active_clusters > 0, f"{at}: no cluster fits the card"),
    ) if not ok]
    return info, mismatches


def _ptr(t):
    return None if t is None else t.data_ptr()


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


def _launch_admm(kernel: str, operands: tuple, state: AdmmState | None, *, iters: int,
                 alpha: float, block_k: int | None, cluster: int | None, state_io: bool,
                 outputs, call) -> tuple:
    """What both launchers share: check the operands and ``state``, take the plan, and on the
    streamed template build A^T, Q^T and the state scratch (STATE_SLABS (W, d) slabs a machine
    and column block), all inside :data:`STREAMED_SPAN`; a cluster launch enters no context.

    ``outputs(m, d, k, plan, device)`` allocates the kernel's outputs in its C call's order;
    ``call(head, outs, tail, stream)`` makes that call: ``head`` the pointers of a, q, A^T,
    Q^T, inv_eig, b, lam and rho, ``outs`` the outputs', ``tail`` the scratch's, m, d, k, the
    plan's three integers, iters, alpha and 1 - alpha.  Returns the outputs.
    """
    a, q, inv_eig, b, lam, rho = operands
    m, d, k, dev = _check_operands(*operands)
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    for name, leaf in zip(AdmmState._fields, state or ()):
        _launch.check_operand(f"state.{name}", leaf, (m, d, k), dev)
    plan = plan_launch(d, k, block_k, state_io, cluster=cluster)

    def launch():
        at, qt = (a.mT.contiguous(), q.mT.contiguous()) if plan.streamed else (None, None)
        outs = outputs(m, d, k, plan, dev)
        scratch = (torch.empty(m * -(-k // plan.block_k) * STATE_SLABS * plan.width * d,
                               dtype=torch.float32, device=dev) if plan.streamed else None)
        head = (a.data_ptr(), q.data_ptr(), _ptr(at), _ptr(qt),
                *(t.data_ptr() for t in (inv_eig, b, lam, rho)))
        tail = (_ptr(scratch), m, d, k, plan.block_k, plan.width, plan.cluster, iters, alpha,
                1.0 - alpha)
        code = call(head, [t.data_ptr() for t in outs], tail, _launch.stream(dev))
        _launch.raise_on_error(kernel, code)
        return outs

    if not plan.streamed:
        return launch()
    with obs.span(STREAMED_SPAN):
        return launch()


def _empty(*shape, device, dtype=torch.float32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=device)


def dantzig_fused_cuda(a, q, inv_eig, b, lam, rho, *, iters: int, alpha: float,
                       block_k: int | None = None, cluster: int | None = None) -> torch.Tensor:
    """Launch K2 once for every machine and column block.

    a, q: (m, d, d); inv_eig: (m, d); b: (m, d, k); lam, rho: (m, k);
    all f32 on one card.  ``block_k`` and ``cluster`` as
    :func:`plan_launch`.  Returns w: (m, d, k).
    """
    (w,) = _launch_admm(
        "dantzig_fused", (a, q, inv_eig, b, lam, rho), None, iters=iters, alpha=alpha,
        block_k=block_k, cluster=cluster, state_io=False,
        outputs=lambda m, d, k, plan, dev: (_empty(m, d, k, device=dev),),
        call=lambda head, outs, tail, stream: _K2(*head, *outs, *tail, stream))
    return w


def dantzig_fused_state_cuda(a, q, inv_eig, b, lam, rho, state: AdmmState | None = None, *,
                             iters: int, alpha: float, tol: float | None = None,
                             check_every: int = 10, block_k: int | None = None,
                             cluster: int | None = None) -> FusedSolveResult:
    """Launch K3 once for every machine and column block.

    Operands as :func:`dantzig_fused_cuda`; ``state`` None starts from
    zero, else its leaves are (m, d, k) f32 on the card.  ``tol`` None
    runs exactly ``iters`` iterations; otherwise ``check_every``-iteration
    chunks until the block's max scaled residual is at most ``tol``,
    capped at ``iters``.  ``block_k`` and ``cluster`` as :func:`plan_launch`.
    Returns w (m, d, k), the final state and the executed iterations
    (m, num_blocks) int32.
    """
    if tol is not None and check_every < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")

    def outputs(m, d, k, plan, dev):
        # w, z, u1, u2, then the executed iterations of every (machine, block)
        return (*(_empty(m, d, k, device=dev) for _ in range(4)),
                _empty(m, -(-k // plan.block_k), device=dev, dtype=torch.int32))

    def call(head, outs, tail, stream):
        state_in = (None,) * 4 if state is None else tuple(leaf.data_ptr() for leaf in state)
        return _K3(*head, *state_in, *outs, *tail, int(tol is not None),
                   0.0 if tol is None else tol, check_every, stream)

    w, z, u1, u2, counts = _launch_admm(
        "dantzig_fused_state", (a, q, inv_eig, b, lam, rho), state, iters=iters, alpha=alpha,
        block_k=block_k, cluster=cluster, state_io=True, outputs=outputs, call=call)
    return FusedSolveResult(w, AdmmState(z, w, u1, u2), counts)
