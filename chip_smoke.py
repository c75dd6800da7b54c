#!/usr/bin/env python3
"""Drives the PyTorch port's main path on one NVIDIA card and checks every kernel on it.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. build: compiles the CUDA C++ kernels (K1 gram; K2 and K3, the fused
   ADMM without and with state; K4 shrink) from ``repro_torch/kernels/csrc``
   with one nvcc per source, all at once;
2. kernels: each kernel against its plain PyTorch version on the card,
   at the main path's shapes and at ragged ones (K1 at d in {1, 3, 4,
   200, 203, 256} and n in {1, 31, 250}, within 1e-5 of the largest entry
   and exactly symmetric; K4 bit for bit, NaN positions and the sign of
   zero included, on +-0, +-inf, NaN and |x| == t, at c % 4 in {0, 1, 2,
   3}, on a numel that fills no whole block, on 1-D and misaligned
   input), plus K2's bit-identity across column blockings, and K3 at
   the lambda path's shapes (the CLIME block and the k = 8 direction
   fold): bit-identical to K2 and
   exactly resumable at ``tol=None``, and with ``tol`` set the same
   per-block iteration counts as its plain version (at most one block
   a chunk apart, its w then held against the plain version run for
   the kernel's count); then, for the four K2/K3 calls of the main path,
   the template the cluster model picks (cluster size, micro-tile, shared
   memory per block, the card's cudaOccupancyMaxActiveClusters) and the
   SHA-256 of the outputs, equal to the digests recorded from the first
   port's kernel and the same at every cluster size that fits and on the
   streamed template, and K2 and K3 at edge
   shapes (d not a multiple of the cluster size, k = 1, a ragged tail
   block, a shape sent to the streamed template): within the K2 pin of the
   plain version, bit-identical across blockings and templates, K3 equal
   to K2 at ``tol=None`` and across a resume, and with a gate that stops
   some blocks early the plain version's per-block counts; and the same
   checks at the launch shapes runs (d) and (e) add, on their own
   statistics (K2 at d = 120, k = 5 and 120; the K3 fold, k = 40 at
   d = 120; K2 and K3 at m = 80, d = 200, k = 1 and 200), each with its
   template and the card's cudaOccupancyMaxActiveClusters; and at the
   launch shapes the mesh runs (f)-(h) add, one machine a rank (m = 1):
   d = 200 with k in {1, 200, 68} (68: a model rank's 67 CLIME columns
   and the direction's, one launch) and d = 128 with k in {1, 4, 64};
   and at run (i)'s: K1 at (1, n, 120) for each batch size n it sees, and
   on a tick's rows corrupted with NaN, inf and +-1e12 garbage (the
   non-finite entries where the plain version has them), and K3 at
   (1, 120, k) for k in {1, 5, 120} at each iteration count the ladder
   runs (600, 1,200, 3,000), cold and from the state of the same solve
   on another Sigma_hat, through the same checks; and at runs (j) and
   (k)'s (m = 1): K1 at (n, d) in ``LINT_K1`` and (2,048, 256), K2 and
   K3 at each (d, k) of ``LINT_ADMM`` at 40 iterations and at (256, 1)
   and (256, 16) at 500, through the edge shapes' checks; and K2 at the
   d = 1,000 shapes of the ``sec51_d1000_m20`` fit on the streamed
   template (``D1000``: the direction, m = 20, k = 1, and a 2-machine
   slice of the CLIME block), within the K2 pin of the plain version and
   bit for bit against narrower column blocks and K3 at ``tol=None``, and
   the fit's joined launch on the slice's machines (the direction's
   column in the last block's spare lane, (2, 1,000, 1,001)) bit for bit
   against the slice and the direction launched alone; and what
   cuSOLVER's eigh does with a non-finite Sigma_hat (the port's factor
   is all NaN);
3. main path: Algorithm 1 at the paper's §5.1 size (d = 200, AR(0.8),
   10 signal coordinates, N = 10,000 over m = 20 machines, 500 ADMM
   iterations) through the entry points a user calls, twice --
   (a) ``DantzigConfig(fused=True)``: K1 + K2, and
   (b) ``DantzigConfig(use_kernel=True)``: K1 + K4 under the adaptive-rho
   scan -- each held against the same estimators on the card's plain path,
   with the kernels' launch counts read around each run; then
   (c) the lambda path at the same size: an 8-point grid around lam,
   swept cold and then warm from the cold sweep's states under a fused,
   tol-gated config (K1 + K3, two K3 launches per sweep), each machine's
   lambda chosen on a separate validation draw and by KKT, and the
   aggregate's statistics at every grid point held against the same
   sweep run with the plain versions;
   (d) the multiclass design (``repro_torch/configs/multiclass_rounds.py``,
   MULTICLASS: d = 120, K = 5, m = 20, n = 400 a machine, 600
   iterations, fused): the distributed (two K2), naive and centralized
   estimators, accuracy on a held-out draw of 2,000 and F1 against the
   true directions, and the K-class lambda path (8 grid points, the
   K * L = 40 direction columns in one K3 fold; cold, then warm), each
   held against the same run on the plain versions (F1 and accuracy
   equal, l2 within 1e-4, 1e-3 on the tol-gated path);
   (e) the refinement rounds (ROUNDS: d = 200, N = 10,000 over m = 80,
   600 iterations): one set of machine solves (two K2) drives dense
   rounds T = 1..3 (T = 1 the one-shot mean bit for bit), the identity
   codec (dense bit for bit), top-20% int8 uplinks (at most 25% of the
   dense bits), 10% dropout masked and unmasked, and every machine NaN
   in every round (the masked aggregate finite); then a tol-gated
   re-entry with ``collect_info`` (two K3 a call), warm fewer
   iterations than cold; each held against the plain versions;
   then the mesh (``repro_torch/launch/mesh.py``): gloo ranks, all on this
   card, spawned once a run, each resetting and reading its own launch
   counts around each case; (f) the §5.1 design on a (data=20, model=1)
   mesh, run (a)'s split, fused: one-shot (K1 and two K2 a rank), T = 3
   dense rounds, top-20% int8 uplinks (at most 25% of the dense bits as
   the ranks' gathers carried them, and exactly ``uplink_bits``), 10%
   dropout masked, an int8 downlink, and a tol-gated re-entry (two K3 a
   rank a call, warm fewer iterations than cold); (g)
   ``repro_torch/mesh_distributed_lda.py`` at its own sizes on
   (data=4, model=2), fused, both heads; (h) the §5.1 problem at
   N = 10,000 over (data=2, model=3), 67 CLIME columns a rank and one pad
   column, fused and ``use_kernel=True`` (K4); each case held against
   the same case on the simulated face on the card, on the same split
   (F1 equal, accuracy equal for K classes, l2 within 1e-4, 1e-3 on the
   tol-gated re-entry), with the spawn, the slowest rank's compute and
   collectives, and the bits each rank's collectives carried;
   (i) serving (``repro_torch/configs/serving.py``, SERVING:
   ``benchmarks/serving.py --paper``, d = 120, B = 8,192 queries a tick,
   24 ticks, a refresh every 2) through ``ServingRuntime`` and
   ``launch/serve.py``'s tick loop: (i-1) the reference's config (scan,
   adaptive rho, tol 1e-3: K1 on every ingest) and (i-2) ``fused=True``
   (K1 + K3 refits), each with the seed fit, qps by CUDA events and the
   host time a call, the op contracts counted (0 eigh and 0 launches a
   classify, 1 eigh a refit), the staleness curve, warm against cold,
   and the 24-tick chaos runs (clean, protected, unprotected) under one
   fault plan; (i-2) also the refit by stage and (i-4) the checkpoints
   (a snapshot a publish, a torn newer file and a stray .tmp skipped,
   restored onto the card with the live runtime's predictions); (i-3)
   the K-class stream (K = 5, fused, 8 ticks, held out on 2,000). Each
   part is held against the same part on the plain versions of K1 and
   K3 on the card: versions, statuses, quarantine flags and rungs equal,
   scores within 1e-3 of the largest and predictions equal but at
   near-ties, the published direction's F1 equal and l2 within 1e-3;
   (j) the op-contract lint (``python -m repro_torch.analysis.lint``):
   all 43 cases of ``repro_torch/analysis/cases.py`` on the card, the
   mesh cases on gloo ranks all on this card (one spawn a mesh shape),
   every case's contracts reading the kernels' launches, which must
   equal the wrapper calls; (k) the production-mesh dry run
   (``python -m repro_torch.launch.dryrun_slda``: d = 256, n = 4,096,
   500 iterations, rank 0 of 16 x 16 and 2 x 16 x 16, baseline and
   fused) in a child process that only loads the kernels built here:
   rank 0's seconds, peak memory, FLOP, bytes, launches by shape and
   bits a link (the data axis's one d-vector), beside the card line;
4. times: each kernel, its plain version and the one PyTorch call that
   computes the same function (where there is one), with CUDA events
   over back-to-back calls (``ms``), and the cold and warm sweeps; and
   each kernel's split into device time (``device_ms``: calls captured
   in one CUDA graph and replayed, cross-checked by torch.profiler) and
   host time (``host_us``: the wrapper's wall time over unsynchronised
   calls), K1 also with the L2 cache flushed before each call; and the
   four K2/K3 calls at every cluster size that fits and on the streamed
   template, in turns; K2 at the d = 1,000 shapes, the CLIME slice at
   8, 16 and 24 columns a block, in turns, against the bound; and each
   launch shape of runs (d), (e), the
   mesh runs and run (i) (time, device and host split, bound, launches),
   with the runs' stages.

The last lines are the kernels' JSON, the card's name and power limit,
and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import contextlib
import json
import math
import subprocess
import sys
import time
from types import SimpleNamespace

import torch

from repro_torch.configs import MULTICLASS, ROUNDS, SERVING, SYNTHETIC

# Dense peaks of an H100 SXM from NVIDIA's data sheet: FP32 outside the
# tensor cores, and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

# The paper's §5.1 design: d = 200, AR(0.8), 10 signal coordinates,
# N = 10,000 split over m = 20 machines (one of its machine counts), n1 = n2.
D, RHO, N_SIGNAL = SYNTHETIC.d, SYNTHETIC.rho, SYNTHETIC.n_signal
M = 20
N_PER = SYNTHETIC.N // M
ITERS, N_TEST, SEED = 500, 4000, 0
DEVICE = "cuda:0"
CHECK_ITERS = 200  # K2 vs its plain version: f32 drift grows with the iteration count
# The lambda path: 8 grid points lam * 2^((l - 4) / 4), l = 0..7, from lam / 2 to
# 1.68 lam with lam itself at l = 4, swept under a fused, tol-gated config.  At
# this size fixed-rho ADMM leaves a max scaled residual of ~2e-2 after 500
# iterations and ~9e-3 after 1000, so a 1e-2 gate never fires in the cold
# sweep (which then equals the fixed 500-iteration solve) and fires during the
# warm re-sweep; a 1e-4 gate would fire in neither.
L_GRID = 8
PATH_TOL, CHECK_EVERY = 1e-2, 10
LOOSE_TOL = 0.1  # K3 phase only: a gate the cold CLIME blocks reach inside 200 iterations
N_VAL = 2000
STAGE_REPS = 5  # run (b)'s stages are host-bound: their wall times spread between runs
# Run (d), the multiclass design (configuration MULTICLASS: d = 120, K = 5, m = 20,
# n = 400 a machine, 600 iterations), and its lambda path: 8 grid points around lam,
# the K * L = 40 direction columns in one fold.  Run (e), the refinement rounds
# (configuration ROUNDS: d = 200, N = 10,000 over m = 80, T = 3, 600 iterations).
MC_L_GRID = 8
INT8_SHARE = 0.25  # top-20% int8 uplinks: at most this share of the dense uplink bits
# The mesh runs, gloo ranks all on this card: (f) the §5.1 design on a (data=20,
# model=1) mesh, run (a)'s split; (g) repro_torch/mesh_distributed_lda.py at its own
# sizes, (data=4, model=2), d = 128; (h) the §5.1 problem at N = 10,000 over
# (data=2, model=3), 67 CLIME columns a model rank and one pad column.
MESH_F, MESH_G, MESH_H = (20, 1), (4, 2), (2, 3)
MESH_T = 3
MESH_TIMEOUT = 600  # seconds one mesh run may take, the spawn included
# Run (i), serving (configuration SERVING: benchmarks/serving.py --paper, d = 120): the
# batch sizes K1 sees there (a tick's 60 a class, the warm-against-cold batch's 150,
# the refreshed refit's 400, the seed fit's 480), and the iteration counts K3 runs at
# on each of its shapes: 600 (warm and cold rungs), 1,200 on the binary refactor rung
# (refactor_scale 2) and 3,000 on the K-class one (refactor_scale 5, SERVING's note)
SERVING_K1_ROWS = (SERVING.ingest, SERVING.n_warm, SERVING.n_refreshed, SERVING.n_seed)
SERVING_K3_ITERS = {"direction k=1": (600, 1200), "CLIME k=120": (600, 1200, 3000),
                    "K-class k=5": (600, 3000)}
SERVING_CKPT = ".verify/serving_ckpt"  # run (i)'s snapshots (git-ignored), removed at its end
# Run (j), the op-contract lint on the card (python -m repro_torch.analysis.lint): the
# (rows a class, d) of each K1 launch and the (d, k) of each K2/K3 launch its 43 cases
# make, one machine a rank (m = 1) at 40 ADMM iterations (repro_torch/analysis/cases.py):
# d = 12, 10 and 16 in process and on (1, 1) meshes, d = 70 over (data=2, model=4), 18
# CLIME columns a rank (two of them pad).  Run (k), the production-mesh dry run at the
# reference's defaults (python -m repro_torch.launch.dryrun_slda: d = 256, n = 4,096 a
# machine, 500 iterations; rank 0 of 16 x 16 and 2 x 16 x 16): K1 at (2,048, 256), K2
# at k = 1 and the 16 CLIME columns of model rank 0.
LINT_K1 = ((40, 12), (44, 12), (30, 12), (30, 70))
LINT_ADMM = ((12, 1), (12, 12), (10, 3), (10, 10), (12, 6), (16, 4), (16, 8), (16, 12),
             (70, 1), (70, 18))
LINT_ITERS, LINT_CASES = 40, 43
DRY = SimpleNamespace(d=256, n=4096, iters=500)
DRY_ADMM = ((DRY.d, 1), (DRY.d, DRY.d // 16))


FAILURES: list[str] = []


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    """Record a failed check; the run goes on so one run reports every failure, then exits 1."""
    if not cond:
        print(f"chip_smoke: CHECK FAILED: {msg}", file=sys.stderr)
        FAILURES.append(msg)


def sync_time(fn):
    """(result, wall seconds) of fn() run to completion on the card."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds of fn() over ``reps`` back-to-back runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, n: int) -> float:
    """Mean device milliseconds of one fn(): n calls captured in one CUDA graph, replayed.

    The replay has no host launch path between the calls, so this is the
    device's time per call (each kernel node still waits ~1 us for the
    one before it).
    """
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up off the capture: builds, loads, allocator
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(n):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def host_us(fn, n: int) -> float:
    """Mean host microseconds of one fn() over n calls with no synchronisation between them."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = 1e6 * (time.perf_counter() - t0) / n
    torch.cuda.synchronize()
    return us


def cold_device_ms(fn, n: int) -> float:
    """Mean device milliseconds of one fn() with the L2 cache flushed before each call.

    CUDA events around each call; the 128 MB flush (2.5x the H100's
    L2) gives the host time to enqueue the call before the device
    reaches it.
    """
    flush = torch.empty(32 * 2**20, dtype=torch.float32, device=DEVICE)
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(n)]
    fn()
    for start, end in events:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in events) / n


def profiled_ms(fn, kernel: str, n: int) -> float | None:
    """Mean device ms of the kernels whose name holds ``kernel``, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages() if kernel in e.key and e.device_time_total > 0]
    count = sum(e.count for e in hits)
    return sum(e.device_time_total for e in hits) / count / 1e3 if count else None


def busy_share(fn) -> float:
    """The share of fn()'s wall time (host clock, synchronised) the device spent in kernels,
    from one run under torch.profiler (whose own overhead lengthens the wall time)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = sync_time(fn)
    device_us = sum(e.device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    return device_us / (1e6 * wall)


def time_split(fn, n: int, n_host: int, kernel: str | None = None, cold: bool = False) -> dict:
    """Host and device time of one call: device_ms over n graph-captured calls, host_us
    over n_host unsynchronised ones; with ``cold`` also the L2-flushed device time,
    with ``kernel`` the profiler's device time of the kernels of that name."""
    out = {"device_ms": device_ms(fn, n), "host_us": host_us(fn, n_host)}
    if cold:
        out["cold_device_ms"] = cold_device_ms(fn, n)
    if kernel:
        out["profiler_ms"] = profiled_ms(fn, kernel, min(n, 20))
    return out


def smi_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else ""


def state_kernel_work(counts: torch.Tensor, k: int, bk: int, max_iters: int,
                      d: int = D) -> tuple[int, int]:
    """(FLOP, bytes) K3's function needs for the executed per-(machine, block) ``counts``.

    Every iteration costs four (d, d) x (d, cols) products and ~20
    elementwise operations per entry.  A residual check that another
    chunk follows needs one more product, A dz: its beta solve and
    A beta are, bit for bit, the next iteration's first ones.  A check
    that ends a block's loop (a count below ``max_iters``) needs all
    five.  Bytes: A, Q, inv, b, lam, rho and the state read once, the
    state and the counts written once.
    """
    m, nb = counts.shape
    flops = 0
    for blk, row in enumerate(counts.T.tolist()):
        cols = min(bk, k - blk * bk)
        for n in row:
            checks = -(-n // CHECK_EVERY) - (1 if n >= max_iters else 0)
            ending = 1 if n < max_iters else 0
            flops += (n * (8 * d * d + 20 * d) + checks * 2 * d * d + ending * 8 * d * d) * cols
    nbytes = 4 * (2 * m * d * d + m * d + 2 * m * k + 9 * m * d * k + m * nb)
    return flops, nbytes


def fixed_kernel_work(m: int, d: int, k: int, iters: int) -> tuple[int, int]:
    """(FLOP, bytes) of K2's function: per iteration four (d, d) x (d, k) products and ~20
    elementwise operations per entry; A, Q, inv, b, lam and rho read once, w written once."""
    return (iters * m * (8 * d * d * k + 20 * d * k),
            4 * (2 * m * d * d + m * d + 2 * m * d * k + 2 * m * k))


def same_bits(got: torch.Tensor, want: torch.Tensor) -> bool:
    """True where got is want bit for bit, the sign of zero included, and NaN where want is
    NaN (a NaN's payload aside); ``torch.equal`` and ``assert_close`` take -0 for +0."""
    nan = torch.isnan(want)
    return (torch.equal(torch.isnan(got), nan)
            and torch.equal(got.view(torch.int32)[~nan], want.view(torch.int32)[~nan]))


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """The least milliseconds the card could take, and what bounds it."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def digest(out) -> str:
    """SHA-256 of the raw bytes of a K2 output (w) or a K3 result (w, z, u1, u2, counts)."""
    import hashlib

    leaves = (out,) if isinstance(out, torch.Tensor) else (out.beta, *out.state[:1],
                                                           *out.state[2:], out.iters)
    h = hashlib.sha256()
    for t in leaves:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


# (label, d, k, m, iterations, K3 resume split) of the cluster template's edge
# shapes: d not a multiple of the cluster size, k = 1, a ragged tail block
# (k = 45 in blocks of 23 and 22), and one shape the model sends to the
# streamed template (its slices do not fit a block at 16 blocks a cluster)
EDGE_SHAPES = [("d=37 k=8", 37, 8, 3, 200, 120),
               ("d=203 k=1", 203, 1, 2, 200, 120),
               ("d=203 k=45 ragged tail", 203, 45, 2, 200, 120),
               ("d=512 k=40 streamed", 512, 40, 2, 50, 30)]
# SHA-256 of the four main calls' outputs from the first port's kernel on this
# script's inputs (NVIDIA H100 80GB HBM3): both templates are held to them bit
# for bit
RECORDED_DIGESTS = {
    "K2 CLIME": "c0fa6d7deaefa7297d80390389f6ca4b8a0a67da8dcc73a738f82e1ff69b3d86",
    "K2 k=1": "3cd52d77f976b3d6fa4d8e101a2d46b80df972bded1706db655fe8072395d2f5",
    "K3 CLIME": "e4055fff5c5a4197d4d8b2e6db748596bc77e56a78eb39cac25d47f31732e9b5",
    "K3 fold": "6cd3fcb2f015fa2ca3e327447966edbfecbc0803a4e2848316f4c67cdaa41c42"}


# K2's d = 1,000 launch shapes, on the streamed template (no cluster fits): the
# sec51_d1000_m20 fit's direction (20 machines, k = 1) and a 2-machine slice of its
# CLIME block, each machine's Sigma_hat from 500 rows (rank-deficient, as there);
# the slice is held and timed at every column block of D1000_TILES, and joined with
# the direction's column as the fit launches them (d1000_joined)
D1000 = SimpleNamespace(d=1000, n=500, shapes=(("direction", 20, 1), ("CLIME slice", 2, 1000)),
                        tiles=(8, 16, 24))


def launch_shape(m: int, d: int, k: int, state_io: bool) -> dict:
    """The launch plan of a shape and what the card reports for it: cluster size (0:
    streamed), micro-tile, shared memory per block, registers, spills and
    cudaOccupancyMaxActiveClusters; a cluster plan is checked against the card's report."""
    from repro_torch.kernels.dantzig_fused import check_on_card, cluster_tile, plan_launch

    plan = plan_launch(d, k, state_io=state_io)
    out = {"block_k": plan.block_k, "width": plan.width, "cluster": plan.cluster}
    if not plan.streamed:
        info, mismatches = check_on_card(d, plan, state_io)
        for msg in mismatches:
            check(False, msg)
        out.update(tile=cluster_tile(d, plan.width, plan.cluster), smem_bytes=info.smem_bytes,
                   registers=info.registers, spilled_bytes=info.local_bytes,
                   max_active_clusters=info.max_active_clusters)
    return out


def edge_shape_checks(label, d, k, m, iters, split, gen) -> None:
    """K2 and K3 at one edge shape, on random inputs, against their plain versions."""
    from repro_torch.kernels.spectral import spectral_factor

    dev = torch.device(DEVICE)
    x = torch.randn(m, 2 * d, d, generator=gen, device=dev)
    fac = spectral_factor(x.mT @ x / (2 * d))
    b = torch.randn(m, d, k, generator=gen, device=dev)
    lam = 0.02 + 0.05 * torch.rand(m, k, generator=gen, device=dev)
    rho = 0.5 + torch.rand(m, k, generator=gen, device=dev)
    shape_checks(f"edge {label}", fac, b, lam, rho, iters, split)


def d1000_inputs(gen) -> dict:
    """(a, q, inv, b, lam, rho) of each D1000 shape, and the factor's sigma for the plain
    version."""
    from repro_torch.kernels.spectral import spectral_factor

    dev, d = torch.device(DEVICE), D1000.d
    out = {}
    for label, m, k in D1000.shapes:
        x = torch.randn(m, D1000.n, d, generator=gen, device=dev)
        fac = spectral_factor(x.mT @ x / D1000.n)
        b = (torch.eye(d, device=dev).expand(m, d, d) if k == d
             else torch.randn(m, d, k, generator=gen, device=dev)).contiguous()
        lam = 0.05 + 0.05 * torch.rand(m, k, generator=gen, device=dev)
        out[label] = (fac.sigma.contiguous(), fac.q.contiguous(), fac.inv_eig.contiguous(), b,
                      lam, torch.ones(m, k, device=dev))
    return out


def d1000_checks(inputs: dict) -> None:
    """K2 at each D1000 shape against its plain version, within the K2 pin (twice the plain
    version's own move when Sigma_hat moves by one ulp), and bit for bit at every column
    block of D1000.tiles and against K3 in its own blocks at tol=None: columns are
    independent, so neither the tile nor the kernel may change a bit."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.dantzig_fused import dantzig_fused_cuda, dantzig_fused_state_cuda

    for label, (a, q, inv, b, lam, rho) in inputs.items():
        m, d, k = b.shape
        shape = launch_shape(m, d, k, False)

        def plain(sigma):
            return ref.dantzig_fused_ref(sigma, q, inv, b, lam, iters=CHECK_ITERS, rho=rho,
                                         alpha=1.7)

        got = dantzig_fused_cuda(a, q, inv, b, lam, rho, iters=CHECK_ITERS, alpha=1.7)
        want = plain(a)
        up = torch.rand(d, d, generator=torch.Generator(device=a.device).manual_seed(1),
                        device=a.device) < 0.5
        up = torch.triu(up) | torch.triu(up, 1).mT
        spread = float((plain(torch.nextafter(a, torch.where(up, float("inf"),
                                                            float("-inf")))) - want).abs().max())
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        pin = max(1e-5 * max(1.0, scale), 2 * spread)
        tiles = [w for w in D1000.tiles if w < k and w != shape["block_k"]]
        same = {f"block_k={w}": torch.equal(
            dantzig_fused_cuda(a, q, inv, b, lam, rho, iters=CHECK_ITERS, alpha=1.7,
                               block_k=w), got) for w in tiles}
        k3 = dantzig_fused_state_cuda(a, q, inv, b, lam, rho, iters=CHECK_ITERS, alpha=1.7)
        same["K3 at tol=None"] = torch.equal(k3.beta, got)
        print(f"[kernels] d=1000 {label} (m={m}, k={k}), {CHECK_ITERS} it.: "
              f"{json.dumps(shape)}; K3 {json.dumps(launch_shape(m, d, k, True))}; K2 max abs "
              f"err {err:.3e} (pin {pin:.3e}); bit-identical: {json.dumps(same)}")
        check(shape["cluster"] == 0, f"d=1000 {label}: the model sends the shape to a cluster")
        check(err <= pin, f"d=1000 {label}: K2 err {err} > {pin}")
        check(all(same.values()), f"d=1000 {label}: not bit-identical: {same}")


def d1000_joined(inputs: dict) -> tuple:
    """The sec51_d1000_m20 fit's joined launch on the CLIME slice's machines: the slice's
    operands with the first machines' direction column after its 1,000 columns, each column
    with its own lam; and the direction's column alone on the same machines."""
    a, q, inv, b, lam, rho = inputs["CLIME slice"]
    m = b.shape[0]
    b_dir, lam_dir = inputs["direction"][3][:m].contiguous(), inputs["direction"][4][:m]
    rho_dir = torch.ones(m, 1, device=b.device)
    joined = (a, q, inv, torch.cat([b, b_dir], -1).contiguous(),
              torch.cat([lam, lam_dir], -1).contiguous(), torch.cat([rho, rho_dir], -1))
    return joined, (a, q, inv, b_dir, lam_dir.contiguous(), rho_dir)


def d1000_joined_checks(inputs: dict, iters: int) -> dict:
    """The joined launch against the CLIME slice and the direction launched alone, at
    ``iters`` iterations: each column bit for bit, and the joined launch planned as the
    slice's (the same blocks, tile and template; the direction in a spare lane)."""
    from repro_torch.kernels.dantzig_fused import dantzig_fused_cuda, rides_in_tail

    joined, alone = d1000_joined(inputs)
    m, d, k = joined[3].shape
    shape, slice_shape = launch_shape(m, d, k, False), launch_shape(m, d, k - 1, False)
    got = dantzig_fused_cuda(*joined, iters=iters, alpha=1.7)
    same = {"CLIME columns": torch.equal(got[..., :-1], dantzig_fused_cuda(
                *inputs["CLIME slice"], iters=iters, alpha=1.7)),
            "direction column": torch.equal(got[..., -1:], dantzig_fused_cuda(
                *alone, iters=iters, alpha=1.7))}
    print(f"[kernels] d=1000 joined (m={m}, k={k}), {iters} it.: {json.dumps(shape)}; "
          f"bit-identical to the launches alone: {json.dumps(same)}")
    check(shape == slice_shape and rides_in_tail(d, k - 1, 1),
          f"d=1000 joined: planned {shape}, the CLIME slice {slice_shape}")
    check(all(same.values()), f"d=1000 joined ({iters} it.): not bit-identical: {same}")
    return same


def d1000_times(inputs: dict) -> dict:
    """K2 at each D1000 shape, ITERS iterations, against its bound; the CLIME slice at each
    column block of D1000.tiles, in two turns; then the joined launch, the slice and the
    direction alone on the slice's machines, in three turns, and the joined launch's columns
    held to the two others' bit for bit at ITERS."""
    from repro_torch.kernels.dantzig_fused import dantzig_fused_cuda, plan_launch

    rows = {}
    for label, (a, q, inv, b, lam, rho) in inputs.items():
        m, d, k = b.shape
        model_bk = plan_launch(d, k).block_k
        tiles = D1000.tiles if k > 1 else (model_bk,)
        times = {w: [] for w in tiles}
        for _ in range(2):
            for w in tiles:
                times[w].append(cuda_ms(lambda: dantzig_fused_cuda(
                    a, q, inv, b, lam, rho, iters=ITERS, alpha=1.7, block_k=w), 1))
        bound_ms, bound_by = bound(*fixed_kernel_work(m, d, k, ITERS))
        rows[label] = {"shape": [m, d, k], "iters": ITERS, "bound_ms": bound_ms,
                       "bound_by": bound_by, "model_block_k": model_bk,
                       "ms_by_block_k": {str(w): v for w, v in times.items()},
                       "x_bound_by_block_k": {str(w): min(v) / bound_ms
                                              for w, v in times.items()}}
        print(f"[times] K2 d=1000 {label}: {json.dumps(rows[label])}")
    joined, alone = d1000_joined(inputs)
    calls = {"joined": joined, "CLIME slice": inputs["CLIME slice"], "direction alone": alone}
    times = {name: [] for name in calls}
    for _ in range(3):
        for name, operands in calls.items():
            times[name].append(cuda_ms(lambda: dantzig_fused_cuda(
                *operands, iters=ITERS, alpha=1.7), 1))
    rows["joined"] = {"shape": list(joined[3].shape), "iters": ITERS, "ms": times,
                      "joined_over_slice": min(times["joined"]) / min(times["CLIME slice"]),
                      "bit_identical": d1000_joined_checks(inputs, ITERS)}
    print(f"[times] K2 d=1000 joined: {json.dumps(rows['joined'])}")
    return rows


def shape_checks(label, fac, b, lam, rho, iters, split, start=None) -> dict:
    """K2 and K3 at one launch shape against their plain versions, across blockings and
    templates, at tol=None, across a resume, and with a gate that stops some blocks
    early and not others; every K3 call resumes from ``start`` (None: the zero state, and
    K3 at tol=None is then held to K2 bit for bit).  Returns the K3 launch shape."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.dantzig_fused import dantzig_fused_cuda, dantzig_fused_state_cuda

    m, d, k = b.shape
    a, q, inv = fac.sigma.contiguous(), fac.q.contiguous(), fac.inv_eig.contiguous()
    dev = b.device
    shape = launch_shape(m, d, k, True)
    bk = shape["block_k"]

    def k2(cols=slice(None), **kw):
        return dantzig_fused_cuda(a, q, inv, b[..., cols].contiguous(), lam[:, cols].contiguous(),
                                  rho[:, cols].contiguous(), iters=iters, alpha=1.7, **kw)

    def k3(state=start, n=iters, tol=None, **kw):
        return dantzig_fused_state_cuda(a, q, inv, b, lam, rho, state, iters=n, alpha=1.7,
                                        tol=tol, check_every=CHECK_EVERY, **kw)

    def k3_plain(state=start, n=iters, tol=None, trace=None):
        return ref.dantzig_fused_state_ref(fac.sigma, fac.q, fac.inv_eig, b, lam, iters=n,
                                           rho=rho, alpha=1.7, block_k=bk, tol=tol,
                                           check_every=CHECK_EVERY, state=state, trace=trace)

    got = k2()
    want = ref.dantzig_fused_ref(fac.sigma, fac.q, fac.inv_eig, b, lam, iters=iters, rho=rho,
                                 alpha=1.7)
    # the plain version's own spread: the same columns inside a wider product
    extra = torch.eye(d, device=dev)[:, :8].expand(m, d, 8)
    wide = ref.dantzig_fused_ref(fac.sigma, fac.q, fac.inv_eig, torch.cat([b, extra], -1),
                                 torch.cat([lam, lam[:, :1].expand(m, 8)], -1), iters=iters,
                                 rho=torch.cat([rho, rho[:, :1].expand(m, 8)], -1),
                                 alpha=1.7)[..., :k]
    spread = float((wide - want).abs().max())
    if m == 1:
        # one machine: the plain version beside a second copy of it, where
        # cuBLAS takes another kernel than for a batch of one (K2 runs each
        # machine alone at any m), and with Sigma moved by one ulp, up or
        # down by a fixed draw and kept symmetric, as the CPU tests' pins
        pair = ref.dantzig_fused_ref(fac.sigma.expand(2, d, d), fac.q.expand(2, d, d),
                                     fac.inv_eig.expand(2, d), b.expand(2, d, k),
                                     lam.expand(2, k), iters=iters, rho=rho.expand(2, k),
                                     alpha=1.7)[:1]
        spread = max(spread, float((pair - want).abs().max()))
        for seed in (1, 2, 3):
            up = torch.rand(d, d, generator=torch.Generator(device=dev).manual_seed(seed),
                            device=dev) < 0.5
            up = torch.triu(up) | torch.triu(up, 1).mT
            moved = torch.nextafter(fac.sigma, torch.where(up, float("inf"), float("-inf")))
            ulp = ref.dantzig_fused_ref(moved, fac.q, fac.inv_eig, b, lam, iters=iters,
                                        rho=rho, alpha=1.7)
            spread = max(spread, float((ulp - want).abs().max()))
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    pin = max(1e-5 * max(1.0, scale), 2 * spread)
    other = max(1, bk // 2)
    same = {f"block_k={other}": torch.equal(k2(block_k=other), got),
            "column 0 alone": torch.equal(k2(cols=slice(0, 1)), got[..., :1])}
    if shape["cluster"]:
        same["streamed template"] = torch.equal(k2(cluster=0), got)
    fixed = k3()
    resumed = k3(state=k3(n=split).state, n=iters - split)
    if start is None:
        same["K3 at tol=None"] = torch.equal(fixed.beta, got)
    else:
        # from a warm state: K3 against its plain version, and across blockings and templates
        k3_err = float((fixed.beta - k3_plain()[0]).abs().max())
        check(k3_err <= pin, f"{label}: K3 from the warm state err {k3_err} > {pin}")
        same[f"K3 block_k={other}"] = torch.equal(k3(block_k=other).beta, fixed.beta)
        if shape["cluster"]:
            same["K3 streamed template"] = torch.equal(k3(cluster=0).beta, fixed.beta)
    same[f"K3 resumed {split} + {iters - split}"] = all(
        torch.equal(u, v) for u, v in zip(resumed.state, fixed.state))
    # a gate at the median of the blocks' least residuals over every check
    # before the cap: a block stops at its first check at or below the
    # gate, so the blocks at or below the median stop early and the others
    # run to the cap
    trace = []
    k3_plain(n=iters - CHECK_EVERY, tol=0.0, trace=trace)
    tol = float(torch.stack(trace).amin(0).flatten().median())
    if m * -(-k // bk) == 1:
        # one block: a gate at its own least residual is met with no margin, and
        # the kernel's rounding decides the check it stops at (from a warm start the
        # least residual sits at the f32 floor); the geometric mean of its first
        # and least residuals is crossed mid-run, where the residual still falls
        tol = math.sqrt(float(trace[0].flatten()[0]) * tol)
    gated = k3(tol=tol)
    want_w, _, want_n = k3_plain(tol=tol)
    diff = gated.iters - want_n
    for mach, blk in diff.nonzero().tolist():
        cols = slice(blk * bk, min(k, (blk + 1) * bk))
        want_w[mach, :, cols] = k3_plain(n=int(gated.iters[mach, blk]))[0][mach, :, cols]
    gate_err = float((gated.beta - want_w).abs().max())
    counts = sorted(set(want_n.flatten().tolist()))
    print(f"[kernels] {label}, {iters} it.: {json.dumps(shape)}; K2 max abs err "
          f"{err:.3e} (pin {pin:.3e}); bit-identical: {json.dumps(same)}; K3 tol {tol:.3e}: "
          f"block counts {gated.iters.flatten().tolist()} (plain {want_n.flatten().tolist()}), "
          f"max abs err {gate_err:.3e}")
    check(err <= pin, f"{label}: K2 err {err} > {pin}")
    check(all(same.values()), f"{label}: not bit-identical: {same}")
    check(int((diff != 0).sum()) <= 1 and int(diff.abs().max()) <= CHECK_EVERY,
          f"{label}: K3 block counts {gated.iters.tolist()} vs plain {want_n.tolist()}")
    # one block (m = 1, k = 1): the gate at its own least residual stops it early
    check(counts[0] < iters and (gated.iters.numel() == 1 or counts[-1] == iters),
          f"{label}: the gate {tol} stopped no block early, or every block")
    check(gate_err <= pin, f"{label}: gated K3 err {gate_err} > {pin}")
    check(bool(fixed.iters.eq(iters).all()), f"{label}: tol=None counts differ")
    return shape


def shape_row(fac, b, lam_cols, info, state_io, iters, counter, tol=PATH_TOL,
              start=None) -> dict:
    """K2 (or K3 with ``state_io``, gated at ``tol``, resumed from ``start``) at one
    launch shape: time (back to back, device, host), its bound for this call's work, and
    its launches in ``counter``."""
    from repro_torch.kernels.dantzig_fused import dantzig_fused_cuda, dantzig_fused_state_cuda

    m_, d_, k_ = b.shape
    a_, q_, inv_ = fac.sigma.contiguous(), fac.q.contiguous(), fac.inv_eig.contiguous()
    ones = torch.ones_like(lam_cols)
    if state_io:
        def fn():
            return dantzig_fused_state_cuda(a_, q_, inv_, b, lam_cols, ones, start,
                                            iters=iters, alpha=1.7, tol=tol,
                                            check_every=CHECK_EVERY)
        work = state_kernel_work(fn().iters, k_, info["block_k"], iters, d=d_)
    else:
        def fn():
            return dantzig_fused_cuda(a_, q_, inv_, b, lam_cols, ones, iters=iters, alpha=1.7)
        work = fixed_kernel_work(m_, d_, k_, iters)
    bound_ms, bound_by = bound(*work)
    reps = 2 if m_ > M else 3
    name = "dantzig_fused_state" if state_io else "dantzig_fused"
    return {"shape": [m_, d_, k_], "iters": iters, "ms": cuda_ms(fn, reps),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "launches": counter[(name, m_, d_, k_)], "launch": info,
            **time_split(fn, reps, reps)}


def multiclass_inputs(dev) -> SimpleNamespace:
    """Run (d)'s draws, from their own generator, and its tuning: lam and lam_c as the
    reference's ``benchmarks/fig_multiclass.py``, t as the binary quickstart's."""
    from repro_torch.stats import synthetic

    cfg = MULTICLASS
    problem = synthetic.make_mc_problem(d=cfg.d, num_classes=cfg.num_classes,
                                        n_signal=cfg.n_signal, rho=cfg.rho, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    xs, labels = synthetic.sample_mc_machines(gen, problem, cfg.m, cfg.n_per_machine,
                                              device=dev)
    zs, zl = synthetic.sample_mc_machines(gen, problem, 1, cfg.n_test, device=dev)
    n, big_n = cfg.n_per_machine, cfg.m * cfg.n_per_machine
    b1 = float(problem.betas.abs().sum(0).max())
    lam = 0.3 * math.sqrt(math.log(cfg.d) / n) * b1
    lams = torch.tensor([lam * 2.0 ** ((l - MC_L_GRID // 2) / (MC_L_GRID // 2))
                         for l in range(MC_L_GRID)], dtype=torch.float32, device=dev)
    return SimpleNamespace(problem=problem, xs=xs, labels=labels, z=zs[0], zl=zl[0], lam=lam,
                           lam_c=0.3 * math.sqrt(math.log(cfg.d) / big_n) * b1,
                           t=0.5 * math.sqrt(math.log(cfg.d) / big_n) * b1, lams=lams)


def rounds_inputs(dev, problem) -> SimpleNamespace:
    """Run (e)'s draws of the §5.1 problem over m = 80 machines, from their own
    generator, and its tuning as the reference's ``benchmarks/fault_rounds.py``
    (t as the quickstart's)."""
    from repro_torch.stats import synthetic

    cfg = ROUNDS
    n = cfg.N // cfg.m
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    xs, ys = synthetic.sample_machines(gen, problem, cfg.m, n // 2, n // 2, device=dev)
    b1 = float(problem.beta_star.abs().sum())
    return SimpleNamespace(xs=xs, ys=ys, lam=0.3 * math.sqrt(math.log(cfg.d) / n) * b1,
                           t=0.5 * math.sqrt(math.log(cfg.d) / cfg.N) * b1,
                           mu1=xs.reshape(-1, cfg.d).mean(0), mu2=ys.reshape(-1, cfg.d).mean(0))


def mesh_h_inputs(dev, problem) -> SimpleNamespace:
    """Run (h)'s draws of the §5.1 problem, N = 10,000 over 2 machines, from their own
    generator, and the quickstart's tuning."""
    from repro_torch.quickstart import tuning
    from repro_torch.stats import synthetic

    m, n = MESH_H[0], SYNTHETIC.N // MESH_H[0]
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    xs, ys = synthetic.sample_machines(gen, problem, m, n // 2, n // 2, device=dev)
    lam, _, t = tuning(problem.beta_star, D, n, SYNTHETIC.N)
    return SimpleNamespace(xs=xs, ys=ys, lam=lam, t=t, mu1=xs.reshape(-1, D).mean(0),
                           mu2=ys.reshape(-1, D).mean(0))


def mesh_g_stats(dev) -> SimpleNamespace:
    """One machine of run (g)'s design (d = 128, n = 500, both heads), from its own
    generator: the statistics of the K2 launch shapes run (g) adds."""
    from repro_torch.core import pipeline
    from repro_torch.stats import synthetic

    d, n = 128, 500
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    problem = synthetic.make_problem(d=d, n_signal=10, rho=0.8, device=dev)
    x, y = synthetic.sample_machines(gen, problem, 1, n // 2, n // 2, device=dev)
    mc_problem = synthetic.make_mc_problem(d=d, num_classes=4, n_signal=8, device=dev)
    xk, labels = synthetic.sample_mc_machines(gen, mc_problem, 1, n, device=dev)
    b1 = float(problem.beta_star.abs().sum())
    b1k = float(mc_problem.betas.abs().sum(0).max())
    return SimpleNamespace(binary=pipeline.BinaryHead(False).stats(x, y),
                           multiclass=pipeline.MulticlassHead(4).stats(xk, labels),
                           lam=0.3 * math.sqrt(math.log(d) / n) * b1,
                           lam_k=0.3 * math.sqrt(math.log(d) / n) * b1k)


def mesh_summary(tag: str, reports: dict, spawn_s: float, card: str
                 ) -> tuple[collections.Counter, collections.Counter]:
    """Print each case's per-rank numbers and check its result replicated; returns the
    kernel launches summed over ranks and cases, and the same launches by
    (kernel, *shape), as each rank counted them."""
    total, shapes = collections.Counter(), collections.Counter()
    print(f"[mesh {tag}] spawn + process group + mesh {spawn_s:.2f} s ({card})")
    for name, rep in reports.items():
        for counts, by_shape in zip(rep["launches"], rep["launch_shapes"]):
            total.update(counts)
            shapes.update(by_shape)
        compute = max(w - c for w, c in zip(rep["wall_s"], rep["collective_s"]))
        launches = sorted({json.dumps(c, sort_keys=True) for c in rep["launches"]})
        print(f"  {name}: slowest rank's compute {compute:.4f} s, slowest rank's collectives "
              f"{max(rep['collective_s']):.4f} s, wall {max(rep['wall_s']):.4f} s; bits a rank "
              f"on the data axis {sorted(set(rep['data_bits']))}, the model axis "
              f"{sorted(set(rep['model_bits']))}; launches a rank {', '.join(launches)}")
        check(all(rep["same_as_rank0"]), f"run {tag} {name}: the ranks' results differ")
    return total, shapes


def ranks_launched(tag: str, name: str, rep: dict, **want) -> None:
    """Check every rank's launches: ``kernel=n`` exactly n, ``kernel=None`` at least one."""
    for rank, counts in enumerate(rep["launches"]):
        for kernel, n in want.items():
            ok = counts[kernel] > 0 if n is None else counts[kernel] == n
            check(ok, f"run {tag} {name}: rank {rank} launched {kernel} {counts[kernel]} times, "
                      f"not {'some' if n is None else n}")


def mc_rows(results: dict, problem, z, zl) -> dict:
    """(F1, l2, accuracy) of each K-class estimate: results maps a name to (beta, means)."""
    from repro_torch.core.classifier import estimation_errors, f1_score
    from repro_torch.core.multiclass import mc_classify

    return {name: (float(f1_score(beta, problem.betas)),
                   float(estimation_errors(beta, problem.betas)["l2"]),
                   float((mc_classify(z, beta, means) == zl).float().mean()))
            for name, (beta, means) in results.items()}


def hold_rows(tag: str, rows: dict, plain_rows: dict, l2_pin: float,
              accuracy: bool = False) -> None:
    """Print and check each row against the plain versions' row: F1 equal, the l2 error
    within ``l2_pin``, and (``accuracy``) the accuracy equal."""
    for name, row in rows.items():
        want = plain_rows[name]
        gap = abs(row[1] - want[1])
        extra = f", accuracy {row[2]:.4f} vs {want[2]:.4f}" if accuracy else ""
        print(f"  {name}: F1 {row[0]:.4f} vs {want[0]:.4f}, l2 {row[1]:.5f} (gap {gap:.3e})"
              + extra)
        check(row[0] == want[0], f"{tag} {name}: F1 differs from the plain versions")
        check(gap <= l2_pin, f"{tag} {name}: l2 gap {gap} > {l2_pin}")
        if accuracy:
            check(row[2] == want[2], f"{tag} {name}: accuracy differs from the plain versions")


def round_cases(ws) -> dict:
    """Run (e)'s round schedules, all from the one set of machine solves ``ws``: the
    (d,) aggregate of each, and the dense and identity-codec trajectories."""
    from repro_torch.core.compression import Compression
    from repro_torch.core.faults import Aggregation, FaultSchedule
    from repro_torch.core.rounds import simulate_round_loop

    d, T = ROUNDS.d, ROUNDS.rounds
    dense = simulate_round_loop(ws, rounds=T, return_all_rounds=True)
    ident = simulate_round_loop(ws, rounds=T, compression=Compression(d),
                                return_all_rounds=True)
    drop = FaultSchedule(dropout=ROUNDS.dropout, seed=SEED)
    out = {f"dense T={t}": dense[t - 1, :, 0] for t in range(1, T + 1)}
    out["identity codec T=3"] = ident[-1, :, 0]
    out["top-20% int8 T=3"] = simulate_round_loop(
        ws, rounds=T, compression=Compression(d // 5, "int8"))[:, 0]
    out["10% dropout masked"] = simulate_round_loop(ws, rounds=T, faults=drop,
                                                    aggregation=Aggregation())[:, 0]
    out["10% dropout unmasked"] = simulate_round_loop(ws, rounds=T, faults=drop)[:, 0]
    chaos = simulate_round_loop(ws, rounds=T, aggregation=Aggregation(),
                                faults=FaultSchedule(corrupt=1.0, corrupt_mode="nan", seed=7))
    return {"bars": out, "dense": dense, "identity": ident, "chaos": chaos}


@contextlib.contextmanager
def plain_state_kernel():
    """Within the block the K3 wrapper runs K3's plain version on the card, uncounted.

    Only this script does that, to hold the lambda path against the same
    path on the plain versions; the port itself never does.  The swap is
    below the launch counter, so the plain runs add nothing to it.
    """
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.dantzig_fused import FusedSolveResult

    def plain(factor, b, lam, iters, rho, alpha, bk, tol, check_every, state):
        return FusedSolveResult(*ref.dantzig_fused_state_ref(
            factor.sigma, factor.q, factor.inv_eig, b, lam, iters=iters, rho=rho, alpha=alpha,
            block_k=bk, tol=tol, check_every=check_every, state=state))

    saved = ops._dantzig_fused_state
    ops._dantzig_fused_state = plain
    try:
        yield
    finally:
        ops._dantzig_fused_state = saved

@contextlib.contextmanager
def plain_versions():
    """Within the block K1's and K3's wrappers run their plain versions on the card,
    uncounted (only this script does that, to hold run (i) against the same run on the
    plain versions)."""
    from repro_torch.kernels import ops, ref

    saved = ops.gram
    ops.gram = ref.gram_ref
    try:
        with plain_state_kernel():
            yield
    finally:
        ops.gram = saved


def serving_inputs(dev) -> SimpleNamespace:
    """Phase 2's operands of run (i)'s K1 and K3 launch shapes, from their own generator.

    K1: a batch of each size run (i) gives it, and a tick's 60 rows corrupted with each
    code (NaN, inf, +-1e12 garbage).  K3: each shape's right-hand side on the statistics
    of a seed fit merged with one tick's batch (binary: the direction and the CLIME
    columns; K-class: the K = 5 directions), and the state of the same solve on the seed
    fit's own statistics (600 plain iterations from zero): a warm refit's start on
    another Sigma_hat.
    """
    from repro_torch.core import streaming as st
    from repro_torch.core.pipeline import mc_suff_stats, suff_stats
    from repro_torch.kernels import ref
    from repro_torch.kernels.dantzig_fused import AdmmState, plan_launch
    from repro_torch.kernels.spectral import spectral_factor
    from repro_torch.stats import synthetic

    S = SERVING
    d = S.d
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    problem = synthetic.make_problem(d=d, n_signal=S.n_signal, rho=S.rho, device=dev)
    x, y = synthetic.sample_two_class(gen, problem, S.n_seed, S.n_seed, device=dev)
    bx, by = synthetic.sample_two_class(gen, problem, S.ingest, S.ingest, device=dev)
    seed = suff_stats(x, y, use_kernel=False)
    merged = st.merge_suff_stats(seed, suff_stats(bx, by, use_kernel=False))
    mcp = synthetic.make_mc_problem(d=d, num_classes=S.classes, n_signal=S.mc_n_signal,
                                    rho=S.mc_rho, device=dev)
    xs, labs = synthetic.sample_mc_machines(gen, mcp, 1, 4 * S.ingest * 2, device=dev)
    bxs, blabs = synthetic.sample_mc_machines(gen, mcp, 1, S.ingest * 2, device=dev)
    mseed = mc_suff_stats(xs[0], labs[0], S.classes)
    mmerged = st.merge_mc_stats(mseed, mc_suff_stats(bxs[0], blabs[0], S.classes))
    eye = torch.eye(d, device=dev)[None]
    shapes = {"direction k=1": (seed, merged, lambda s: s.mu_d[None, :, None], S.lam),
              "CLIME k=120": (seed, merged, lambda s: eye, S.lam_prime),
              "K-class k=5": (mseed, mmerged, lambda s: st.head_stats_of(s).rhs[None], S.lam)}
    k3 = {}
    for label, (before, after, rhs, lam) in shapes.items():
        b_before, b = rhs(before).contiguous(), rhs(after).contiguous()
        k = b.shape[-1]
        lam_cols = torch.full((1, k), lam, device=dev)
        fac0 = spectral_factor(before.sigma[None])
        _, start, _ = ref.dantzig_fused_state_ref(
            fac0.sigma, fac0.q, fac0.inv_eig, b_before, lam_cols, iters=600, rho=1.0,
            alpha=1.7, block_k=plan_launch(d, k, state_io=True).block_k)
        k3[label] = SimpleNamespace(fac=spectral_factor(after.sigma[None]), b=b, lam=lam_cols,
                                    start=AdmmState(*(leaf.contiguous() for leaf in start)),
                                    iters=SERVING_K3_ITERS[label])
    clean = synthetic.sample_two_class(gen, problem, S.ingest, S.ingest, device=dev)[0]
    k1 = {n: torch.randn(1, n, d, generator=gen, device=dev) for n in SERVING_K1_ROWS}
    poisoned = {code: st.corrupt_batch_arrays(code, (clean,))[0][None]
                for code, _ in ((1, "NaN"), (2, "inf"), (3, "garbage"))}
    return SimpleNamespace(k1=k1, poisoned=poisoned, k3=k3)


def serving_kernel_checks(sv) -> tuple[set, dict]:
    """Phase 2 at run (i)'s launch shapes; returns the (kernel, *shape) keys it held and
    K1's error at each batch shape.

    K1 at each batch size within 1e-5 of the largest entry and exactly symmetric, and
    on each poisoned batch with its NaN and infinite entries where the plain version has
    them (the finite ones within 1e-5 of the largest); K3 at each shape and iteration
    count, cold and from the warm state, through :func:`shape_checks`.
    """
    from repro_torch.kernels import ref
    from repro_torch.kernels.gram import gram_cuda

    held, k1_err = set(), {}
    for n, x in sv.k1.items():
        mu = x.mean(1)
        got, want = gram_cuda(x, mu), ref.gram_ref(x, mu)
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        k1_err[tuple(x.shape)] = err
        check(err <= 1e-5 * scale, f"K1 serving {tuple(x.shape)}: err {err} > 1e-5 * {scale}")
        check(torch.equal(got, got.mT), f"K1 serving {tuple(x.shape)}: not symmetric")
        held.add(("gram", *x.shape))
        print(f"[kernels] K1 gram serving {tuple(x.shape)}: max abs err {err:.3e} "
              f"(max |G| {scale:.3e})")
    for code, x in sv.poisoned.items():
        mu = x.mean(1)
        got, want = gram_cuda(x, mu), ref.gram_ref(x, mu)
        fin = torch.isfinite(want)
        same = {"NaN": torch.equal(torch.isnan(got), torch.isnan(want)),
                "inf": torch.equal(torch.isinf(got), torch.isinf(want))
                and torch.equal(got[torch.isinf(want)], want[torch.isinf(want)])}
        err = float((got[fin] - want[fin]).abs().max()) if bool(fin.any()) else 0.0
        scale = float(want[fin].abs().max()) if bool(fin.any()) else 0.0
        print(f"[kernels] K1 gram serving {tuple(x.shape)} corrupted with code {code}: "
              f"positions equal {json.dumps(same)}; {int(fin.sum())} finite entries, max abs "
              f"err {err:.3e} (max |G| {scale:.3e})")
        check(all(same.values()), f"K1 poisoned code {code}: non-finite positions differ {same}")
        check(err <= 1e-5 * scale, f"K1 poisoned code {code}: err {err} > 1e-5 * {scale}")
    # the unprotected baseline factorizes a non-finite Sigma_hat: what cuSOLVER's eigh does
    # with one, and the port's factor of it (all NaN, never a raise)
    from repro_torch.kernels.spectral import spectral_factor

    sigma = sv.k3["CLIME k=120"].fac.sigma[0]
    eigh_does = {}
    for name, fill, where in (("all NaN", float("nan"), slice(None)),
                              ("one NaN", float("nan"), (3, 3)), ("one inf", float("inf"), (3, 3))):
        bad = sigma.clone()
        bad[where] = fill
        try:
            torch.linalg.eigh(bad)
            torch.cuda.synchronize()
            eigh_does[name] = "returns"
        except torch.linalg.LinAlgError as exc:  # recorded: the factor below must not raise
            eigh_does[name] = f"raises {type(exc).__name__}"
        fac = spectral_factor(bad)
        check(bool(torch.isnan(fac.q).all()) and bool(torch.isnan(fac.evals).all()),
              f"spectral_factor of a Sigma_hat with {name}: not an all-NaN factor")
    print(f"[kernels] torch.linalg.eigh on a non-finite 120 x 120 Sigma_hat: "
          f"{json.dumps(eigh_does)}; spectral_factor gives an all-NaN factor")
    ones = torch.ones(1, 1, device=sv.k1[SERVING.ingest].device)
    for label, op in sv.k3.items():
        for iters in op.iters:
            for start_name, start in (("cold", None), ("warm from another Sigma", op.start)):
                shape_checks(f"serving {label}, {start_name}", op.fac, op.b, op.lam,
                             ones.expand_as(op.lam).contiguous(), iters, 2 * iters // 5,
                             start=start)
        held.add(("dantzig_fused_state", *op.b.shape))
    return held, k1_err


def rungs(log: list) -> list:
    """(rung, verdict) of each attempt of a ladder log."""
    return [(e["attempt"], e["converged"]) for e in log]


def serving_contracts(rt, z, refit_args) -> dict:
    """The registered op contracts of ``streaming.classify_batch`` and
    ``streaming.refit_step``, counted on one classify and one refit: the counts and the
    violations."""
    from repro_torch.analysis import check_entry, count_ops
    from repro_torch.core import streaming as st

    _, served = count_ops(rt.classify, z)
    _, refit = count_ops(st.refit_step, *refit_args)
    pallas = 2 if refit_args[3].fused else 0

    def summary(c):
        return {"eigh": c.eigh, "matmul": c.matmul, "launches": sum(c.launches.values()),
                "calls": sum(c.calls.values()),
                "collectives": sum(c.collective_count(op) for op in ("psum", "all_gather")),
                "float64": c.float_outputs.get("float64", 0)}

    violations = (check_entry("streaming.classify_batch", served, {})
                  + check_entry("streaming.refit_step", refit, {"pallas_calls": pallas}))
    return {"classify": summary(served), "refit_step": summary(refit),
            "violations": [v.render() for v in violations]}


def refit_stages(rt, hs, cfg) -> dict:
    """One warm refit of ``rt`` on the statistics ``hs``, stage by stage, each run to
    completion (host clock, ms): eigh, the two solves, debias, the slot build."""
    from repro_torch.core import streaming as st
    from repro_torch.core.clime import solve_clime_columns_full
    from repro_torch.core.pipeline import debias
    from repro_torch.core.solver_dispatch import solve_dantzig_full
    from repro_torch.kernels.spectral import spectral_factor

    S, carry, ms = SERVING, rt.carry, {}
    path = "K3" if cfg.fused else "scan"
    fac, ms["eigh"] = sync_time(lambda: spectral_factor(hs.sigma))
    dres, ms[f"direction {path}"] = sync_time(lambda: solve_dantzig_full(
        fac, hs.rhs, S.lam, cfg, rho=carry.rho_beta, state=carry.state_beta))
    tres, ms[f"CLIME {path}"] = sync_time(lambda: solve_clime_columns_full(
        fac, torch.arange(S.d, device=hs.sigma.device), S.lam_prime, cfg, rho=carry.rho_theta,
        state=carry.state_theta))
    beta, ms["debias"] = sync_time(lambda: debias(hs.sigma, hs.rhs, dres.beta, tres.beta))
    _, ms["slot build"] = sync_time(lambda: st.slot_from_stats(hs.aux, beta, S.threshold, 2))
    return {k: 1e3 * v for k, v in ms.items()}


def serving_binary(dev, fused: bool, ckpt_dir: str | None = None) -> dict:
    """Run (i-1) (the reference's config: scan, adaptive rho, tol 1e-3) or (i-2)
    (``fused=True``: K3 refits) on the binary stream, as ``benchmarks/serving.py
    --paper`` prices it: the seed fit, qps at B = 8192, the two op contracts, the
    staleness curve, warm against cold, the 24-tick chaos runs (clean, protected,
    unprotected) and, with ``ckpt_dir``, the clean run's snapshots (i-4)."""
    import os

    from repro_torch.checkpoint import latest_step, save_checkpoint
    from repro_torch.core import streaming as st
    from repro_torch.core.dantzig import DantzigConfig
    from repro_torch.core.pipeline import suff_stats
    from repro_torch.launch import serve
    from repro_torch.stats import synthetic

    S = SERVING
    cfg = DantzigConfig(tol=S.tol, fused=fused)
    kw = dict(cfg=cfg, staleness_bound=S.staleness_bound, device=dev)
    problem = synthetic.make_problem(d=S.d, n_signal=S.n_signal, rho=S.rho, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    x, y = synthetic.sample_two_class(gen, problem, S.n_seed, S.n_seed, device=dev)
    aux0 = suff_stats(x, y)
    out = {"problem": problem}
    rt, out["seed_fit_s"] = sync_time(lambda: st.ServingRuntime(aux0, S.lam, S.lam_prime,
                                                                S.threshold, **kw))
    out["seed_ladder"] = rungs(rt.ladder_log)
    z, lab = synthetic.sample_labeled(gen, problem, S.batch, device=dev)
    out["classify_ms"] = cuda_ms(lambda: rt.classify(z), S.qps_reps)
    out["classify_host_us"] = host_us(lambda: rt.classify(z), S.qps_reps)
    out["qps"] = S.batch / (out["classify_ms"] / 1e3)
    out["contracts"] = serving_contracts(rt, z, (st.head_stats_of(rt.aux), S.lam, S.lam_prime,
                                                 cfg, rt.carry))
    # the staleness curve: the seed slot against a population moved s refresh steps
    # along the discriminant direction, then one refit on the moved data
    mu_d = aux0.mu1 - aux0.mu2
    norm = float(mu_d.norm())
    direction, step = mu_d / max(norm, 1e-9), 0.35 * norm

    def accuracy(pred):
        return float((pred == lab).float().mean())

    stale = [rt.classify(z + s * step * direction) for s in range(S.max_stale + 1)]
    out["staleness"] = [accuracy(pred) for pred, _ in stale]
    shift = S.max_stale * step * direction
    xs_, ys_ = synthetic.sample_two_class(gen, problem, S.n_refreshed, S.n_refreshed,
                                          device=dev)
    aux_s = suff_stats(xs_ + shift, ys_ + shift)
    res_s, log_s = st.refit_with_escalation(st.head_stats_of(aux_s), S.lam, S.lam_prime, cfg,
                                            None)
    out["refreshed_ladder"] = rungs(log_s)
    out["served"] = {f"staleness s={s}": served for s, served in enumerate(stale)}
    out["refreshed"] = None  # the ladder ran out: the server keeps its stale slot
    if res_s is not None:
        slot = st.slot_from_stats(aux_s, res_s.beta_tilde, S.threshold, version=99)
        refreshed = st.classify_batch(z + shift, slot.beta, slot.means, slot.priors)
        out["refreshed"] = accuracy(refreshed[0])
        out["served"]["refreshed"] = refreshed
    # warm against cold on the seed statistics merged with a 150 + 150 batch
    bx, by = synthetic.sample_two_class(gen, problem, S.n_warm, S.n_warm, device=dev)
    hs = st.head_stats_of(st.merge_suff_stats(rt.aux, suff_stats(bx, by)))
    warm = st.refit_step(hs, S.lam, S.lam_prime, cfg, carry=rt.carry)
    cold = st.refit_step(hs, S.lam, S.lam_prime, cfg)
    out["warm_iters"], out["cold_iters"] = (
        int(r.iters_beta.max()) + int(r.iters_theta.max()) for r in (warm, cold))
    out["warm_drift"] = float((warm.beta_tilde - cold.beta_tilde).abs().max())
    out["stages_ms"] = [refit_stages(rt, hs, cfg) for _ in range(3)]
    # the chaos runs: one plan, one stream (a generator of its own, reseeded a run)
    plan = st.ServeFaultSchedule(S.corrupt, S.diverge, S.drop, seed=S.fault_seed).plan(S.ticks)
    out["plan"] = {k: v.tolist() for k, v in plan._asdict().items()}
    out["runs"] = {}
    def chaos_run(protect, faulted, ckpt=None):
        tgen = torch.Generator(device=dev).manual_seed(SEED + 9)

        def tick():
            batch = synthetic.sample_two_class(tgen, problem, S.ingest, S.ingest, device=dev)
            return (batch, *synthetic.sample_labeled(tgen, problem, S.batch, device=dev))

        rtc = st.ServingRuntime(aux0, S.lam, S.lam_prime, S.threshold, protect=protect,
                                ckpt_dir=ckpt, **kw)
        return rtc, list(serve.serve_ticks(rtc, tick, lambda arrs: suff_stats(*arrs), S.ticks,
                                           S.refit_every, plan if faulted else None))

    for name, protect, faulted in (("clean", True, False), ("protected", True, True),
                                   ("unprotected", False, True)):
        (rtc, recs), wall = sync_time(lambda: chaos_run(
            protect, faulted, ckpt_dir if name == "clean" else None))
        out["runs"][name] = {
            "accuracy": sum(r["accuracy"] for r in recs) / len(recs),
            "finite": all(r["finite"] for r in recs), "wall_s": wall,
            **{key: [r[key] for r in recs] for key in ("status", "version", "accepted",
                                                       "refreshed")},
            "ladder": rungs(rtc.ladder_log), "beta": 2 * rtc.slot.beta[:, 0], "rt": rtc}
        out["served"].update({f"{name} tick {r['t']}": (r["pred"], r["scores"]) for r in recs})
    out["rerun_clean"] = lambda: chaos_run(True, False)
    if ckpt_dir is not None:
        # (i-4): the clean run saved a snapshot at every publish; a torn newer file and a
        # stray .tmp are skipped, and the newest restores onto the card with the live
        # runtime's predictions
        live = out["runs"]["clean"]["rt"]
        newest = latest_step(ckpt_dir)
        good = open(os.path.join(ckpt_dir, f"step_{newest:09d}.npz"), "rb").read()
        with open(os.path.join(ckpt_dir, f"step_{newest + 1:09d}.npz"), "wb") as f:
            f.write(good[: len(good) // 2])
        with open(os.path.join(ckpt_dir, "stray.tmp"), "wb") as f:
            f.write(good)
        skipped = latest_step(ckpt_dir) == newest == int(live.slot.version)
        restored, restore_s = sync_time(lambda: st.ServingRuntime.restore(
            ckpt_dir, aux0, S.lam, S.lam_prime, S.threshold, **kw))
        save_ms = [1e3 * sync_time(lambda: save_checkpoint(ckpt_dir, 10**6, live.snapshot()))[1]
                   for _ in range(3)]
        out["checkpoint"] = {
            "files": len([f for f in os.listdir(ckpt_dir) if f.endswith(".npz")]),
            "newest": newest, "live_version": int(live.slot.version),
            "skipped_torn": skipped,
            "restored_version": int(restored.slot.version), "restore_ms": 1e3 * restore_s,
            "save_ms": save_ms, "bytes": len(good),
            "same_predictions": torch.equal(live.classify(z)[0], restored.classify(z)[0])}
    return out


def serving_multiclass(dev) -> dict:
    """Run (i-3): the K-class stream (K = 5, fused), a seed fit, 8 ticks with a refresh
    every 4, accuracy on 2,000 held-out draws, and the two op contracts."""
    from repro_torch.core import streaming as st
    from repro_torch.core.dantzig import DantzigConfig
    from repro_torch.launch import serve
    from repro_torch.stats import synthetic

    S = SERVING
    cfg = DantzigConfig(tol=S.tol, fused=True)
    mcp = synthetic.make_mc_problem(d=S.d, num_classes=S.classes, n_signal=S.mc_n_signal,
                                    rho=S.mc_rho, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    aux0, tick, stats_of = serve.mc_stream(gen, mcp, S.classes, 4 * S.ingest, S.ingest,
                                           S.batch, device=dev)
    rt, seed_s = sync_time(lambda: st.ServingRuntime(
        aux0, S.lam, S.lam_prime, S.threshold, cfg=cfg, staleness_bound=S.staleness_bound,
        escalation=st.EscalationPolicy(refactor_scale=S.mc_refactor_scale), device=dev))
    recs, wall = sync_time(lambda: list(serve.serve_ticks(rt, tick, stats_of, S.mc_ticks,
                                                          S.mc_refit_every)))
    z, lab = synthetic.sample_mc_machines(gen, mcp, 1, S.n_test, device=dev)
    held_out = rt.classify(z[0])
    served = {f"tick {r['t']}": (r["pred"], r["scores"]) for r in recs}
    served["held out"] = held_out
    return {"problem": mcp, "seed_fit_s": seed_s, "wall_s": wall, "served": served,
            "accuracy": [r["accuracy"] for r in recs],
            "held_out": float((held_out[0] == lab[0]).float().mean()),
            **{key: [r[key] for r in recs] for key in ("status", "version", "refreshed")},
            "finite": all(r["finite"] for r in recs), "ladder": rungs(rt.ladder_log),
            "beta": rt.slot.beta,
            "contracts": serving_contracts(rt, z[0], (st.head_stats_of(rt.aux), S.lam,
                                                      S.lam_prime, cfg, rt.carry))}


def served_gaps(got: dict, want: dict) -> dict:
    """Each served batch against the plain run's: the largest score gap over the
    largest score (finite batches), and the predictions that differ, split into those at
    a near-tie (the plain run's margin between its two best classes at most twice the
    batch's largest score gap) and the rest."""
    out = {"worst_gap": 0.0, "flips": 0, "unexplained": 0, "queries": 0}
    for key, (pred, scores) in got.items():
        p_pred, p_scores = want[key]
        if not bool(torch.isfinite(p_scores).all()):
            continue
        gap = float((scores - p_scores).abs().max())
        out["worst_gap"] = max(out["worst_gap"], gap / max(float(p_scores.abs().max()), 1e-30))
        top2 = p_scores.topk(2, dim=-1).values
        differ = pred != p_pred
        out["flips"] += int(differ.sum())
        out["unexplained"] += int((differ & (top2[:, 0] - top2[:, 1] > 2 * gap)).sum())
        out["queries"] += pred.numel()
    return out


def serving_holds(tag: str, got: dict, want: dict, l2_pin: float) -> None:
    """Run (i)'s holds of one part against the same part on the plain versions: the
    slots' versions, statuses, quarantine flags and ladder rungs equal; every served
    score within ``l2_pin`` of the plain run's (relative to the largest) and every
    prediction equal but at a near-tie, where the two runs' rounding may part them (so
    accuracy equal up to those); the published direction's F1 equal and its l2 error
    within ``l2_pin``; warm and cold refit iterations within a residual check a solve of
    the plain run's.  Within the part: the op contracts, protected within the slack of
    clean and finite, the unprotected run degraded, the warm refit within the drift
    budget of the cold one, the fault plan firing, and the checkpoints (i-4)."""
    from repro_torch.core.classifier import estimation_errors, f1_score

    S = SERVING
    truth = getattr(got["problem"], "beta_star", None)
    if truth is None:
        truth = got["problem"].betas
    check(got["contracts"]["violations"] == [],
          f"{tag}: op contracts violated: {got['contracts']['violations']}")
    # the plain versions' own products and launches aside (K3's plain version is eager
    # PyTorch), both runs reach the same eigh, collectives and f64
    for call in ("classify", "refit_step"):
        mine, plain = ({k: c[call][k] for k in ("eigh", "collectives", "float64")}
                       for c in (got["contracts"], want["contracts"]))
        check(mine == plain, f"{tag}: {call} op counts {mine} differ from the plain run's {plain}")
    gaps = served_gaps(got["served"], want["served"])
    print(f"  {tag}: served scores against the plain run's: largest gap {gaps['worst_gap']:.3e} "
          f"of the largest score; {gaps['flips']} of {gaps['queries']} predictions differ, "
          f"{gaps['unexplained']} of them not at a near-tie")
    check(gaps["worst_gap"] <= l2_pin, f"{tag}: served scores {gaps['worst_gap']} > {l2_pin} "
                                       f"from the plain run's")
    check(gaps["unexplained"] == 0, f"{tag}: {gaps['unexplained']} predictions differ from the "
                                    f"plain run's away from a near-tie")
    runs = got.get("runs", {"stream": got})
    plain_runs = want.get("runs", {"stream": want})
    for name, run in runs.items():
        p = plain_runs[name]
        for key in ("status", "version", "refreshed", "ladder", "accepted"):
            if key in run:
                check(run[key] == p[key], f"{tag} {name}: {key} differs from the plain run: "
                                          f"{run[key]} vs {p[key]}")
        if name == "unprotected":
            continue
        check(run["finite"], f"{tag} {name}: non-finite served scores")
        f1, f1p = float(f1_score(run["beta"], truth)), float(f1_score(p["beta"], truth))
        l2 = float(estimation_errors(run["beta"], truth)["l2"])
        l2p = float(estimation_errors(p["beta"], truth)["l2"])
        print(f"  {tag} {name}: published direction F1 {f1:.4f} vs {f1p:.4f}, l2 {l2:.5f} vs "
              f"{l2p:.5f} (gap {abs(l2 - l2p):.3e}), max |beta - plain| "
              f"{float((run['beta'] - p['beta']).abs().max()):.3e}")
        check(f1 == f1p, f"{tag} {name}: F1 differs from the plain run")
        check(abs(l2 - l2p) <= l2_pin, f"{tag} {name}: l2 gap {abs(l2 - l2p)} > {l2_pin}")
    if "runs" not in got:
        return
    check(got["seed_ladder"] == want["seed_ladder"], f"{tag}: seed-fit rungs differ")
    check(got["refreshed_ladder"] == want["refreshed_ladder"],
          f"{tag}: the refreshed refit's rungs {got['refreshed_ladder']} differ from the plain "
          f"run's {want['refreshed_ladder']}")
    r = runs
    check(r["protected"]["accuracy"] >= r["clean"]["accuracy"] - S.acc_slack,
          f"{tag}: protected accuracy {r['protected']['accuracy']} more than {S.acc_slack} "
          f"under clean {r['clean']['accuracy']}")
    check(not r["unprotected"]["finite"]
          or r["unprotected"]["accuracy"] < r["clean"]["accuracy"] - S.acc_slack,
          f"{tag}: the unprotected run did not degrade")
    # warm against cold: the counts the plain versions executed (within a residual check
    # a solve), and the warm solution within the benchmark's drift budget of the cold one;
    # whether warm runs fewer is reported, not held (the reference's own benchmark at
    # d = 120 runs warm 400 against cold 390 iterations)
    for key in ("warm_iters", "cold_iters"):
        check(abs(got[key] - want[key]) <= 2 * CHECK_EVERY,
              f"{tag}: {key} {got[key]} against the plain run's {want[key]}")
    check(got["warm_drift"] <= S.warm_drift,
          f"{tag}: warm against cold drift {got['warm_drift']} > {S.warm_drift}")
    plan = got["plan"]
    check(any(plan["corrupt"]) and any(plan["diverge"]) and any(plan["drop"]),
          f"{tag}: the fault plan fired no corruption, divergence or drop: {plan}")
    ck = got.get("checkpoint")
    if ck is not None:
        check(ck["skipped_torn"], f"{tag}: latest_step did not skip the torn file: {ck}")
        check(ck["same_predictions"] and ck["restored_version"] == ck["live_version"],
              f"{tag}: the restored runtime differs from the live one: {ck}")


def serving_summary(tag: str, got: dict, card: str) -> None:
    """Print one part of run (i)."""
    if "runs" not in got:
        print(f"[serving {tag}] ({card}) seed fit {got['seed_fit_s']:.3f} s, {SERVING.mc_ticks} "
              f"ticks {got['wall_s']:.3f} s; versions {got['version']}, statuses "
              f"{got['status']}; ladder {got['ladder']}; accuracy by tick {got['accuracy']}, "
              f"held out {got['held_out']:.4f}; op counts {json.dumps(got['contracts'])}")
        return
    runs = {name: {k: v for k, v in run.items() if k not in ("beta", "rt")}
            for name, run in got["runs"].items()}
    print(f"[serving {tag}] ({card}) seed fit {got['seed_fit_s']:.3f} s, rungs "
          f"{got['seed_ladder']}\n  classify at B = {SERVING.batch}: {got['classify_ms']:.4f} ms "
          f"(CUDA events, {SERVING.qps_reps} back to back), {got['qps']:,.0f} qps; host "
          f"{got['classify_host_us']:.1f} us a call\n  op counts {json.dumps(got['contracts'])}"
          f"\n  staleness accuracy s = 0..{SERVING.max_stale}: {got['staleness']}, refreshed "
          f"{got['refreshed']} (rungs {got['refreshed_ladder']})\n  warm {got['warm_iters']} "
          f"vs cold {got['cold_iters']} iterations, drift {got['warm_drift']:.3e}\n  refit "
          f"stages, ms: "
          f"{json.dumps(got['stages_ms'])}\n  fault plan {json.dumps(got['plan'])}")
    if "busy_share" in got:
        print(f"  the device's busy share of the clean run, run again under the profiler: "
              f"{got['busy_share']:.4f}")
    for name, run in runs.items():
        print(f"  {name}: accuracy {run['accuracy']:.6f}, finite {run['finite']}, wall "
              f"{run['wall_s']:.3f} s; versions {run['version']}; statuses {run['status']}; "
              f"accepted {run['accepted']}; ladder {run['ladder']}")
    if "checkpoint" in got:
        print(f"  checkpoints: {json.dumps(got['checkpoint'])}")


def run_serving(dev, card_line: str, held: set) -> tuple[dict, dict, collections.Counter]:
    """Run (i): each part with its launches reset before and read after, then again with
    the plain versions of K1 and K3 on the card and held against that; (i-4), the
    checkpoints, rides on (i-2)'s clean chaos run, its snapshots removed after.  Returns
    each part's results, its launches, and run (i)'s launches by (kernel, *shape)."""
    import os
    import shutil

    from repro_torch.kernels import ops

    ckpt_root = os.path.join(os.path.dirname(os.path.abspath(__file__)), SERVING_CKPT)
    shutil.rmtree(ckpt_root, ignore_errors=True)
    parts = {"(i-1) scan, adaptive rho": lambda ck: serving_binary(dev, False),
             "(i-2) fused (K3)": lambda ck: serving_binary(dev, True, ck),
             "(i-3) K-class, fused": lambda ck: serving_multiclass(dev)}
    serving, serving_launch, serving_tally = {}, {}, collections.Counter()
    tags = list(parts)
    for tag, fn in parts.items():
        ops.reset_launches()
        got = fn(os.path.join(ckpt_root, "kernels"))
        serving_launch[tag] = dict(ops.LAUNCHES)
        shapes = collections.Counter(ops.LAUNCH_SHAPES)
        serving_tally.update(shapes)
        rerun = got.pop("rerun_clean", None)
        if tag == tags[1]:
            # the fused clean run once more, under the profiler and outside the counts (a
            # profiled scan run takes minutes: thousands of small launches a refit)
            got["busy_share"] = busy_share(rerun)
        ops.reset_launches()
        with plain_versions():
            want = fn(os.path.join(ckpt_root, "plain"))
        want.pop("rerun_clean", None)
        check(not any(ops.LAUNCHES.values()), f"run {tag}: the plain run launched {ops.LAUNCHES}")
        serving_summary(tag, got, card_line)
        print(f"  launches {json.dumps(serving_launch[tag])}; by (kernel, *shape) "
              f"{json.dumps({str(k): v for k, v in sorted(shapes.items())})}; against the "
              f"plain versions on the card:")
        serving_holds(tag, got, want, 1e-3)
        serving[tag] = got
    shutil.rmtree(ckpt_root, ignore_errors=True)
    tag1, tag2, tag3 = parts
    check(serving_launch[tag1]["gram"] > 0 and serving_launch[tag1]["dantzig_fused_state"] == 0,
          f"run {tag1}: launched {serving_launch[tag1]}, not K1 alone")
    check(serving_launch[tag2]["gram"] > 0 and serving_launch[tag2]["dantzig_fused_state"] > 0,
          f"run {tag2}: launched {serving_launch[tag2]}, not K1 and K3")
    check(serving_launch[tag3]["dantzig_fused_state"] > 0 and serving_launch[tag3]["gram"] == 0,
          f"run {tag3}: launched {serving_launch[tag3]}, not K3 alone")
    for tag in parts:
        check(serving_launch[tag]["dantzig_fused"] == 0
              and serving_launch[tag]["soft_threshold"] == 0,
              f"run {tag}: launched K2 or K4: {serving_launch[tag]}")
    unheld = sorted(key for key in serving_tally if key not in held)
    check(not unheld, f"run (i): launch shapes held against no plain version: {unheld}")
    print(f"[serving] run (i) launches by (kernel, *shape): "
          f"{json.dumps({str(k): v for k, v in sorted(serving_tally.items())})} ({card_line})")
    return serving, serving_launch, serving_tally


def serving_rows(sv, tally, k1_err: dict, card_line: str) -> tuple[list, dict]:
    """Phase 4 at run (i)'s launch shapes: K1 at each batch size and K3 at each shape and
    iteration count at run (i)'s gate, cold and warm (launches there, time, bound)."""
    from repro_torch.kernels.gram import gram_cuda

    gram_serving = []
    for x in sv.k1.values():
        mu_x = x.mean(1)
        _, n_, d_ = x.shape
        gram_serving.append({
            "shape": list(x.shape), "launches": tally[("gram", *x.shape)],
            "max_abs_err": k1_err[tuple(x.shape)],
            "ms": cuda_ms(lambda: gram_cuda(x, mu_x), 50),
            "bound_ms": bound(n_ * d_ * (d_ + 1) + n_ * d_, 4 * (n_ * d_ + d_ + d_ * d_))[0],
            **time_split(lambda: gram_cuda(x, mu_x), 100, 1000)})
        gram_serving[-1]["x_bound"] = gram_serving[-1]["device_ms"] / gram_serving[-1]["bound_ms"]
    k3_serving = {}
    for label, op in sv.k3.items():
        info = launch_shape(*op.b.shape, True)
        for iters in op.iters:
            for start_name, start in (("cold", None), ("warm", op.start)):
                r = shape_row(op.fac, op.b, op.lam, info, True, iters, tally,
                              tol=SERVING.tol, start=start)
                r["x_bound"] = r["device_ms"] / r["bound_ms"]
                k3_serving[f"{label} {iters} it. {start_name}"] = r
    print(f"[times] run (i) launch shapes ({card_line}), K1: {json.dumps(gram_serving)}\n  K3: "
          f"{json.dumps(k3_serving)}")
    return gram_serving, k3_serving


def analysis_kernel_checks(dev) -> set:
    """Phase 2 at runs (j) and (k)'s launch shapes, on random inputs from their own
    generator: K1 at each (rows, d) within 1e-5 of the largest entry and exactly symmetric,
    and K2 and K3 at each (d, k) through the edge shapes' checks.  Returns the
    (kernel, *shape) keys held."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.gram import gram_cuda

    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    held, worst = set(), 0.0
    for n_, d_ in LINT_K1 + ((DRY.n // 2, DRY.d),):
        x = torch.randn(1, n_, d_, generator=gen, device=dev)
        got, want = gram_cuda(x, x.mean(1)), ref.gram_ref(x, x.mean(1))
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        worst = max(worst, err / scale)
        check(err <= 1e-5 * scale, f"K1 runs (j)-(k) (1, {n_}, {d_}): err {err} > 1e-5 * {scale}")
        check(torch.equal(got, got.mT), f"K1 runs (j)-(k) (1, {n_}, {d_}): not symmetric")
        held.add(("gram", 1, n_, d_))
    print(f"[kernels] K1 at runs (j)-(k)'s shapes: largest err / max |G| {worst:.3e}")
    for shapes, iters in ((LINT_ADMM, LINT_ITERS), (DRY_ADMM, DRY.iters)):
        for d_, k_ in shapes:
            edge_shape_checks(f"runs (j)-(k) d={d_} k={k_}", d_, k_, 1, iters, 2 * iters // 5,
                              gen)
            held |= {(kernel, 1, d_, k_) for kernel in ("dantzig_fused", "dantzig_fused_state")}
    return held


def run_lint(card_line: str) -> tuple[collections.Counter, set, float]:
    """Run (j): every case of the op-contract lint on the card, the mesh cases on gloo
    ranks all on this card.  Returns its counted kernel launches by (kernel, *shape) -- on
    the card the contracts hold every counted call to one launch --, the shapes this
    process launched at (the cases' set-up included) and its seconds."""
    import io

    from repro_torch.analysis import lint
    from repro_torch.kernels import ops

    ops.reset_launches()
    shapes, buf = collections.Counter(), io.StringIO()
    failures, seconds = sync_time(lambda: lint.run(device="cuda", out=buf, shapes=shapes))
    report = buf.getvalue()
    print("[lint] run (j), python -m repro_torch.analysis.lint on the card:")
    print("\n".join("  " + line for line in report.splitlines()))
    n_ok = report.count("  [ok] ")
    check(failures == 0, f"run (j): {failures} lint failure(s)")
    check(n_ok == LINT_CASES, f"run (j): {n_ok} cases [ok], not {LINT_CASES}")
    # the cases' own statistics launch K1 in this process outside the counted calls
    building = collections.Counter(ops.LAUNCH_SHAPES)
    print(f"[lint] run (j): {seconds:.2f} s, {n_ok} of {LINT_CASES} cases [ok]; counted kernel "
          f"launches by (kernel, *shape), every rank: "
          f"{json.dumps({str(k): v for k, v in sorted(shapes.items())})}; this process's "
          f"launches, the cases' set-up included: "
          f"{json.dumps({str(k): v for k, v in sorted(building.items())})} ({card_line})")
    return shapes, set(building), seconds


def run_dry(card_line: str) -> tuple[collections.Counter, list, float]:
    """Run (k): ``python -m repro_torch.launch.dryrun_slda`` at the reference's defaults,
    both meshes and both variants, in a child process (the fake process group is
    process-wide) that only loads the kernels built here.  Returns its kernel calls by
    (kernel, *shape), the four results and its seconds."""
    import ast
    import os
    import tempfile

    from repro_torch.kernels import build

    build.build()
    code = ("import sys\nfrom repro_torch.kernels import build\nbuild.forbid_builds()\n"
            "from repro_torch.launch import dryrun_slda\n"
            "for variant in ('baseline', 'fused'):\n"
            "    dryrun_slda.main(sys.argv[1:] + ['--variant', variant])\n")
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", code, "--d", str(DRY.d), "--n", str(DRY.n),
                               "--iters", str(DRY.iters), "--mesh", "both", "--out", out],
                              capture_output=True, text=True, timeout=600, cwd=root)
        seconds = time.perf_counter() - t0
        print("[dryrun] run (k), python -m repro_torch.launch.dryrun_slda --mesh both, "
              f"baseline and fused: {seconds:.2f} s")
        print("\n".join("  " + line for line in proc.stdout.splitlines()))
        check(proc.returncode == 0, f"run (k) exited {proc.returncode}: {proc.stderr[-3000:]}")
        results = [json.load(open(os.path.join(out, name))) for name in sorted(os.listdir(out))]
    check(len(results) == 4, f"run (k): {len(results)} results, not 4")
    calls = collections.Counter()
    for r in results:
        shapes = {ast.literal_eval(k): n for k, n in r["calls"].items()}
        calls.update(shapes)
        tag = f"{r['mesh']} {r['variant']}"
        print(f"  {tag}: rank 0 {r['wall_s']} s (counted call {r['counted_call_s']:.3f} s),"
              f" peak {r['peak_memory_bytes']} B ({r['peak_above_resident_bytes']} B above "
              f"what was resident), {r['flops_per_device']:.4e} FLOP "
              f"({r['kernel_flops']:.4e} in the kernels), {r['bytes_per_device']:.4e} B, "
              f"launches {json.dumps(r['launches'])} by shape {json.dumps(r['calls'])}, link "
              f"bits {json.dumps(r['link_bits'])} (paper {8 * r['paper_uplink_bytes']} on the "
              f"data axis; by hop {json.dumps(r['wire_bits_by_hop'])}), roofline "
              f"{r['compute_s']:.3e} / {r['memory_s']:.3e} / {r['collective_s']:.3e} s "
              f"({r['dominant']}) ({card_line})")
        check(r["device"] == torch.cuda.get_device_name(0), f"run (k) {tag}: ran on {r['device']}")
        check(sum(r["launches"].values()) == sum(shapes.values()),
              f"run (k) {tag}: launches {r['launches']} are not its calls {r['calls']}")
        want = {("gram", 1, DRY.n // 2, DRY.d): 2}
        if r["variant"] == "fused":
            want.update({("dantzig_fused", 1, d_, k_): 1 for d_, k_ in DRY_ADMM})
        check(shapes == want, f"run (k) {tag}: called {shapes}, expected {want}")
    return calls, results, seconds


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check runs on an NVIDIA card")

    from repro_torch.core import classifier, pipeline
    from repro_torch.core.dantzig import DantzigConfig
    from repro_torch.core.path import (
        select_by_kkt,
        solve_dantzig_path,
        take_lambda,
        worker_debiased_path,
    )
    from repro_torch.core.slda import debiased_local_estimator_path, tune_lambda_validation
    from repro_torch.core.distributed import (
        simulated_distributed_slda,
        simulated_naive_averaged_slda,
    )
    from repro_torch.core.clime import solve_clime_columns
    from repro_torch.core.compression import Compression, dense_uplink_bits
    from repro_torch.core.faults import Aggregation, FaultSchedule
    from repro_torch.core.multiclass import (
        centralized_mc_slda,
        mc_debiased_local_path,
        simulated_distributed_mc_slda,
        simulated_naive_mc_slda,
    )
    from repro_torch.core.rounds import simulate_multi_round, simulate_round_loop
    from repro_torch.core.slda import centralized_slda, hard_threshold
    from repro_torch.core.transport import CommPlan, Transport
    from repro_torch.core.solver_dispatch import solve_dantzig
    from repro_torch.kernels import _launch, build, ops, ref
    from repro_torch.kernels.dantzig_fused import (
        CLUSTER_SIZES,
        cluster_fits,
        dantzig_fused_cuda,
        dantzig_fused_state_cuda,
        plan_launch,
    )
    from repro_torch.kernels.gram import gram_cuda
    from repro_torch.kernels.soft_threshold import _SHRINK, soft_threshold_cuda
    from repro_torch.kernels.spectral import spectral_factor
    from repro_torch.quickstart import format_table, metrics, tuning
    from repro_torch.stats import synthetic

    dev = torch.device(DEVICE)
    print(f"torch {torch.__version__}  cuda {torch.version.cuda}  "
          f"card {torch.cuda.get_device_name(0)}  python {sys.version.split()[0]}")

    # ---- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    seconds = build.build()
    for name in build.SOURCES:
        for line in build.log_path(name).read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    print(f"[build] nvcc {json.dumps({k: round(v, 2) for k, v in seconds.items()})}  "
          f"total {time.perf_counter() - t0:.2f} s")

    # ---- main-path inputs (the paper's §5.1 design) -------------------------
    problem = synthetic.make_problem(d=D, n_signal=N_SIGNAL, rho=RHO, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    n1 = n2 = N_PER // 2
    xs, ys = synthetic.sample_machines(gen, problem, M, n1, n2, device=dev)
    z, labels = synthetic.sample_labeled(gen, problem, N_TEST, device=dev)
    lam, lam_c, t = tuning(problem.beta_star, D, N_PER, M * N_PER)
    mu1_all, mu2_all = xs.reshape(-1, D).mean(0), ys.reshape(-1, D).mean(0)
    # runs (d) and (e) draw from their own generators
    mc = multiclass_inputs(dev)
    rd = rounds_inputs(dev, problem)
    K_MC, D_MC = MULTICLASS.num_classes, MULTICLASS.d

    # ---- 2. kernels against their plain versions ---------------------------
    errs = {}
    mu1 = xs.mean(1)
    for label, (x, mu) in {
        "main": (xs, mu1),
        "ragged": (lambda r: (r, r.mean(1)))(
            torch.randn(3, 37, 203, generator=gen, device=dev)),
    }.items():
        got, want = gram_cuda(x, mu), ref.gram_ref(x, mu)
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        print(f"[kernels] K1 gram {label} {tuple(x.shape)}: max abs err {err:.3e} "
              f"(max |G| {scale:.3e}), symmetric {bool(torch.equal(got, got.mT))}")
        # f32 sums in another order than cuBLAS's: 1e-5 of the largest entry
        check(err <= 1e-5 * scale, f"K1 {label}: err {err} > 1e-5 * {scale}")
        check(torch.equal(got, got.mT), f"K1 {label}: not exactly symmetric")
        errs.setdefault("gram", err)
    # the edge shapes draw from their own generator: gen's stream stays the main path's
    side = torch.Generator(device=dev).manual_seed(SEED + 1)
    k1_cases = {f"d={d} n={n}": torch.randn(3, n, d, generator=side, device=dev)
                for d in (1, 3, 4, 200, 203, 256) for n in (1, 31, 250)}
    # a contiguous view one float past a 16-byte boundary takes the 4-byte copies
    k1_cases["d=200 n=31 misaligned"] = torch.randn(
        3 * 31 * 200 + 1, generator=side, device=dev)[1:].view(3, 31, 200)
    worst = 0.0
    for label, x in k1_cases.items():
        mu = x.mean(1) + 0.1 * torch.randn(x.shape[0], x.shape[2], generator=side, device=dev)
        got, want = gram_cuda(x, mu), ref.gram_ref(x, mu)
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        worst = max(worst, err / scale)
        check(err <= 1e-5 * scale, f"K1 {label}: err {err} > 1e-5 * {scale}")
        check(torch.equal(got, got.mT), f"K1 {label}: not exactly symmetric")
    print(f"[kernels] K1 gram at {len(k1_cases)} edge shapes (d in 1, 3, 4, 200, 203, 256 x "
          f"n in 1, 31, 250, and misaligned): largest err / max |G| {worst:.3e}")
    # K1 at the launch shapes of the mesh runs, one machine a rank: a class's
    # rows of run (f) (250, d = 200), (g) (250, d = 128) and (h) (2,500, d = 200)
    k1_gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    k1_mesh = {}
    for n_, d_ in ((n1, D), (250, 128), (SYNTHETIC.N // MESH_H[0] // 2, D)):
        x = torch.randn(1, n_, d_, generator=k1_gen, device=dev)
        mu = x.mean(1)
        got, want = gram_cuda(x, mu), ref.gram_ref(x, mu)
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        check(err <= 1e-5 * scale, f"K1 mesh (1, {n_}, {d_}): err {err} > 1e-5 * {scale}")
        check(torch.equal(got, got.mT), f"K1 mesh (1, {n_}, {d_}): not exactly symmetric")
        k1_mesh[(1, n_, d_)] = {"x": x, "mu": mu, "max_abs_err": err, "max_abs_G": scale}
    print("[kernels] K1 gram at the mesh launch shapes: " + ", ".join(
        f"{shape} err {v['max_abs_err']:.3e} (max |G| {v['max_abs_G']:.3e})"
        for shape, v in k1_mesh.items()))

    stats = pipeline.suff_stats(xs, ys, use_kernel=False)
    factor = spectral_factor(stats.sigma)
    q = factor.q.contiguous()  # cuSOLVER returns the eigenvectors column-major
    eye = torch.eye(D, device=dev).expand(M, D, D).contiguous()
    rho_cols = torch.ones(M, D, device=dev)
    x_shrink = factor.q @ eye  # a (m, d, d) block of the scan's shape
    t_cols = 0.05 + 0.1 * torch.rand(M, 1, D, generator=gen, device=dev)
    clime_lam = torch.full((M, D), lam, device=dev)
    lams = torch.tensor([lam * 2.0 ** ((l - L_GRID // 2) / (L_GRID // 2)) for l in range(L_GRID)],
                        dtype=torch.float32, device=dev)
    fold_b = stats.mu_d.unsqueeze(-1).expand(M, D, L_GRID).contiguous()
    fold_lam = lams.expand(M, L_GRID).contiguous()

    # each takes the launchers' ``cluster`` (None: the cluster model's template)
    def k2_clime(**kw):
        return dantzig_fused_cuda(stats.sigma, q, factor.inv_eig, eye, clime_lam, rho_cols,
                                  iters=ITERS, alpha=1.7, **kw)

    def k2_direction(**kw):
        return dantzig_fused_cuda(stats.sigma, q, factor.inv_eig,
                                  stats.mu_d.unsqueeze(-1).contiguous(),
                                  clime_lam[:, :1].contiguous(), rho_cols[:, :1].contiguous(),
                                  iters=ITERS, alpha=1.7, **kw)

    # K3 on the cold lambda path's CLIME block and direction fold
    def k3_clime(**kw):
        return dantzig_fused_state_cuda(stats.sigma, q, factor.inv_eig, eye, clime_lam,
                                        rho_cols, None, iters=ITERS, alpha=1.7, tol=PATH_TOL,
                                        check_every=CHECK_EVERY, **kw)

    def k3_fold(**kw):
        return dantzig_fused_state_cuda(stats.sigma, q, factor.inv_eig, fold_b, fold_lam,
                                        rho_cols[:, :L_GRID].contiguous(), None, iters=ITERS,
                                        alpha=1.7, tol=PATH_TOL, check_every=CHECK_EVERY, **kw)

    # the four K2/K3 calls of the main path: (function, k, K3)
    main_calls = {"K2 CLIME": (k2_clime, D, False), "K2 k=1": (k2_direction, 1, False),
                  "K3 CLIME": (k3_clime, D, True), "K3 fold": (k3_fold, L_GRID, True)}

    for label, tt in (("scalar t", 0.05), ("per-column t", t_cols)):
        got, want = soft_threshold_cuda(x_shrink, tt), ref.soft_threshold_ref(x_shrink, tt)
        print(f"[kernels] K4 shrink {label}: bit-identical {same_bits(got, want)}")
        check(same_bits(got, want), f"K4 {label}: differs from the plain version")
        errs["soft_threshold"] = max(errs.get("soft_threshold", 0.0),
                                     float((got - want).abs().max()))
    col = x_shrink[..., :1].contiguous()
    check(same_bits(soft_threshold_cuda(col, t_cols[..., :1]),
                    ref.soft_threshold_ref(col, t_cols[..., :1])), "K4 (m, d, 1) differs")
    # edge values, at scalar and per-column t: +-0, +-inf, NaN, |x| == t and its
    # neighbours, on shapes with c % 4 in {0, 1, 2, 3}, a numel that fills no
    # whole block, 1-D input and a misaligned view
    k4_shapes = {"main (20, 200, 200)": (M, D, D), "c%4=1 (3, 7, 5)": (3, 7, 5),
                 "c%4=2 (3, 9, 6)": (3, 9, 6), "c%4=3 (2, 11, 7)": (2, 11, 7),
                 "ragged numel (3, 37, 20)": (3, 37, 20), "1-D (1001,)": (1001,),
                 "1-D (1000,)": (1000,), "misaligned (4, 64, 64)": (4, 64, 64)}
    edge = torch.tensor([0.0, -0.0, float("inf"), -float("inf"), float("nan"), 1e-30, -1e-30,
                         3e38, -3e38], device=dev)
    k4_failed = 0
    for label, shape in k4_shapes.items():
        numel = torch.Size(shape).numel()
        flat = torch.randn(numel + 1, generator=side, device=dev)
        flat = flat[1:] if label.startswith("misaligned") else flat[:-1]
        x = flat.view(shape)
        c = shape[-1]
        rows = (*shape[:-2], 1, c) if len(shape) >= 2 else (c,)
        t_col = 0.05 + 0.25 * torch.rand(rows, generator=side, device=dev)
        # |x| == t: the first two rows of every matrix hit their column's t, and
        # +-0.25 hits the scalar t
        if len(shape) >= 2:
            x[..., 0, :] = t_col[..., 0, :]
            x[..., 1, :] = -t_col[..., 0, :]
        else:
            x[:4] = t_col[:4] * torch.tensor([1.0, -1.0, 1.0, -1.0], device=dev)
        pos = torch.randperm(numel, generator=side, device=dev)[:len(edge) + 2]
        flat[pos] = torch.cat([edge, torch.tensor([0.25, -0.25], device=dev)])
        for t_label, tt in (("scalar t", 0.25), ("per-column t", t_col)):
            got, want = soft_threshold_cuda(x, tt), ref.soft_threshold_ref(x, tt)
            # with equal_nan, a NaN on one side only still fails; same_bits also
            # holds the sign of every zero
            try:
                torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
                if not same_bits(got, want):
                    raise AssertionError("a zero's sign differs")
            except AssertionError as exc:
                k4_failed += 1
                check(False, f"K4 edge {label} {t_label}: {exc}")
    # a per-column t that broadcasts from (1, c): the wrapper expands it
    x = torch.randn(3, 9, 8, generator=side, device=dev)
    t_row = 0.1 + torch.rand(1, 8, generator=side, device=dev)
    check(same_bits(soft_threshold_cuda(x, t_row), ref.soft_threshold_ref(x, t_row)),
          "K4 broadcast (1, c) t differs")
    print(f"[kernels] K4 shrink edge values at {len(k4_shapes)} shapes x scalar and per-column "
          f"t: {k4_failed} differ from the plain version (rtol 0, atol 0, NaN equal, the "
          f"sign of zero held)")

    def k2(b, block_k=None, iters=CHECK_ITERS):
        k = b.shape[-1]
        return dantzig_fused_cuda(stats.sigma, q, factor.inv_eig, b.contiguous(),
                                  torch.full((M, k), lam, device=dev),
                                  rho_cols[:, :k].contiguous(), iters=iters, alpha=1.7,
                                  block_k=block_k)

    def k2_plain(b):
        return ref.dantzig_fused_ref(stats.sigma, factor.q, factor.inv_eig, b, lam,
                                     iters=CHECK_ITERS, rho=1.0, alpha=1.7)

    pins = {}
    for label, b in (("CLIME k=200", eye), ("direction k=1", stats.mu_d.unsqueeze(-1))):
        got, want = k2(b), k2_plain(b)
        k = b.shape[-1]
        # the plain version's own spread: the same columns solved inside
        # a batch of 8 more, which sends cuBLAS a product of another width
        wide = k2_plain(torch.cat([b, eye[..., :8]], dim=-1))[..., :k]
        err = float((got - want).abs().max())
        spread = float((wide - want).abs().max())
        scale = float(want.abs().max())
        print(f"[kernels] K2 fused {label}, {CHECK_ITERS} iters: max abs err {err:.3e} "
              f"(max |w| {scale:.3e}; plain vs plain at another product width {spread:.3e}), "
              f"support equal {bool(((got != 0) == (want != 0)).all())}")
        # the repo's 1e-5 pin relative to the largest entry, or, where
        # the summation order alone moves the plain version further, no
        # more than twice that spread
        pins[label] = max(1e-5 * max(1.0, scale), 2 * spread)
        check(err <= pins[label], f"K2 {label}: err {err} > max(1e-5 * {scale}, 2 * {spread})")
        errs["dantzig_fused"] = max(errs.get("dantzig_fused", 0.0), err)
    full = k2(eye)
    bk = plan_launch(D, D).block_k
    same = {
        f"block_k=24 (tail of {D % 24})": torch.equal(k2(eye, block_k=24), full),
        f"one block of {bk}": torch.equal(k2(eye[..., :bk]), full[..., :bk]),
        "column 0 alone (k=1)": torch.equal(k2(eye[..., :1]), full[..., :1]),
    }
    print(f"[kernels] K2 default block_k={bk} bit-identical to: {json.dumps(same)}")
    check(all(same.values()), f"K2 output depends on the blocking: {same}")

    # K3 at the lambda path's shapes: the CLIME block (k = 200) and the
    # direction solve folded over the 8-point grid (k = 8, lam per column)
    shapes = {"CLIME k=200": (eye, torch.full((M, D), lam, device=dev)),
              "direction fold k=8": (fold_b, lams.expand(M, L_GRID).contiguous())}
    # the fold's pin as K2's: the plain version's own spread when the same
    # columns are solved inside a wider product
    fold_plain = ref.dantzig_fused_ref(stats.sigma, factor.q, factor.inv_eig, fold_b, lams,
                                       iters=CHECK_ITERS, rho=1.0, alpha=1.7)
    fold_wide = ref.dantzig_fused_ref(
        stats.sigma, factor.q, factor.inv_eig, torch.cat([fold_b, eye[..., :8]], dim=-1),
        torch.cat([lams, torch.full((8,), lam, device=dev)]), iters=CHECK_ITERS, rho=1.0,
        alpha=1.7)[..., :L_GRID]
    pins["direction fold k=8"] = max(1e-5 * max(1.0, float(fold_plain.abs().max())),
                                     2 * float((fold_wide - fold_plain).abs().max()))

    def k3(b, lam_cols, state=None, iters=CHECK_ITERS, tol=None):
        return dantzig_fused_state_cuda(stats.sigma, q, factor.inv_eig, b, lam_cols,
                                        rho_cols[:, :b.shape[-1]].contiguous(), state,
                                        iters=iters, alpha=1.7, tol=tol, check_every=CHECK_EVERY)

    def k3_plain(b, lam_cols, state=None, iters=CHECK_ITERS, tol=None, trace=None):
        bk = plan_launch(D, b.shape[-1], state_io=True).block_k
        return ref.dantzig_fused_state_ref(stats.sigma, factor.q, factor.inv_eig, b, lam_cols,
                                           iters=iters, rho=1.0, alpha=1.7, block_k=bk,
                                           tol=tol, check_every=CHECK_EVERY, state=state,
                                           trace=trace)

    for label, (b, lam_cols) in shapes.items():
        k = b.shape[-1]
        fixed = k3(b, lam_cols)
        k2_out = dantzig_fused_cuda(stats.sigma, q, factor.inv_eig, b, lam_cols,
                                    rho_cols[:, :k].contiguous(), iters=CHECK_ITERS, alpha=1.7)
        split = 2 * CHECK_ITERS // 5
        first = k3(b, lam_cols, iters=split)
        resumed = k3(b, lam_cols, state=first.state, iters=CHECK_ITERS - split)
        same_k2 = torch.equal(fixed.beta, k2_out)
        resume_exact = all(torch.equal(x, y) for x, y in zip(resumed.state, fixed.state))
        err = float((fixed.beta - k3_plain(b, lam_cols)[0]).abs().max())
        print(f"[kernels] K3 {label}, tol=None, {CHECK_ITERS} iters: bit-identical to K2 "
              f"{same_k2}; {split} + {CHECK_ITERS - split} resumed bit-identical to {CHECK_ITERS} "
              f"{resume_exact}; max abs err vs plain {err:.3e} (pin {pins[label]:.3e})")
        check(same_k2, f"K3 {label}: differs from K2 at tol=None from the zero state")
        check(resume_exact, f"K3 {label}: a resumed run differs from one straight run")
        check(fixed.iters.eq(CHECK_ITERS).all().item(), f"K3 {label}: tol=None counts differ")
        check(err <= pins[label], f"K3 {label} tol=None: err {err} > {pins[label]}")
        errs["dantzig_fused_state"] = max(errs.get("dantzig_fused_state", 0.0), err)
        warm_state = k3(b, lam_cols, iters=ITERS).state
        for start, state, tol in (("cold", None, PATH_TOL), (f"warm from {ITERS}", warm_state,
                                                              PATH_TOL),
                                  ("cold", None, LOOSE_TOL)):
            got = k3(b, lam_cols, state=state, tol=tol)
            trace = []
            want_w, _, want_iters = k3_plain(b, lam_cols, state=state, tol=tol, trace=trace)
            diff = got.iters - want_iters
            bk = plan_launch(D, k, state_io=True).block_k
            for mach, blk in diff.nonzero().tolist():
                n_k, n_p = int(got.iters[mach, blk]), int(want_iters[mach, blk])
                res = float(trace[min(n_k, n_p) // CHECK_EVERY - 1][mach, blk])
                print(f"  K3 {label} {start}: machine {mach} block {blk}: kernel {n_k} "
                      f"iterations, plain {n_p}; plain residual at iteration {min(n_k, n_p)}: "
                      f"{res:.6e} (tol {tol})")
                # where the gates part, w is held against the plain version
                # run for the kernel's count from the same start
                cols = slice(blk * bk, min(k, (blk + 1) * bk))
                want_w[mach, :, cols] = k3_plain(b, lam_cols, state=state,
                                                 iters=n_k)[0][mach, :, cols]
            n_diff = int((diff != 0).sum())
            check(n_diff <= 1, f"K3 {label} {start} tol {tol}: {n_diff} block counts differ")
            check(int(diff.abs().max()) <= CHECK_EVERY,
                  f"K3 {label} {start} tol {tol}: block counts differ by more than one chunk")
            err = float((got.beta - want_w).abs().max())
            print(f"[kernels] K3 {label}, tol={tol}, {start} start: block counts "
                  f"{sorted(set(got.iters.flatten().tolist()))} (plain "
                  f"{sorted(set(want_iters.flatten().tolist()))}), {n_diff} of {diff.numel()} "
                  f"differ; max abs err {err:.3e}")
            check(err <= pins[label], f"K3 {label} {start} tol {tol}: err {err} > {pins[label]}")
            errs["dantzig_fused_state"] = max(errs["dantzig_fused_state"], err)

    # ---- 2 (b). the fused template by launch shape ------------------------------
    # each main call's template (cluster size, micro-tile, shared memory per
    # block, the clusters the card keeps resident) and the SHA-256 of its
    # output bytes (K3: w, z, u1, u2, counts), on the cluster template and on
    # the streamed one (the first port's kernel, unchanged), each held to the
    # digests recorded from the first port
    launches_info, fit_sizes = {}, {}
    for name, (fn, k, state_io) in main_calls.items():
        launches_info[name] = info = launch_shape(M, D, k, state_io)
        fit_sizes[name] = [cs for cs in CLUSTER_SIZES
                           if cluster_fits(D, info["width"], cs, state_io)]
        got = digest(fn())
        info["sha256"] = got
        # every cluster size that fits, and the streamed template (0)
        same = {cs: digest(fn(cluster=cs)) == got for cs in fit_sizes[name] + [0]}
        print(f"[kernels] {name}: {json.dumps(info)}, {M * -(-k // info['block_k'])} "
              f"clusters; recorded sha256 {RECORDED_DIGESTS[name]}; bit-identical at "
              f"cluster size: {json.dumps(same)}")
        check(info["cluster"] > 0,
              f"{name}: the model sends the main shape to the streamed template")
        check(all(same.values()), f"{name}: cluster sizes differ bit for bit: {same}")
        check(got == RECORDED_DIGESTS[name],
              f"{name}: the output differs from the first port's kernel bit for bit")

    # edge shapes, each against its plain version within the K2 pin, across
    # blockings and templates bit for bit, and for K3: equal to K2 at
    # tol=None, a resume split exact, and a gate that stops some blocks early
    edge_gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    for label, d, k, m, iters, split in EDGE_SHAPES:
        edge_shape_checks(label, d, k, m, iters, split, edge_gen)
    # K2's d = 1,000 shapes on the streamed template, its model's wide tile held to
    # narrower blocks and to K3 bit for bit
    d1000 = d1000_inputs(edge_gen)
    d1000_checks(d1000)
    d1000_joined_checks(d1000, CHECK_ITERS)

    # the launch shapes runs (d) and (e) add, on their own statistics, at
    # CHECK_ITERS iterations: the K2 and K3 templates with the card's
    # occupancy, each kernel against its plain version across blockings and
    # templates, K3 at tol=None, across a resume and with a gate
    mc_hs = pipeline.MulticlassHead(K_MC).stats(mc.xs, mc.labels)
    mc_fac = spectral_factor(mc_hs.sigma)
    rd_stats = pipeline.suff_stats(rd.xs, rd.ys, use_kernel=False)
    rd_fac = spectral_factor(rd_stats.sigma)
    # (factor, b, lam per column) of each new launch shape; the fold is the
    # lambda path's: grid point l owns columns [l K, (l + 1) K)
    new_shapes = {
        "multiclass k=5": (mc_fac, mc_hs.rhs, mc.lam),
        "multiclass CLIME k=120": (mc_fac, torch.eye(D_MC, device=dev).expand(MULTICLASS.m, D_MC,
                                                                             D_MC), mc.lam),
        "multiclass fold k=40": (mc_fac, mc_hs.rhs.repeat(1, 1, MC_L_GRID),
                                 mc.lams.repeat_interleave(K_MC)),
        "rounds k=1 m=80": (rd_fac, rd_stats.mu_d.unsqueeze(-1), rd.lam),
        "rounds CLIME m=80": (rd_fac, torch.eye(D, device=dev).expand(ROUNDS.m, D, D), rd.lam),
    }
    new_ops, new_info = {}, {}
    for label, (fac, b, lam_v) in new_shapes.items():
        b = b.contiguous()
        m_, d_, k_ = b.shape
        lam_cols = torch.as_tensor(lam_v, dtype=torch.float32, device=dev).expand(m_, k_)
        new_ops[label] = (fac, b, lam_cols.contiguous())
        k3_info = shape_checks(label, fac, b, lam_cols.contiguous(), torch.ones(m_, k_, device=dev),
                               CHECK_ITERS, 2 * CHECK_ITERS // 5)
        k2_info = launch_shape(m_, d_, k_, False)
        new_info[label] = {"K2": k2_info, "K3": k3_info}
        print(f"[kernels] {label} (m={m_}, d={d_}, k={k_}): K2 {json.dumps(k2_info)}, "
              f"{m_ * -(-k_ // k2_info['block_k'])} clusters; K3 {json.dumps(k3_info)}, "
              f"{m_ * -(-k_ // k3_info['block_k'])} clusters")
        check(k2_info["cluster"] > 0 and k3_info["cluster"] > 0,
              f"{label}: the model sends the shape to the streamed template")

    # the launch shapes the mesh runs (f)-(h) add: one machine a rank (m = 1), on
    # one machine's statistics of each run: the direction (k = 1; K = 4 in run
    # (g)'s K-class head), every CLIME column (model = 1), and one model rank's
    # share of them (64 of d = 128 over 2; 67 of d = 200 over 3, with the direction's
    # column after them, which rides in that launch: rides_in_tail)
    mh = mesh_h_inputs(dev, problem)
    mg = mesh_g_stats(dev)
    f_stats = pipeline.suff_stats(xs[:1], ys[:1], use_kernel=False)
    f_fac = spectral_factor(f_stats.sigma)
    h_stats = pipeline.suff_stats(mh.xs[:1], mh.ys[:1], use_kernel=False)
    g_fac, g_mfac = spectral_factor(mg.binary.sigma), spectral_factor(mg.multiclass.sigma)
    cols_h, cols_g = -(-D // MESH_H[1]), -(-128 // MESH_G[1])
    mesh_shapes = {
        "mesh k=1 d=200": (f_fac, f_stats.mu_d.unsqueeze(-1), lam),
        "mesh CLIME k=200": (f_fac, torch.eye(D, device=dev)[None], lam),
        f"mesh CLIME k={cols_h} + direction d=200": (
            spectral_factor(h_stats.sigma),
            torch.cat([torch.eye(D, device=dev)[None, :, :cols_h],
                       h_stats.mu_d.unsqueeze(-1)], -1), mh.lam),
        "mesh k=1 d=128": (g_fac, mg.binary.rhs, mg.lam),
        "mesh k=4 d=128": (g_mfac, mg.multiclass.rhs, mg.lam_k),
        f"mesh CLIME k={cols_g} d=128": (g_fac, torch.eye(128, device=dev)[None, :, :cols_g],
                                         mg.lam),
    }
    mesh_ops, mesh_info = {}, {}
    for label, (fac, b, lam_v) in mesh_shapes.items():
        b = b.contiguous()
        m_, d_, k_ = b.shape
        lam_cols = torch.full((m_, k_), lam_v, dtype=torch.float32, device=dev)
        mesh_ops[label] = (fac, b, lam_cols)
        k3_info = shape_checks(label, fac, b, lam_cols, torch.ones(m_, k_, device=dev),
                               CHECK_ITERS, 2 * CHECK_ITERS // 5)
        k2_info = launch_shape(m_, d_, k_, False)
        mesh_info[label] = {"K2": k2_info, "K3": k3_info}
        print(f"[kernels] {label} (m={m_}, d={d_}, k={k_}): K2 {json.dumps(k2_info)}, "
              f"{m_ * -(-k_ // k2_info['block_k'])} clusters; K3 {json.dumps(k3_info)}, "
              f"{m_ * -(-k_ // k3_info['block_k'])} clusters")
        check(k2_info["cluster"] > 0 and k3_info["cluster"] > 0,
              f"{label}: the model sends the shape to the streamed template")

    # run (i)'s launch shapes (configuration SERVING, d = 120): K1 at each batch size
    # and on a tick's rows corrupted with each code, K3 at each shape and iteration
    # count, cold and from the state of the same solve on another Sigma_hat
    sv, inputs_s = sync_time(lambda: serving_inputs(dev))
    (serving_held, serving_k1_err), held_s = sync_time(lambda: serving_kernel_checks(sv))
    print(f"[kernels] run (i)'s shapes: inputs {inputs_s:.2f} s, checks {held_s:.2f} s")
    # runs (j) and (k)'s launch shapes: K1, and K2 and K3, at each shape the lint's cases
    # and the dry run launch, m = 1
    jk_held, jk_held_s = sync_time(lambda: analysis_kernel_checks(dev))
    print(f"[kernels] runs (j)-(k)'s shapes: checks {jk_held_s:.2f} s")

    # ---- 3. the main path ---------------------------------------------------
    def estimators(cfg, use_kernel, times):
        out = {}
        out["distributed (paper)"], times["distributed"] = sync_time(
            lambda: simulated_distributed_slda(xs, ys, lam, lam, t, cfg, use_kernel=use_kernel))
        out["centralized"], times["centralized"] = sync_time(lambda: hard_threshold(
            centralized_slda(xs.reshape(-1, D), ys.reshape(-1, D), lam_c, cfg,
                             use_kernel=use_kernel), 0.5 * t))
        out["naive averaged"], times["naive"] = sync_time(
            lambda: simulated_naive_averaged_slda(xs, ys, lam, cfg, use_kernel=use_kernel))
        return out

    runs = {
        "a": (DantzigConfig(max_iters=ITERS, fused=True),
              DantzigConfig(max_iters=ITERS, adapt_rho=False)),
        "b": (DantzigConfig(max_iters=ITERS, use_kernel=True),
              DantzigConfig(max_iters=ITERS)),
    }
    launches = {name: 0 for name in ops.LAUNCHES}
    phase_s = {}
    tables = {}
    for run, (cfg, plain_cfg) in runs.items():
        ops.reset_launches()
        dist_only, _ = sync_time(
            lambda: simulated_distributed_slda(xs, ys, lam, lam, t, cfg))
        dist_launches = dict(ops.LAUNCHES)
        ops.reset_launches()
        times = {}
        betas = estimators(cfg, None, times)
        run_launches = dict(ops.LAUNCHES)
        for name, n in run_launches.items():
            launches[name] += n
        phase_s[run] = times
        for name, beta in betas.items():
            check(beta.shape == (D,) and bool(torch.isfinite(beta).all()),
                  f"run ({run}) {name}: shape {tuple(beta.shape)} or non-finite values")
        plain_times = {}
        plain = estimators(plain_cfg, False, plain_times)
        phase_s[f"{run} plain"] = plain_times
        rows = metrics(betas, problem.beta_star, z, labels, mu1_all, mu2_all)
        plain_rows = metrics(plain, problem.beta_star, z, labels, mu1_all, mu2_all)
        tables[run] = rows
        rerun = float((betas["distributed (paper)"] - dist_only).abs().max())
        print(f"[main ({run})] {cfg}\n  launches: distributed alone {dist_launches}, "
              f"all three estimators {run_launches}; two distributed runs differ by {rerun:.3e}")
        print(format_table(rows))
        print(f"[main ({run}) plain path on the card] {plain_cfg}, plain gram")
        print(format_table(plain_rows))
        for name in rows:
            f1, l2 = rows[name][0], rows[name][1]
            gap_l2 = abs(l2 - plain_rows[name][1])
            gap_beta = float((betas[name] - plain[name]).abs().max())
            print(f"  {name}: F1 {f1:.4f} vs {plain_rows[name][0]:.4f}, "
                  f"l2 gap {gap_l2:.3e}, max |beta - plain| {gap_beta:.3e}")
            check(f1 == plain_rows[name][0], f"run ({run}) {name}: F1 differs from plain")
            check(gap_l2 <= 1e-4, f"run ({run}) {name}: l2 gap {gap_l2} > 1e-4")
        print(f"  wall seconds: kernel path {json.dumps(times)}, "
              f"plain path {json.dumps(plain_times)}")
        check(run_launches["gram"] > 0, f"run ({run}): K1 never launched")
        if run == "a":
            check(dist_launches["dantzig_fused"] == 2,
                  f"run (a): distributed launched K2 {dist_launches['dantzig_fused']} times, not 2")
            check(dist_launches["gram"] > 0, "run (a): distributed never launched K1")
        else:
            check(run_launches["soft_threshold"] > 0, "run (b): K4 never launched")

    # ---- 3 (c). the lambda path -----------------------------------------------
    path_cfg = DantzigConfig(max_iters=ITERS, fused=True, adapt_rho=False, tol=PATH_TOL,
                             check_every=CHECK_EVERY)
    z_val, labels_val = synthetic.sample_labeled(gen, problem, N_VAL, device=dev)

    def sweep(**warm):
        return debiased_local_estimator_path(xs, ys, lams, lam, path_cfg, **warm)

    sweeps, sweep_s, sweep_launches = {}, {}, {}
    for name, warm in (("cold", {}), ("warm", None)):
        if warm is None:
            warm = dict(rho_beta=sweeps["cold"].rho_beta, state_beta=sweeps["cold"].state_beta)
        ops.reset_launches()
        sweeps[name], sweep_s[name] = sync_time(lambda: sweep(**warm))
        sweep_launches[name] = dict(ops.LAUNCHES)
        for kernel, n in sweep_launches[name].items():
            launches[kernel] += n
        check(sweep_launches[name]["dantzig_fused_state"] == 2,
              f"lambda path {name}: K3 launched {sweep_launches[name]['dantzig_fused_state']} "
              "times, not 2")
        check(sweep_launches[name]["dantzig_fused"] == 0, f"lambda path {name}: K2 launched")
        check(sweep_launches[name]["gram"] > 0, f"lambda path {name}: K1 never launched")
    cold, warm = sweeps["cold"], sweeps["warm"]
    iters = {name: int(r.iters.sum()) for name, r in sweeps.items()}
    print(f"[lambda path] {path_cfg}\n  grid lam * 2^((l-4)/4): {lams.tolist()}\n"
          f"  launches: cold {sweep_launches['cold']}, warm {sweep_launches['warm']}\n"
          f"  direction-fold iterations summed over machines and grid points: cold "
          f"{iters['cold']}, warm {iters['warm']}; per machine cold "
          f"{cold.iters[..., 0, 0].tolist()}, warm {warm.iters[..., 0, 0].tolist()}\n"
          f"  wall seconds: cold {sweep_s['cold']:.4f}, warm {sweep_s['warm']:.4f}")
    check(iters["warm"] < iters["cold"],
          f"lambda path: warm sweep ran {iters['warm']} iterations, cold {iters['cold']}")
    for name, r in sweeps.items():
        check(r.beta_tilde.shape == (M, L_GRID, D, 1) and bool(torch.isfinite(r.beta_tilde).all()),
              f"lambda path {name}: beta_tilde shape {tuple(r.beta_tilde.shape)} or non-finite")

    def grid_rows(result, idx):
        """The aggregate (mean over machines, HT at t) at each grid point and at the picks."""
        betas = {f"l={l} lam={float(lams[l]):.4f}": hard_threshold(
            result.beta_tilde[:, l, :, 0].mean(0), t) for l in range(L_GRID)}
        for rule, i in idx.items():
            betas[f"tuned ({rule})"] = hard_threshold(
                take_lambda(result.beta_tilde, i)[..., 0].mean(0), t)
        return metrics(betas, problem.beta_star, z, labels, mu1_all, mu2_all), betas

    idx = {"validation": tune_lambda_validation(cold, z_val, labels_val)[0],
           "kkt": select_by_kkt(cold)}
    rows, path_betas = grid_rows(cold, idx)
    print(f"  chosen grid index per machine: validation {idx['validation'].tolist()}, "
          f"KKT {idx['kkt'].tolist()}")
    print(format_table(rows))
    # the same sweep on the plain versions: plain gram, plain K3
    ops.reset_launches()
    with plain_state_kernel():
        plain_cold = worker_debiased_path(pipeline.BinaryHead(use_kernel=False), xs, ys,
                                          lams=lams, lam_prime=lam, cfg=path_cfg)
    check(not any(ops.LAUNCHES.values()),
          f"lambda path: the plain-version sweep launched kernels {ops.LAUNCHES}")
    plain_rows, _ = grid_rows(plain_cold, idx)
    print(f"[lambda path, plain versions on the card] direction-fold iterations "
          f"{int(plain_cold.iters.sum())} (kernel {iters['cold']})")
    for name in rows:
        gap = abs(rows[name][1] - plain_rows[name][1])
        print(f"  {name}: F1 {rows[name][0]:.4f} vs {plain_rows[name][0]:.4f}, l2 gap {gap:.3e}")
        check(rows[name][0] == plain_rows[name][0], f"lambda path {name}: F1 differs from plain")
        check(gap <= 1e-3, f"lambda path {name}: l2 gap {gap} > 1e-3")
    for name, beta in path_betas.items():
        check(beta.shape == (D,) and bool(torch.isfinite(beta).all()),
              f"lambda path {name}: shape {tuple(beta.shape)} or non-finite values")
    one_shot = simulated_distributed_slda(xs, ys, lam, lam, t, path_cfg)
    at_lam = f"l={L_GRID // 2} lam={float(lams[L_GRID // 2]):.4f}"
    one_row = metrics({"one-shot": one_shot}, problem.beta_star, z, labels, mu1_all,
                      mu2_all)["one-shot"]
    print(f"  grid point lam = {lam:.4f}: F1 {rows[at_lam][0]:.4f}; one-shot distributed "
          f"estimator under the same config: F1 {one_row[0]:.4f}, l2 {one_row[1]:.4f}")
    check(float(lams[L_GRID // 2]) == float(torch.tensor(lam)), "the grid does not hold lam")
    check(rows[at_lam][0] == one_row[0], "lambda path: the grid point at lam and the one-shot "
          "estimator differ in F1")
    # at tol=None the folded sweep is the single solves, bit for bit
    fold_cfg = path_cfg._replace(tol=None, max_iters=CHECK_ITERS)
    fold = solve_dantzig_path(factor, stats.mu_d, lams, fold_cfg)
    fold_same = [torch.equal(fold.beta[:, l], solve_dantzig(factor, stats.mu_d, float(lams[l]),
                                                             fold_cfg))
                 for l in range(L_GRID)]
    print(f"  tol=None fold, {CHECK_ITERS} iters: grid point l bit-identical to a single K2 "
          f"solve at lam_l: {fold_same}")
    check(all(fold_same), "lambda path: the tol=None fold differs from single K2 solves")

    # ---- 3 (d). the multiclass design (configuration MULTICLASS) ----------------
    tally = collections.Counter()  # kernel launches of runs (d) and (e), by shape
    mc_cfg = DantzigConfig(max_iters=MULTICLASS.max_iters, fused=True)
    mc_plain_cfg = DantzigConfig(max_iters=MULTICLASS.max_iters, adapt_rho=False)

    def mc_estimators(cfg, times):
        out = {}
        out["distributed (paper)"], times["distributed"] = sync_time(
            lambda: simulated_distributed_mc_slda(mc.xs, mc.labels, K_MC, mc.lam, mc.lam, mc.t,
                                                  cfg))
        (cent, means), times["centralized"] = sync_time(lambda: centralized_mc_slda(
            mc.xs.reshape(-1, D_MC), mc.labels.reshape(-1), K_MC, mc.lam_c, cfg))
        out["centralized"] = (hard_threshold(cent, 0.5 * mc.t), means)
        out["naive averaged"], times["naive"] = sync_time(
            lambda: simulated_naive_mc_slda(mc.xs, mc.labels, K_MC, mc.lam, cfg))
        return out

    ops.reset_launches()
    simulated_distributed_mc_slda(mc.xs, mc.labels, K_MC, mc.lam, mc.lam, mc.t, mc_cfg)
    mc_dist_launches = dict(ops.LAUNCHES)
    ops.reset_launches()
    mc_times = {}
    mc_betas = mc_estimators(mc_cfg, mc_times)
    mc_launches = dict(ops.LAUNCHES)
    tally.update(ops.LAUNCH_SHAPES)
    for name, n in mc_launches.items():
        launches[name] += n
    ops.reset_launches()
    mc_plain_times = {}
    mc_plain = mc_estimators(mc_plain_cfg, mc_plain_times)
    check(not any(ops.LAUNCHES.values()), f"run (d): the plain path launched {ops.LAUNCHES}")
    mc_table = mc_rows(mc_betas, mc.problem, mc.z, mc.zl)
    print(f"[main (d)] multiclass, {MULTICLASS}, {mc_cfg}\n  lam {mc.lam:.4f}, lam_c "
          f"{mc.lam_c:.4f}, t {mc.t:.4f}; launches: distributed alone {mc_dist_launches}, all "
          f"three estimators {mc_launches}\n  wall seconds: kernel path {json.dumps(mc_times)}, "
          f"plain path {json.dumps(mc_plain_times)}\n  against the plain versions on the card "
          f"({mc_plain_cfg}):")
    hold_rows("run (d)", mc_table, mc_rows(mc_plain, mc.problem, mc.z, mc.zl), 1e-4,
              accuracy=True)
    for name, (beta, means) in mc_betas.items():
        check(beta.shape == (D_MC, K_MC) and means.shape == (K_MC, D_MC)
              and bool(torch.isfinite(beta).all()),
              f"run (d) {name}: shape {tuple(beta.shape)} or non-finite values")
    check(mc_dist_launches["dantzig_fused"] == 2 and mc_dist_launches["dantzig_fused_state"] == 0,
          f"run (d): distributed launched {mc_dist_launches}, not two K2")

    # the multiclass lambda path: the K * L = 40 direction columns in one K3
    # fold, cold and then warm from the cold sweep's states
    mc_path_cfg = DantzigConfig(max_iters=MULTICLASS.max_iters, fused=True, adapt_rho=False,
                                tol=PATH_TOL, check_every=CHECK_EVERY)

    def mc_sweep(**warm):
        return mc_debiased_local_path(mc.xs, mc.labels, K_MC, mc.lams, None, mc_path_cfg, **warm)

    mc_sweeps, mc_sweep_s, mc_sweep_launches = {}, {}, {}
    for name, warm in (("cold", {}), ("warm", None)):
        if warm is None:
            warm = dict(rho_beta=mc_sweeps["cold"].rho_beta,
                        state_beta=mc_sweeps["cold"].state_beta)
        ops.reset_launches()
        mc_sweeps[name], mc_sweep_s[name] = sync_time(lambda: mc_sweep(**warm))
        mc_sweep_launches[name] = dict(ops.LAUNCHES)
        tally.update(ops.LAUNCH_SHAPES)
        for kernel, n in mc_sweep_launches[name].items():
            launches[kernel] += n
        check(mc_sweep_launches[name]["dantzig_fused_state"] == 2
              and mc_sweep_launches[name]["dantzig_fused"] == 0,
              f"run (d) lambda path {name}: launched {mc_sweep_launches[name]}, not two K3")
    mc_iters = {name: int(r.iters.sum()) for name, r in mc_sweeps.items()}

    def mc_grid_rows(result):
        means = result.stats.aux.means.mean(0)
        return mc_rows({f"l={l} lam={float(mc.lams[l]):.4f}": (
            hard_threshold(result.beta_tilde[:, l].mean(0), mc.t), means)
            for l in range(MC_L_GRID)}, mc.problem, mc.z, mc.zl)

    ops.reset_launches()
    with plain_state_kernel():
        mc_plain_cold = mc_sweep()
    check(not any(ops.LAUNCHES.values()),
          f"run (d) lambda path: the plain-version sweep launched {ops.LAUNCHES}")
    print(f"[main (d) lambda path] {mc_path_cfg}\n  grid lam * 2^((l-4)/4): {mc.lams.tolist()}\n"
          f"  launches: cold {mc_sweep_launches['cold']}, warm {mc_sweep_launches['warm']}\n"
          f"  fold iterations summed over machines, grid points and classes: cold "
          f"{mc_iters['cold']}, warm {mc_iters['warm']} (plain cold {int(mc_plain_cold.iters.sum())})"
          f"\n  wall seconds: cold {mc_sweep_s['cold']:.4f}, warm {mc_sweep_s['warm']:.4f}\n"
          f"  the aggregate at each grid point against the plain versions:")
    hold_rows("run (d) lambda path", mc_grid_rows(mc_sweeps["cold"]), mc_grid_rows(mc_plain_cold),
              1e-3, accuracy=True)
    check(mc_iters["warm"] < mc_iters["cold"],
          f"run (d) lambda path: warm sweep ran {mc_iters['warm']} iterations, cold "
          f"{mc_iters['cold']}")
    for name, r in mc_sweeps.items():
        check(r.beta_tilde.shape == (MULTICLASS.m, MC_L_GRID, D_MC, K_MC)
              and bool(torch.isfinite(r.beta_tilde).all()),
              f"run (d) lambda path {name}: shape {tuple(r.beta_tilde.shape)} or non-finite")

    # ---- 3 (e). the refinement rounds (configuration ROUNDS) --------------------
    T_RD = ROUNDS.rounds
    rd_cfg = DantzigConfig(max_iters=ROUNDS.max_iters, fused=True)
    rd_plain_cfg = DantzigConfig(max_iters=ROUNDS.max_iters, adapt_rho=False)
    rd_tol_cfg = DantzigConfig(max_iters=ROUNDS.max_iters, fused=True, adapt_rho=False,
                               tol=PATH_TOL, check_every=CHECK_EVERY)

    def reentry(head, cfg, **warm):
        return simulate_multi_round(head, (rd.xs, rd.ys), lam=rd.lam, lam_prime=rd.lam,
                                    rounds=T_RD, cfg=cfg, collect_info=True, **warm)

    rd_launch = {}
    ops.reset_launches()
    (_, rd_ws), rd_solve_s = sync_time(lambda: simulate_multi_round(
        pipeline.BinaryHead(), (rd.xs, rd.ys), lam=rd.lam, lam_prime=rd.lam, cfg=rd_cfg))
    rd_launch["solves"] = dict(ops.LAUNCHES)
    tally.update(ops.LAUNCH_SHAPES)
    ops.reset_launches()
    rd_cases, rd_loop_s = sync_time(lambda: round_cases(rd_ws))
    check(not any(ops.LAUNCHES.values()), f"run (e): the round schedules launched {ops.LAUNCHES}")
    reentries, reentry_s = {}, {}
    for name in ("cold", "warm"):
        warm = {} if name == "cold" else {
            key: getattr(reentries["cold"][1], key)
            for key in ("rho_beta", "rho_theta", "state_beta", "state_theta")}
        ops.reset_launches()
        reentries[name], reentry_s[name] = sync_time(
            lambda: reentry(pipeline.BinaryHead(), rd_tol_cfg, **warm))
        rd_launch[f"{name} re-entry"] = dict(ops.LAUNCHES)
        tally.update(ops.LAUNCH_SHAPES)
    for counts in rd_launch.values():
        for kernel, n in counts.items():
            launches[kernel] += n
    ops.reset_launches()
    _, rd_ws_plain = simulate_multi_round(pipeline.BinaryHead(use_kernel=False), (rd.xs, rd.ys),
                                          lam=rd.lam, lam_prime=rd.lam, cfg=rd_plain_cfg)
    rd_plain_cases = round_cases(rd_ws_plain)
    with plain_state_kernel():
        rd_plain_reentry = reentry(pipeline.BinaryHead(use_kernel=False), rd_tol_cfg)
    check(not any(ops.LAUNCHES.values()), f"run (e): the plain path launched {ops.LAUNCHES}")

    def rd_rows(bars):
        return metrics({name: hard_threshold(bar, rd.t) for name, bar in bars.items()},
                       problem.beta_star, z, labels, rd.mu1, rd.mu2)

    d_rd = ROUNDS.d
    one_shot = (rd_ws.beta_hat - rd_ws.theta.mT @ (rd_ws.stats.sigma @ rd_ws.beta_hat
                                                     - rd_ws.stats.rhs)).mean(0)
    up_bits = Transport(CommPlan(uplink=Compression(d_rd // 5, "int8")), d_rd, 1,
                        T_RD).uplink_total_bits()
    dense_bits = T_RD * dense_uplink_bits(d_rd, 1)
    rd_iters = {name: (int(ws.iters_beta.sum()), int(ws.iters_theta.sum()))
                for name, (_, ws) in reentries.items()}
    print(f"[main (e)] refinement rounds, {ROUNDS}, {rd_cfg}\n  lam {rd.lam:.4f}, t {rd.t:.4f}; "
          f"launches: {json.dumps(rd_launch)}\n  wall seconds: solves {rd_solve_s:.4f}, every "
          f"round schedule {rd_loop_s:.4f}, re-entry {json.dumps(reentry_s)}\n"
          f"  T = 1 equals the one-shot mean bit for bit: "
          f"{torch.equal(rd_cases['dense'][0], one_shot)}; identity codec equals dense bit for "
          f"bit: {torch.equal(rd_cases['identity'], rd_cases['dense'])}\n  top-20% int8 uplink "
          f"bits over {T_RD} rounds {up_bits} of dense {dense_bits} ({up_bits / dense_bits:.4f})"
          f"\n  chaos (every machine NaN every round, masked): finite "
          f"{bool(torch.isfinite(rd_cases['chaos']).all())}\n  re-entry (tol {PATH_TOL}) "
          f"executed iterations (direction, CLIME; per column): cold {rd_iters['cold']}, warm "
          f"{rd_iters['warm']}\n  against the plain versions on the card ({rd_plain_cfg}):")
    hold_rows("run (e)", rd_rows(rd_cases["bars"]), rd_rows(rd_plain_cases["bars"]), 1e-4)
    print("  the tol-gated re-entry, cold, against the plain versions:")
    hold_rows("run (e) re-entry", rd_rows({"cold re-entry T=3": reentries["cold"][0][:, 0]}),
              rd_rows({"cold re-entry T=3": rd_plain_reentry[0][:, 0]}), 1e-3)
    check(rd_launch["solves"]["dantzig_fused"] == 2 and rd_launch["solves"]["gram"] > 0,
          f"run (e): the solves launched {rd_launch['solves']}, not two K2 and K1")
    for name in ("cold re-entry", "warm re-entry"):
        check(rd_launch[name]["dantzig_fused_state"] == 2 and rd_launch[name]["dantzig_fused"] == 0,
              f"run (e) {name}: launched {rd_launch[name]}, not two K3")
    check(torch.equal(rd_cases["dense"][0], one_shot),
          "run (e): T = 1 differs from the one-shot mean")
    check(torch.equal(rd_cases["identity"], rd_cases["dense"]),
          "run (e): the identity codec differs from the dense rounds")
    check(up_bits <= INT8_SHARE * dense_bits,
          f"run (e): top-20% int8 moves {up_bits} bits, over {INT8_SHARE} of {dense_bits}")
    check(bool(torch.isfinite(rd_cases["chaos"]).all()), "run (e): the chaos aggregate is not finite")
    check(sum(rd_iters["warm"]) < sum(rd_iters["cold"]),
          f"run (e): the warm re-entry ran {rd_iters['warm']} iterations, cold {rd_iters['cold']}")
    for name, bar in rd_cases["bars"].items():
        check(bar.shape == (d_rd,) and bool(torch.isfinite(bar).all()),
              f"run (e) {name}: shape {tuple(bar.shape)} or non-finite values")

    # ---- 3 (f)-(h). the mesh: gloo ranks on this card ------------------------------
    # each run spawns its mesh once and runs its cases in it; each rank resets its
    # launch counts before a case and reads them after (mesh_cases.run_cases), and
    # each case is held against the same case on the simulated face, on the card,
    # on the same split
    from repro_torch import mesh_distributed_lda
    from repro_torch.core.compression import uplink_bits
    from repro_torch.launch.mesh import run_on_mesh
    from repro_torch.launch.mesh_cases import MeshCase, run_cases

    card_line = smi_line()
    # rank launches of runs (f)-(h), summed over the ranks, and by (kernel, *shape)
    mesh_launches, mesh_tally = collections.Counter(), collections.Counter()

    def summarize(tag, reports, spawn_s):
        total, shapes = mesh_summary(tag, reports, spawn_s, card_line)
        mesh_launches.update(total)
        mesh_tally.update(shapes)

    def mesh_run(tag, shape, arrays, cases):
        spawned = time.time()
        reports = run_on_mesh(run_cases, *shape, arrays, cases, backend="gloo",
                              timeout=MESH_TIMEOUT)
        summarize(tag, reports, max(reports.pop("_started")) - spawned)
        return reports

    def gaps(tag, got, want):
        out = {name: float((got[name] - want[name]).abs().max()) for name in want}
        print(f"  max |mesh - simulated| {tag}: {json.dumps(out)}")

    # (f): the §5.1 design on 20 ranks, run (a)'s split
    f_cfg = DantzigConfig(max_iters=ITERS, fused=True)
    f_tol_cfg = DantzigConfig(max_iters=ITERS, fused=True, adapt_rho=False, tol=PATH_TOL,
                              check_every=CHECK_EVERY)
    f_int8 = Compression(D // 5, "int8")
    f_drop = FaultSchedule(dropout=ROUNDS.dropout, seed=SEED)
    f_kw = {"one-shot": {}, "dense T=3": dict(rounds=MESH_T),
            "top-20% int8 T=3": dict(rounds=MESH_T, compression=f_int8),
            # the same case again: the first compressed case's time includes each
            # rank's first use of the codec's CUDA operations
            "top-20% int8 T=3, again": dict(rounds=MESH_T, compression=f_int8),
            "10% dropout masked T=3": dict(rounds=MESH_T, faults=f_drop,
                                           aggregation=Aggregation()),
            "int8 downlink T=3": dict(rounds=MESH_T, comm=CommPlan(downlink=f_int8))}
    f_cases = [MeshCase(name, "binary", dict(lam=lam, lam_prime=lam, t=t, cfg=f_cfg, **kw))
               for name, kw in f_kw.items()]
    f_cases.append(MeshCase("re-entry", "reentry", dict(lam=lam, lam_prime=lam, cfg=f_tol_cfg)))
    f_rep = mesh_run("(f)", MESH_F, dict(x=xs.reshape(-1, D).cpu(), y=ys.reshape(-1, D).cpu()),
                     f_cases)
    f_sim = {name: simulated_distributed_slda(xs, ys, lam, lam, t, f_cfg, **kw)
             for name, kw in f_kw.items()}
    f_got = {name: f_rep[name]["out"].to(dev) for name in f_kw}
    f_sim_cold, f_sim_ws = simulate_multi_round(pipeline.BinaryHead(), (xs, ys), lam=lam,
                                                lam_prime=lam, cfg=f_tol_cfg, collect_info=True)
    f_sim_warm, f_sim_ws_warm = simulate_multi_round(
        pipeline.BinaryHead(), (xs, ys), lam=lam, lam_prime=lam, cfg=f_tol_cfg,
        collect_info=True, **{key: getattr(f_sim_ws, key) for key in
                              ("rho_beta", "rho_theta", "state_beta", "state_theta")})
    f_cold, f_warm, it_cold, it_warm = f_rep["re-entry"]["out"]
    f_re_got = {"cold re-entry": hard_threshold(f_cold.to(dev)[:, 0], t),
                "warm re-entry": hard_threshold(f_warm.to(dev)[:, 0], t)}
    f_re_sim = {"cold re-entry": hard_threshold(f_sim_cold[:, 0], t),
                "warm re-entry": hard_threshold(f_sim_warm[:, 0], t)}
    dense_bits, int8_bits = (f_rep[name]["data_bits"] for name in ("dense T=3",
                                                                  "top-20% int8 T=3"))
    print(f"  against the simulated face on the card ({f_cfg}):")
    gaps("(f)", {**f_got, **f_re_got}, {**f_sim, **f_re_sim})
    hold_rows("run (f)", metrics(f_got, problem.beta_star, z, labels, mu1_all, mu2_all),
              metrics(f_sim, problem.beta_star, z, labels, mu1_all, mu2_all), 1e-4)
    sim_iters = [int(w.iters_beta.sum()) + int(w.iters_theta.sum())
                 for w in (f_sim_ws, f_sim_ws_warm)]
    print(f"  the tol-gated re-entry ({f_tol_cfg}), executed column-iterations over the ranks: "
          f"cold {it_cold}, warm {it_warm} (simulated face: {sim_iters}):")
    hold_rows("run (f) re-entry", metrics(f_re_got, problem.beta_star, z, labels, mu1_all,
                                          mu2_all),
              metrics(f_re_sim, problem.beta_star, z, labels, mu1_all, mu2_all), 1e-3)
    print(f"  data-axis bits a rank on the wire: dense T=3 {sorted(set(dense_bits))}, top-20% "
          f"int8 T=3 {sorted(set(int8_bits))} ({max(int8_bits) / min(dense_bits):.4f} of dense;"
          f" counted {MESH_T * uplink_bits(f_int8, D, 1)})")
    check(all(b == MESH_T * uplink_bits(f_int8, D, 1) for b in int8_bits),
          "run (f): the int8 gathers carried other bits than uplink_bits counts")
    check(max(int8_bits) <= INT8_SHARE * min(dense_bits),
          f"run (f): top-20% int8 carried {max(int8_bits)} bits, over {INT8_SHARE} of dense")
    check(it_warm < it_cold, f"run (f): the warm re-entry ran {it_warm} iterations, cold {it_cold}")
    # rank r is machine r (model = 1): each column's block may end one
    # residual check apart from the batched simulation's
    slack = CHECK_EVERY * M * (1 + D)
    check(all(abs(got - want) <= slack for got, want in zip((it_cold, it_warm), sim_iters)),
          f"run (f): the re-entry ran {[it_cold, it_warm]} column-iterations, the simulated "
          f"face {sim_iters} (at most {slack} apart)")
    for name in f_kw:
        ranks_launched("(f)", name, f_rep[name], gram=None, dantzig_fused=2,
                       dantzig_fused_state=0)
    ranks_launched("(f)", "re-entry", f_rep["re-entry"], dantzig_fused=0, dantzig_fused_state=4)

    # (g): the mesh example at its own sizes, fused
    g_cfg = DantzigConfig(max_iters=ITERS, fused=True)
    print(f"[mesh (g)] python -m repro_torch.mesh_distributed_lda, {g_cfg}:")
    g = mesh_distributed_lda.main(device=dev, cfg=g_cfg)
    g_rep = {k: v for k, v in g["reports"].items() if k != "_started"}
    summarize("(g)", g_rep, g["spawn_s"])
    g_sim = simulated_distributed_slda(g["xs"], g["ys"], g["lam"], g["lam"], g["t"], g_cfg)
    g_sim_k = simulated_distributed_mc_slda(g["mxs"], g["mlabels"], 4, g["lam_k"], g["lam_k"],
                                            g["t_k"], g_cfg)
    gaps("(g)", {"binary": g["beta"], "K-class": g["beta_k"], "K-class means": g["means_k"]},
         {"binary": g_sim, "K-class": g_sim_k[0], "K-class means": g_sim_k[1]})
    f1_l2 = {name: (float(classifier.f1_score(beta, g["problem"].beta_star)),
                    float(classifier.estimation_errors(beta, g["problem"].beta_star)["l2"]))
             for name, beta in (("binary", g["beta"]), ("binary simulated", g_sim))}
    hold_rows("run (g)", {"binary": f1_l2["binary"]}, {"binary": f1_l2["binary simulated"]}, 1e-4)
    hold_rows("run (g)", mc_rows({"K-class": (g["beta_k"], g["means_k"])}, g["mc_problem"],
                                 g["z_k"], g["labels_k"]),
              mc_rows({"K-class": g_sim_k}, g["mc_problem"], g["z_k"], g["labels_k"]), 1e-4,
              accuracy=True)
    ranks_launched("(g)", "binary", g_rep["binary"], gram=None, dantzig_fused=2)
    ranks_launched("(g)", "multiclass", g_rep["multiclass"], dantzig_fused=2)

    # (h): the remainder case, N = 10,000 over (data=2, model=3): fused, and K4's scan
    h_kw = {"one-shot fused": f_cfg,
            "one-shot use_kernel (K4)": DantzigConfig(max_iters=ITERS, use_kernel=True)}
    h_rep = mesh_run("(h)", MESH_H, dict(x=mh.xs.reshape(-1, D).cpu(),
                                         y=mh.ys.reshape(-1, D).cpu()),
                     [MeshCase(name, "binary", dict(lam=mh.lam, lam_prime=mh.lam, t=mh.t,
                                                    cfg=cfg)) for name, cfg in h_kw.items()])
    h_sim = {name: simulated_distributed_slda(mh.xs, mh.ys, mh.lam, mh.lam, mh.t, cfg)
             for name, cfg in h_kw.items()}
    h_got = {name: h_rep[name]["out"].to(dev) for name in h_kw}
    print("  against the simulated face on the card:")
    gaps("(h)", h_got, h_sim)
    hold_rows("run (h)", metrics(h_got, problem.beta_star, z, labels, mh.mu1, mh.mu2),
              metrics(h_sim, problem.beta_star, z, labels, mh.mu1, mh.mu2), 1e-4)
    # each rank's 67 CLIME columns and the direction's: one launch (rides_in_tail)
    ranks_launched("(h)", "one-shot fused", h_rep["one-shot fused"], gram=None, dantzig_fused=1)
    ranks_launched("(h)", "one-shot use_kernel (K4)", h_rep["one-shot use_kernel (K4)"],
                   gram=None, soft_threshold=None, dantzig_fused=0)
    for kernel in ops.LAUNCHES:
        check(mesh_launches[kernel] > 0, f"runs (f)-(h): no rank launched {kernel}")
    # every K1, K2 and K3 shape a rank launched was held against its plain version
    # in phase 2 (K4 is elementwise: its mesh shapes are only counted)
    held = {("gram", *shape) for shape in k1_mesh} | {
        (kernel, *b.shape) for _, b, _ in mesh_ops.values()
        for kernel in ("dantzig_fused", "dantzig_fused_state")}
    unheld = sorted(key for key in mesh_tally if key[0] != "soft_threshold" and key not in held)
    check(not unheld, f"runs (f)-(h): launch shapes held against no plain version: {unheld}")
    for kernel, n in mesh_launches.items():
        launches[kernel] += n
    print(f"[mesh] rank launches of runs (f)-(h), all ranks: {json.dumps(mesh_launches)}; by "
          f"shape: {json.dumps({str(k): v for k, v in sorted(mesh_tally.items())})}")

    # ---- 3 (i). serving (configuration SERVING) ----------------------------------
    (serving, serving_launch, serving_tally), run_i_s = sync_time(
        lambda: run_serving(dev, card_line, serving_held))
    print(f"[serving] run (i), kernels and plain versions: {run_i_s:.2f} s")
    for counts in serving_launch.values():
        for kernel, n in counts.items():
            launches[kernel] += n

    # ---- 3 (j)-(k). the op-contract lint and the production-mesh dry run ------------
    lint_tally, lint_local, phase_s["lint (j)"] = run_lint(card_line)
    dry_tally, dry_results, phase_s["dry run (k)"] = run_dry(card_line)
    for tag, tally_jk, want in (("(j)", lint_tally, ("gram", "dantzig_fused",
                                                     "dantzig_fused_state")),
                                ("(k)", dry_tally, ("gram", "dantzig_fused"))):
        keys = set(tally_jk) | (lint_local if tag == "(j)" else set())
        unheld = sorted(key for key in keys if key not in jk_held)
        check(not unheld, f"run {tag}: launch shapes held against no plain version: {unheld}")
        for kernel in want:
            check(any(key[0] == kernel for key in tally_jk), f"run {tag}: launched no {kernel}")
        for (kernel, *_), n in tally_jk.items():
            launches[kernel] += n

    # ---- 4. times -------------------------------------------------------------
    name_card = torch.cuda.get_device_name(0)
    xc = xs - mu1.unsqueeze(1)  # bmm's input: the centering is not in the library call

    def kernel_splits() -> dict:
        """Host and device time of every kernel, and of the PyTorch call beside K1 and K4,
        at the main path's shapes: 100 graph-captured calls for K1 and K4 and 10 for the
        ADMM solves, which last tens of milliseconds each."""
        # run (b)'s two K4 stages, end to end: host-bound, so timed over repeats
        cfg_b = DantzigConfig(max_iters=ITERS, use_kernel=True)
        hs = pipeline.BinaryHead().stats(xs, ys)
        fac = spectral_factor(hs.sigma)
        stages = {"direction solve": lambda: solve_dantzig(fac, hs.rhs, lam, cfg_b),
                  "CLIME solve": lambda: solve_clime_columns(fac, torch.arange(D, device=dev),
                                                             lam, cfg_b)}
        return {
            **{f"run (b) {name}": {
                "wall_ms": sorted(1e3 * sync_time(fn)[1] for _ in range(STAGE_REPS)),
                "busy_share": busy_share(fn)} for name, fn in stages.items()},
            "gram": time_split(lambda: gram_cuda(xs, mu1), 100, 1000, "gram_kernel", cold=True),
            "gram library bmm": time_split(lambda: torch.bmm(xc.mT, xc), 100, 1000, cold=True),
            "soft_threshold": time_split(lambda: soft_threshold_cuda(x_shrink, t_cols), 100,
                                         1000, "soft_threshold"),
            "soft_threshold scalar t": time_split(lambda: soft_threshold_cuda(x_shrink, 0.05),
                                                  100, 1000, "soft_threshold"),
            "soft_threshold library softshrink": time_split(
                lambda: torch.nn.functional.softshrink(x_shrink, 0.05), 100, 1000),
            "dantzig_fused": time_split(k2_clime, 10, 10, "fused_admm_kernel"),
            "dantzig_fused k=1": time_split(k2_direction, 10, 10, "fused_admm_kernel"),
            "dantzig_fused_state": time_split(k3_clime, 10, 10, "fused_admm_kernel"),
            "dantzig_fused_state fold": time_split(k3_fold, 10, 10, "fused_admm_kernel"),
        }

    splits = kernel_splits()
    kernels = []

    def row(name, route, source, replaces, ms, plain_ms, flops, nbytes, library=None,
            library_ms=None, **extra):
        """One kernel's line; ``library`` names the split of the PyTorch call beside it."""
        bound_ms, bound_by = bound(flops, nbytes)
        sp = splits[name]
        lib = {} if library is None else {"library_" + k: v for k, v in splits[library].items()}
        # back to back, a call takes the longer of its host and device times:
        # the device idles for the rest
        kernels.append(dict(name=name, route=route, source=source, replaces=replaces,
                            launches=launches[name], max_abs_err=errs[name], ms=ms,
                            kernel_ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by, library_ms=library_ms,
                            idle_share=max(0.0, 1.0 - sp["device_ms"] / ms), **sp, **lib,
                            runs_j_k={tag: {str(list(key[1:])): v for key, v in tally_jk.items()
                                            if key[0] == name}
                                      for tag, tally_jk in (("(j)", lint_tally),
                                                            ("(k)", dry_tally))},
                            **extra))

    n = n1
    # K1 at each shape the mesh ranks launched it at (m = 1), on phase 2's inputs
    gram_mesh = []
    for (kernel, *shape), n_launch in sorted(mesh_tally.items()):
        if kernel != "gram":
            continue
        held_k1 = k1_mesh[tuple(shape)]
        _, n_, d_ = shape
        gram_mesh.append({"shape": shape, "launches": n_launch,
                          "max_abs_err": held_k1["max_abs_err"],
                          "ms": cuda_ms(lambda: gram_cuda(held_k1["x"], held_k1["mu"]), 50),
                          "bound_ms": bound(n_ * d_ * (d_ + 1) + n_ * d_,
                                            4 * (n_ * d_ + d_ + d_ * d_))[0],
                          **time_split(lambda: gram_cuda(held_k1["x"], held_k1["mu"]), 100,
                                       1000)})
    gram_serving, k3_serving = serving_rows(sv, serving_tally, serving_k1_err, card_line)
    row("gram", "cuda", "repro_torch/kernels/csrc/gram.cu", "src/repro/kernels/gram.py:28",
        cuda_ms(lambda: gram_cuda(xs, mu1), 50), cuda_ms(lambda: ref.gram_ref(xs, mu1), 50),
        M * (n * D * (D + 1) + n * D), 4 * (M * n * D + M * D + M * D * D), "gram library bmm",
        library_ms=cuda_ms(lambda: torch.bmm(xc.mT, xc), 50),  # library: centering excluded
        mesh=gram_mesh, serving=gram_serving)

    # each launch shape runs (d) and (e) add: time (back to back, device,
    # host), its bound for this run's work, and its launches in those runs
    def new_shape_row(label, state_io):
        iters = MULTICLASS.max_iters if label.startswith("multiclass") else ROUNDS.max_iters
        info = new_info[label]["K3" if state_io else "K2"]
        return shape_row(*new_ops[label], info, state_io, iters, tally)

    # each launch shape of the mesh runs (f)-(h), m = 1: its launches there
    # (rank launches, summed over the ranks), time and bound
    def mesh_shape_row(label, state_io):
        info = mesh_info[label]["K3" if state_io else "K2"]
        return shape_row(*mesh_ops[label], info, state_io, ITERS, mesh_tally)

    def mesh_launched(kernel, label):
        return mesh_tally[(kernel, *mesh_ops[label][1].shape)] > 0

    def launched(kernel, label):
        return tally[(kernel, *new_ops[label][1].shape)] > 0

    k2_new = {label: new_shape_row(label, False) for label in new_ops
              if launched("dantzig_fused", label)}
    k3_new = {label: new_shape_row(label, True) for label in new_ops
              if launched("dantzig_fused_state", label)}
    print(f"[times] runs (d) and (e) launch shapes, K2: {json.dumps(k2_new)}\n  K3: "
          f"{json.dumps(k3_new)}")
    k2_mesh = {label: mesh_shape_row(label, False) for label in mesh_ops
               if mesh_launched("dantzig_fused", label)}
    k3_mesh = {label: mesh_shape_row(label, True) for label in mesh_ops
               if mesh_launched("dantzig_fused_state", label)}
    print(f"[times] mesh runs (f)-(h) launch shapes, K2: {json.dumps(k2_mesh)}\n  K3: "
          f"{json.dumps(k3_mesh)}")
    check(len(k2_mesh) == 6 and len(k3_mesh) == 2,
          f"runs (f)-(h): K2 ran at {sorted(k2_mesh)}, K3 at {sorted(k3_mesh)}")
    k2_ms = cuda_ms(k2_clime, 3)
    k2_plain_ms = cuda_ms(lambda: ref.dantzig_fused_ref(
        stats.sigma, factor.q, factor.inv_eig, eye, lam, iters=ITERS, rho=1.0), 1)
    k2_dir_ms = cuda_ms(k2_direction, 3)
    k2_d1000 = d1000_times(d1000)
    k2_dir_plain_ms = cuda_ms(lambda: ref.dantzig_fused_ref(
        stats.sigma, factor.q, factor.inv_eig, stats.mu_d.unsqueeze(-1), lam, iters=ITERS,
        rho=1.0), 1)
    # per iteration: four (d, d) x (d, k) products and ~20 elementwise operations per entry
    row("dantzig_fused", "cuda", "repro_torch/kernels/csrc/dantzig_fused.cu",
        "src/repro/kernels/dantzig_fused.py:202", k2_ms, k2_plain_ms,
        ITERS * M * (8 * D * D * D + 20 * D * D),
        4 * (2 * M * D * D + M * D + 2 * M * D * D + 2 * M * D),
        launch=launches_info["K2 CLIME"], mesh=k2_mesh,
        direction_k1={"ms": k2_dir_ms,
                      "bound_ms": bound(ITERS * M * (8 * D * D + 20 * D),
                                        4 * (2 * M * D * D + M * D + 4 * M * D + 2 * M))[0],
                      "launch": launches_info["K2 k=1"], **splits["dantzig_fused k=1"]},
        runs_d_e=k2_new, d1000=k2_d1000)

    # K3's bound counts the iterations and residual checks this run's data needed
    def k3_clime_plain():
        return ref.dantzig_fused_state_ref(stats.sigma, factor.q, factor.inv_eig, eye, lam,
                                           iters=ITERS, rho=1.0, alpha=1.7,
                                           block_k=plan_launch(D, D, state_io=True).block_k,
                                           tol=PATH_TOL, check_every=CHECK_EVERY)

    k3_counts = k3_clime().iters
    k3_ms = cuda_ms(k3_clime, 3)
    k3_plain_ms = cuda_ms(k3_clime_plain, 1)
    fold_counts = k3_fold().iters
    fold_ms = cuda_ms(k3_fold, 3)
    flops, nbytes = state_kernel_work(k3_counts, D, plan_launch(D, D, state_io=True).block_k,
                                      ITERS)
    fold_bound, _ = bound(*state_kernel_work(fold_counts, L_GRID, L_GRID, ITERS))
    row("dantzig_fused_state", "cuda", "repro_torch/kernels/csrc/dantzig_fused.cu",
        "src/repro/kernels/dantzig_fused.py:222", k3_ms, k3_plain_ms, flops, nbytes,
        launch=launches_info["K3 CLIME"], mesh=k3_mesh,
        direction_fold={"ms": fold_ms, "bound_ms": fold_bound, "launch": launches_info["K3 fold"],
                        **splits["dantzig_fused_state fold"]},
        runs_d_e=k3_new, serving=k3_serving)
    sweep_ms = {name: cuda_ms(lambda: sweep(**warm_kw), 3) for name, warm_kw in (
        ("cold", {}), ("warm", dict(rho_beta=cold.rho_beta, state_beta=cold.state_beta)))}
    print(f"[times] K3 CLIME (m={M}, d={D}, k={D}, tol={PATH_TOL}, max {ITERS} iters): "
          f"{k3_ms:.3f} ms for block counts {sorted(set(k3_counts.flatten().tolist()))} "
          f"(plain {k3_plain_ms:.3f} ms, bound {kernels[-1]['bound_ms']:.3f} ms); K3 direction "
          f"fold (k={L_GRID}): {fold_ms:.3f} ms for counts "
          f"{sorted(set(fold_counts.flatten().tolist()))} (bound {fold_bound:.4f} ms)")
    print(f"[times] lambda-path sweeps by CUDA events, ms: {json.dumps(sweep_ms)}")
    # each main K2/K3 call at every cluster size that fits and on the streamed
    # template, in two turns: the cluster model's pick beside the others
    by_size = {}
    for name, (fn, _, _) in main_calls.items():
        by_size[name] = {str(cs): [] for cs in fit_sizes[name] + [0]}
        for _ in range(2):
            for cs in fit_sizes[name] + [0]:
                by_size[name][str(cs)].append(cuda_ms(lambda: fn(cluster=cs), 1))
    print(f"[times] K2/K3 ms by cluster size (0: streamed), in turns, the model's pick "
          f"{json.dumps({name: info['cluster'] for name, info in launches_info.items()})}: "
          f"{json.dumps(by_size)}")
    numel = x_shrink.numel()
    st_ms = cuda_ms(lambda: soft_threshold_cuda(x_shrink, t_cols), 200)
    st_scalar_ms = cuda_ms(lambda: soft_threshold_cuda(x_shrink, 0.05), 200)
    # ms, device_ms and host_us are the main path's per-column t; scalar_t is
    # the like-for-like comparison with F.softshrink (library_*)
    def k4_host_parts() -> dict:
        """What K4's host time is made of: the output's allocation, and the C call with
        and without its launch (at numel 0 it returns before launching)."""
        out, raw = torch.empty_like(x_shrink), _launch.stream(x_shrink.device)

        def c_call(size):
            return _SHRINK(x_shrink.data_ptr(), None, out.data_ptr(), 0.05, size, D, D * D,
                              raw)

        return {"empty_like": host_us(lambda: torch.empty_like(x_shrink), 1000),
                "c_call_no_launch": host_us(lambda: c_call(0), 1000),
                "c_call_launch": host_us(lambda: c_call(numel), 1000)}

    row("soft_threshold", "cuda", "repro_torch/kernels/csrc/soft_threshold.cu",
        "src/repro/kernels/soft_threshold.py:24", st_ms,
        cuda_ms(lambda: ref.soft_threshold_ref(x_shrink, t_cols), 200),
        4 * numel, 4 * (2 * numel + M * D), "soft_threshold library softshrink",
        library_ms=cuda_ms(lambda: torch.nn.functional.softshrink(x_shrink, 0.05), 200),
        scalar_t={"ms": st_scalar_ms, "bound_ms": bound(4 * numel, 8 * numel)[0],
                  **splits["soft_threshold scalar t"], "host_parts_us": k4_host_parts()},
        mesh={"launches": mesh_launches["soft_threshold"]})
    print(f"[times] K2 direction solve (m={M}, d={D}, k=1, {ITERS} iters): {k2_dir_ms:.3f} ms"
          f" (plain {k2_dir_plain_ms:.3f} ms);"
          f" K4 with a scalar t: {st_scalar_ms:.4f} ms (the library_ms column is"
          f" F.softshrink with a scalar t)")
    print(f"[times] main-path wall seconds: {json.dumps(phase_s)}")
    # the distributed estimator layer by layer, each stage run to completion
    for run, (cfg, _) in runs.items():
        stages = {}
        hs, stages["suff_stats"] = sync_time(lambda: pipeline.BinaryHead().stats(xs, ys))
        fac, stages["eigh"] = sync_time(lambda: spectral_factor(hs.sigma))
        beta_hat, stages["direction solve"] = sync_time(
            lambda: solve_dantzig(fac, hs.rhs, lam, cfg))
        theta, stages["CLIME solve"] = sync_time(
            lambda: solve_clime_columns(fac, torch.arange(D, device=dev), lam, cfg))
        _, stages["debias + mean + HT"] = sync_time(lambda: hard_threshold(
            (beta_hat - theta.mT @ (hs.sigma @ beta_hat - hs.rhs)).mean(0)[:, 0], t))
        print(f"[times] distributed ({run}) by stage, ms: "
              f"{json.dumps({k: round(1e3 * v, 3) for k, v in stages.items()})}")
    # runs (d) and (e) layer by layer, each stage run to completion
    stages = {}
    hs, stages["mc_suff_stats"] = sync_time(lambda: pipeline.MulticlassHead(K_MC).stats(mc.xs,
                                                                                        mc.labels))
    fac, stages["eigh"] = sync_time(lambda: spectral_factor(hs.sigma))
    beta_hat, stages["direction solve k=5"] = sync_time(
        lambda: solve_dantzig(fac, hs.rhs, mc.lam, mc_cfg))
    theta, stages["CLIME solve k=120"] = sync_time(
        lambda: solve_clime_columns(fac, torch.arange(D_MC, device=dev), mc.lam, mc_cfg))
    _, stages["debias + mean + HT"] = sync_time(lambda: hard_threshold(
        (beta_hat - theta.mT @ (hs.sigma @ beta_hat - hs.rhs)).mean(0), mc.t))
    mc_warm = dict(rho_beta=mc_sweeps["cold"].rho_beta, state_beta=mc_sweeps["cold"].state_beta)
    mc_sweep_ms = {"cold": cuda_ms(mc_sweep, 2), "warm": cuda_ms(lambda: mc_sweep(**mc_warm), 2)}
    print(f"[times] run (d) distributed by stage, ms: "
          f"{json.dumps({k: round(1e3 * v, 3) for k, v in stages.items()})}; lambda-path sweeps "
          f"by CUDA events, ms: {json.dumps(mc_sweep_ms)}")
    stages = {}
    hs, stages["suff_stats"] = sync_time(lambda: pipeline.BinaryHead().stats(rd.xs, rd.ys))
    fac, stages["eigh"] = sync_time(lambda: spectral_factor(hs.sigma))
    _, stages["direction solve k=1"] = sync_time(lambda: solve_dantzig(fac, hs.rhs, rd.lam, rd_cfg))
    _, stages["CLIME solve k=200"] = sync_time(
        lambda: solve_clime_columns(fac, torch.arange(D, device=dev), rd.lam, rd_cfg))
    for label, kw in (("rounds loop dense T=3", {}),
                      ("rounds loop top-20% int8 T=3", dict(compression=Compression(D // 5,
                                                                                   "int8"))),
                      ("rounds loop 10% dropout masked T=3", dict(
                          faults=FaultSchedule(dropout=ROUNDS.dropout, seed=SEED),
                          aggregation=Aggregation()))):
        _, stages[label] = sync_time(lambda: simulate_round_loop(rd_ws, rounds=T_RD, **kw))
    print(f"[times] run (e) by stage, ms: "
          f"{json.dumps({k: round(1e3 * v, 3) for k, v in stages.items()})}")
    print(f"[times] distributed (b), {STAGE_REPS} runs of each K4 stage, host clock ms, and "
          f"the device's busy share of one profiled run: "
          f"{json.dumps({k: v for k, v in splits.items() if k.startswith('run (b)')})}")
    print(f"[result] {json.dumps({r: tables[r] for r in tables})}")

    card = smi_line()
    print(json.dumps({"kernels": kernels}))
    print(card)
    if FAILURES:
        fail(f"{len(FAILURES)} check(s) failed: {FAILURES}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name_card,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
