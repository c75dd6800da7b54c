"""One rank of Algorithm 1 on the production mesh (twin of ``repro.launch.dryrun_slda``).

    python -m repro_torch.launch.dryrun_slda [--d 256] [--n 4096] [--iters 500]
        [--mesh single|multi|both] [--variant baseline|fused] [--out DIR] [--tag T] [--cpu]

The reference lowers the one-shot estimator on the 16 x 16 and
2 x 16 x 16 meshes over 512 forced host devices and reads XLA's cost
analysis.  There is no host of 512 cards to lower on, so this runs one
rank instead: one process joins a ``torch.distributed`` fake process
group (backend ``"fake"``: every collective returns at once and moves
nothing) at world 256 or 512, builds
:func:`~repro_torch.launch.mesh.make_production_mesh` and runs
:func:`~repro_torch.core.distributed.distributed_slda_shardmap` as rank
0 -- machine 0, model column block 0 -- on real tensors.  Its result is
meaningless (the gathers bring back uninitialized memory) and is not
printed as an estimate.  What the run measures of that rank:

* ``flops_per_device``: ``torch.utils.flop_counter.FlopCounterMode``
  over the aten ops, plus, on the card, the hand-written kernels' FLOPs
  from their call shapes and iterations;
* ``bytes_per_device``: the aten ops' operands and results, plus the
  kernels' (inputs read once, outputs written once);
* ``collective_bytes_per_device`` and ``collectives``: the logical
  collectives (:data:`repro_torch.core.collectives.RECORDS`), one a
  call, counting its operand; ``wire_bits_by_hop`` is the per-hop
  :data:`~repro_torch.core.collectives.TALLY`, where a psum over
  (pod, data) counts twice;
* on the card, the rank's wall seconds and peak device memory, also
  above what was resident before the call (cuBLAS keeps its workspaces).

The roofline terms use NVIDIA's H100 SXM data sheet: 67 TFLOP/s FP32
outside the tensor cores, 3.35 TB/s HBM3, NVLink 4 at 450 GB/s a
direction.  The run fails unless the dense one-shot's data-axis uplink
is 32 d K bits (K = 1), the paper's one d-vector per machine, and the
model-axis gather one tiled block of ceil(d / 16) rows.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.analysis.counts import count_ops
from repro_torch.core import collectives
from repro_torch.core.dantzig import DantzigConfig
from repro_torch.core.distributed import distributed_slda_shardmap
from repro_torch.device import require_device
from repro_torch.launch.mesh import axis_size, data_axes, make_production_mesh

# NVIDIA H100 SXM data sheet: FP32 outside the tensor cores, HBM3, NVLink 4 a direction
PEAK_FLOPS = 67e12
HBM_BW = 3.35e12
NVLINK_BW = 450e9


def kernel_work(call_shapes: dict, iters: int) -> tuple[int, int]:
    """(FLOP, bytes) of the hand-written kernels' calls: K1 centres and multiplies the
    upper triangle, K2 runs four (d, d) x (d, k) products and ~20 elementwise operations
    an entry an iteration; each input read once, each output written once."""
    flops = nbytes = 0
    for (name, m, rows, cols), n in call_shapes.items():
        if name == "gram":  # x (m, n, d)
            s, d = rows, cols
            flops += n * m * (s * d * (d + 1) + s * d)
            nbytes += n * 4 * (m * s * d + m * d + m * d * d)
        elif name == "dantzig_fused":  # b (m, d, k)
            d, k = rows, cols
            flops += n * iters * m * (8 * d * d * k + 20 * d * k)
            nbytes += n * 4 * (2 * m * d * d + m * d + 2 * m * d * k + 2 * m * k)
        else:
            raise ValueError(f"{name} is not on the dry run's path")
    return flops, nbytes


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _fake_group(world: int) -> None:
    """Join a fake process group of ``world`` ranks as rank 0; raises where torch has none."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def run_one(d: int, n_per_machine: int, multi_pod: bool, max_iters: int,
            out_dir: str | None, tag: str = "", variant: str = "baseline",
            device: str = "cuda") -> dict:
    """One rank of the one-shot estimator on the production mesh: its measured costs."""
    dev = require_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    _fake_group(512 if multi_pod else 256)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device=dev.type)
        axes = data_axes(mesh)
        machines = math.prod(axis_size(mesh, a) for a in axes)
        n1 = n_per_machine // 2
        # the global arrays every rank receives; rank 0 reads machine 0's rows only
        rng = np.random.default_rng(0)
        x = np.zeros((machines * n1, d), np.float32)
        y = np.zeros((machines * n1, d), np.float32)
        x[:n1] = rng.standard_normal((n1, d), dtype=np.float32)
        y[:n1] = rng.standard_normal((n1, d), dtype=np.float32) + 0.5
        cfg = DantzigConfig(max_iters=max_iters, fused=(variant == "fused"),
                            adapt_rho=(variant != "fused"))

        def fn():
            return distributed_slda_shardmap(mesh, x, y, 0.05, 0.05, 0.01, cfg,
                                             data_axes=axes, model_axis="model")

        from torch.utils.flop_counter import FlopCounterMode

        collectives.TALLY.reset()
        t0 = time.perf_counter()
        with FlopCounterMode(display=False) as flop_counter:
            _, counts = count_ops(fn)
        _sync(dev)
        first_s = time.perf_counter() - t0
        wire_bits = dict(collectives.TALLY.bits)
        wall_s = peak = resident = None
        if dev.type == "cuda":  # a second, uncounted call: the rank's time and memory
            torch.cuda.reset_peak_memory_stats(dev)
            resident = torch.cuda.memory_allocated(dev)  # cuBLAS workspaces and the like
            t0 = time.perf_counter()
            fn()
            _sync(dev)
            wall_s = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated(dev)
        model_rows = -(-d // axis_size(mesh, "model"))
    finally:
        dist.destroy_process_group()

    # on the card the kernels run below the dispatcher; on the CPU their plain
    # versions are aten ops the counters already saw
    k_flops, k_bytes = kernel_work(counts.call_shapes, max_iters) if counts.on_card else (0, 0)
    aten_flops = flop_counter.get_total_flops()
    flops, nbytes = aten_flops + k_flops, counts.bytes_accessed + k_bytes
    records = [r._asdict() for r in counts.collectives]
    link_bits = {role: sum(r.bits for r in counts.collectives if r.role == role)
                 for role in ("data", "model")}
    cbytes = sum(r.bits for r in counts.collectives) // 8
    terms = {"compute_s": flops / PEAK_FLOPS, "memory_s": nbytes / HBM_BW,
             "collective_s": cbytes / NVLINK_BW}
    result = {
        "arch": "slda-core",
        "variant": variant,
        "d": d,
        "n_per_machine": n_per_machine,
        "machines": machines,
        "max_iters": max_iters,
        "mesh": mesh_name,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "flops_per_device": flops,
        "aten_flops": aten_flops,
        "kernel_flops": k_flops,
        "bytes_per_device": nbytes,
        "collective_bytes_per_device": cbytes,
        "collectives": records,
        "link_bits": link_bits,
        "wire_bits_by_hop": wire_bits,
        "paper_uplink_bytes": 4 * d,
        "calls": {str(k): n for k, n in sorted(counts.call_shapes.items())},
        "launches": counts.launches,
        "eigh": counts.eigh,
        **terms,
        "dominant": max(terms, key=terms.get),
        "peak_memory_bytes": peak,
        "peak_above_resident_bytes": None if peak is None else peak - resident,
        "wall_s": wall_s,
        "counted_call_s": first_s,
    }
    print(f"[dryrun-slda] d={d} n={n_per_machine} {mesh_name} {variant} on {result['device']}: "
          f"compute={terms['compute_s']:.3e}s memory={terms['memory_s']:.3e}s "
          f"collective={terms['collective_s']:.3e}s dominant={result['dominant']} "
          f"link bits {json.dumps(link_bits)} (by hop {json.dumps(wire_bits)}) "
          f"wall {wall_s} s peak {peak} B ({result['peak_above_resident_bytes']} B above "
          f"what was resident)")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        suffix = f"_{tag}" if tag else ""
        fname = f"slda-core_d{d}_{mesh_name}_{variant}{suffix}.json"
        with open(os.path.join(out_dir, fname), "w") as f:
            json.dump(result, f, indent=1)
    # the paper's budget: one d-vector a machine on the data axis, one tiled
    # (ceil(d / 16), 1) block on the model axis
    want = {"data": 32 * d, "model": 32 * model_rows}
    if link_bits != want:
        raise RuntimeError(f"dry run {mesh_name} {variant}: the rank's collectives carried "
                           f"{link_bits} bits a link, the one-shot's accounting is {want}")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun_slda")
    ap.add_argument("--d", type=int, default=256)
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--iters", type=int, default=500)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments/dryrun_slda_torch")
    ap.add_argument("--variant", default="baseline", choices=["baseline", "fused"])
    ap.add_argument("--tag", default="")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    for multi in meshes:
        run_one(args.d, args.n, multi, args.iters, args.out, args.tag, args.variant,
                device="cpu" if args.cpu else "cuda")
    return 0


if __name__ == "__main__":
    sys.exit(main())
