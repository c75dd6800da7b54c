"""The readings the correctness limits are set from: the port on many seeds, the control on a few.

    python3 -m portbench.calibrate --workload <cell> --program-seeds 12 --control-seeds 3

In one process, for each seed, one ``run.run_cell``, as a benchmark run
makes it, with a fixed amount of the cell's own work in place of the
timed window (``--units`` fits or epochs; default: the traced run's
amount, and for fits the whole dataset pool).  ``system=program`` is the port; ``system=control`` is the
reference in TF32 put in the port's place.  One JSON line a reading on
standard output: the numbers compared, beside the cell's limits.  The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import math
import random
import sys
import time

import torch

from portbench import run, spec


def readings(name: str, seeds, system: str, device: torch.device, units: int | None = None,
             root=spec.ROOT):
    """Yield one dict a seed: the seed, the system, the compared numbers and the verdict."""
    cell = spec.cell(name, root)
    if units is None:
        units = cell.traffic.get("pool", cell.traffic["trace_units"])
    for seed in seeds:
        t0 = time.perf_counter()
        run.log(f"calibrate: {system}, seed {seed}")
        result = run.run_cell(name, seed, None, False, device, root=root, system=system,
                              units=units)
        checks = {k: math.inf if c["value"] is None else c["value"]
                  for k, c in result["checks"].items()}
        yield {"cell": name, "system": system, "seed": seed, "checks": checks,
               "correct": result["correct"], "limits": cell.limits,
               "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--units", type=int, default=None)
    ap.add_argument("--first-seed", type=int, default=None,
                    help="seed of the first reading (default: drawn at random)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    first = args.first_seed if args.first_seed is not None else random.randrange(2**31, 2**32)
    dev = torch.device("cuda:0")
    for system, n in (("program", args.program_seeds), ("control", args.control_seeds)):
        seeds = [first + 7919 * i for i in range(n)]
        for reading in readings(args.workload, seeds, system, dev, args.units):
            print(json.dumps(reading), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
