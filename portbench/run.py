"""Run one cell of the port's benchmark once.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (imports, the card, the kernels' build or load, the inputs drawn
from the seed, the system's own set-up and one warm-up unit of the
cell's work) is timed as ``setup_s``; each stage is logged on standard
error.  Then either the measured window (``--trace 0``: the cell's
end-to-end metrics) or a fixed amount of the same work under the
profiler (``--trace 1``: its per-layer metrics, the device's busy time
and the breakdown; a cell with a per-layer metric on the host's clock
runs the untraced window first, and that metric reads its calls).  After the window the peak device memory is read,
the port's state is freed, and the plain reference judges every answer
the window produced.  The last lines of standard error are the numbers
compared, each beside its limit; the last line of standard output is
the result, in JSON.  Without a card, or with fewer cards than the cell
asks for, the run prints no result and exits 2; when a module of JAX or
of the JAX package is loaded, it exits 3.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import torch  # noqa: E402

from portbench import compare, spec, trace  # noqa: E402

# top-level module names nothing the benchmark runs may load, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks", "chip_smoke")


def log(msg: str) -> None:
    print(f"portbench: [{time.perf_counter() - T0:8.3f} s] {msg}", file=sys.stderr, flush=True)


def forbidden_modules(names=None) -> list:
    """The forbidden top-level names among ``names`` (default: the loaded modules)."""
    tops = {name.split(".")[0] for name in (sys.modules if names is None else names)}
    return sorted(tops & set(FORBIDDEN))


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.TimeoutExpired) as err:
        return f"nvidia-smi failed: {err}"
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"


def run_cell(name: str, seed: int, seconds: float | None, traced: bool, device: torch.device,
             root=spec.ROOT, system: str = "program", t0: float | None = None,
             units: int | None = None) -> dict:
    """One run of cell ``name`` on ``device``: the result line as a dict (``checks`` last).

    ``units`` replaces the timed window by that many units of the cell's work, untraced, and
    ``system="control"`` puts the reference in lower precision in the port's place: both for
    the readings the limits are set from (``portbench.calibrate``), never in a benchmark run.
    """
    t0 = time.perf_counter() if t0 is None else t0
    cell = spec.cell(name, root)
    driver = importlib.import_module(f"portbench.traffic.{cell.driver}")
    on_card = device.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import build, ops

    if on_card:
        built = build.build()
        log("kernels: " + ", ".join(f"{k} {'built in %.1f s' % s if s else 'loaded'}"
                                    for k, s in built.items()))
    st = driver.setup(cell, device, seed, system, log)
    if traced:
        trace.warm_profiler()
    driver.sync(device)
    setup_s = time.perf_counter() - t0
    log(f"set-up: {setup_s:.3f} s")

    # the untimed window: every answer in it is judged; a traced run times it too when one of
    # the cell's per-layer metrics comes from the host's clock around single calls
    recs, tr = [], None
    if not traced or any(m["source"] == "host_clock" for m in cell.per_layer):
        recs.append(driver.run(st, seconds=seconds, units=units))
        log(f"window: {recs[0].window_s:.3f} s, {driver.counts(recs[0])}")
    if traced:
        rec, tr = trace.capture(
            lambda: driver.run(st, units=cell.traffic["trace_units"], traced=True),
            driver.counts, lambda: dict(ops.LAUNCH_SHAPES), {**cell.config, **cell.traffic})
        if recs:
            tr = tr._replace(host_timed=driver.timed(recs[0]))
        recs.append(rec)
        log(f"traced window: {tr.window_s:.3f} s, {driver.counts(rec)}")
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    recs = [driver.to_host(rec) for rec in recs]
    st = st._replace(system=None)  # the system under test: freed before the check
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
        log(card_line())

    a = time.perf_counter()
    checks = {}
    for rec in recs:
        got = driver.judge(st, rec, cell.limits)
        missing = set(cell.limits) - set(got)
        if missing:
            raise KeyError(f"{name}: the check gives no {sorted(missing)}")
        # the cell compares the numbers its limits name
        for k in cell.limits:
            checks[k] = max(checks.get(k, got[k]), got[k])
    log(f"reference check: {time.perf_counter() - a:.3f} s")
    counted = [driver.counts(rec) for rec in recs]
    metrics = {}
    if traced:
        for m in cell.per_layer:
            value = spec.reader(m["name"], root)(tr)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = driver.end_to_end(recs[0])
        e2e["setup_s"] = setup_s
        for m in cell.end_to_end:
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    if traced:
        dev["busy_s"] = trace.busy_ns(tr) / 1e9
        dev["window_s"] = tr.window_s
    result = {"correct": compare.verdict(checks, cell.limits),
              "attempted": sum(c["attempted"] for c in counted),
              "failed": sum(c["failed"] for c in counted),
              "metrics": metrics, "device": dev}
    if traced:
        result["breakdown"] = trace.breakdown(tr)
    # a reading that is not finite (a missing or non-finite answer) is written as null
    result["checks"] = {k: {"value": v if math.isfinite(v) else None, "limit": cell.limits.get(k)}
                        for k, v in checks.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    chips = spec.cell(args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"needs {chips} CUDA device(s); this machine has "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    torch.set_num_threads(1)
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda:0"), t0=T0)
    bad = forbidden_modules()
    if bad:
        log(f"forbidden modules loaded: {', '.join(bad)}")
        return 3
    for k, v in result["checks"].items():
        log(f"check {k}: {v['value']!r} (limit {v['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
