"""A checkout of the benchmark's data files at CPU test sizes, for the tests in ``portbench/tests``.

:func:`tiny_root` copies ``BENCHMARK.json`` and the ``configs``,
``workloads`` and ``layer_metrics`` folders into ``dest`` and shrinks
every configuration and traffic mix so that a run takes a fraction of a
second on one CPU thread.  Widths shrink too here: these are the CPU
tests' sizes, never a cell's.  The K3 gate block is the port's at the
small width (one block of all d columns).
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from portbench import spec

CONFIGS = {
    "sec51_d200_m20": dict(d=24, n_signal=4, m=4, n1=30, n2=30, N=240, max_iters=60),
    "serving_d120": dict(d=24, n_signal=4, n_seed=200, tol=1e-2, gate_block_cols=24),
}
TRAFFIC = {
    "fits": dict(pool=4, trace_units=2),
    "serving": dict(batch=256, query_pool=4, sampled_ticks=8, trace_units=2),
}
SERVING_EPOCH = dict(epoch_ticks=32, ingest_every=4, refresh_every=16)


def edit_json(path: Path, fn) -> None:
    data = json.loads(path.read_text())
    fn(data)
    path.write_text(json.dumps(data, indent=1))


def tiny_root(dest) -> Path:
    dest = Path(dest)
    (dest / "portbench").mkdir(parents=True, exist_ok=True)
    shutil.copy(spec.ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    for sub in ("configs", "workloads", "layer_metrics"):
        shutil.copytree(spec.ROOT / "portbench" / sub, dest / "portbench" / sub,
                        dirs_exist_ok=True)
    for name, sizes in CONFIGS.items():
        edit_json(dest / "portbench" / "configs" / f"{name}.json", lambda c: c.update(sizes))
    for path in (dest / "portbench" / "workloads").glob("*.json"):
        def shrink(w):
            w["traffic"].update(TRAFFIC[w["driver"]])
            if w["driver"] == "serving":
                w["traffic"]["sessions"] = min(w["traffic"]["sessions"], 2)
                w["traffic"]["judged_sessions"] = min(w["traffic"]["judged_sessions"], 2)
            if w["driver"] == "serving" and w["traffic"]["epoch_ticks"] > 24:
                # a shorter epoch; an interval of 0 (never) stays 0
                w["traffic"].update({k: v for k, v in SERVING_EPOCH.items()
                                     if w["traffic"][k]})
        edit_json(path, shrink)
    return dest
