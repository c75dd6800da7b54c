"""A checkout of the benchmark's data files at CPU test sizes, for the tests in ``portbench/tests``.

:func:`tiny_root` copies ``BENCHMARK.json`` and the ``configs``,
``workloads`` and ``layer_metrics`` folders of a source tree into
``dest`` and shrinks every configuration and traffic mix so that a run
takes a fraction of a second on one CPU thread.  It names no
configuration and no driver: each cell's traffic driver shrinks the
cell's traffic and configuration (``shrink_for_cpu_tests`` of
``portbench.traffic.<driver>``), and a configuration whose shape the
driver's sizes would lose (n < d, say) gives sizes of its own in an
optional ``"cpu_test"`` object, applied after them.  Widths shrink too
here: these are the CPU tests' sizes, never a cell's.
:func:`check_cpu_sizes` holds a shrunk configuration to what the
suite's time limit allows.
"""

from __future__ import annotations

import importlib
import json
import shutil
from pathlib import Path

from portbench import spec

# the most a shrunk configuration may keep: its width, and the ADMM iterations of a solve
# that runs a fixed count (a solve with a stopping tolerance, ``tol``, takes max_iters as a cap)
CPU_TEST_MOST = dict(d=64, max_iters=100)


def edit_json(path: Path, fn) -> None:
    data = json.loads(path.read_text())
    fn(data)
    path.write_text(json.dumps(data, indent=1))


def copy_data_files(source, dest) -> Path:
    """``BENCHMARK.json`` and the data folders of the tree ``source``, copied into ``dest``."""
    source, dest = Path(source), Path(dest)
    (dest / "portbench").mkdir(parents=True, exist_ok=True)
    shutil.copy(source / "BENCHMARK.json", dest / "BENCHMARK.json")
    for sub in ("configs", "workloads", "layer_metrics"):
        shutil.copytree(source / "portbench" / sub, dest / "portbench" / sub,
                        dirs_exist_ok=True)
    return dest


def tiny_root(dest, source=spec.ROOT) -> Path:
    """The data files of ``source`` in ``dest``, every cell's traffic shrunk by its driver and
    every configuration by its first cell's driver (in ``BENCHMARK.json`` order), then by its
    own ``cpu_test``."""
    dest = copy_data_files(source, dest)
    bench = spec.benchmark(dest)
    files = {c["name"]: dest / c["file"] for c in bench["configs"]}
    configs = {}
    for entry in bench["workloads"]:
        path = dest / "portbench" / "workloads" / f"{entry['name']}.json"
        work = json.loads(path.read_text())
        driver = importlib.import_module(f"portbench.traffic.{work['driver']}")
        shrink = getattr(driver, "shrink_for_cpu_tests", None)
        if shrink is None:
            raise AttributeError(f"traffic driver {work['driver']!r}, named by {path}, "
                                 "gives no shrink_for_cpu_tests")
        config = json.loads(files[work["config"]].read_text())
        shrink(config, work["traffic"])
        if work["config"] not in configs:
            configs[work["config"]] = {**config, **config.get("cpu_test", {})}
        path.write_text(json.dumps(work, indent=1))
    for name, config in configs.items():
        files[name].write_text(json.dumps(config, indent=1))
    return dest


def check_cpu_sizes(root, name: str) -> None:
    """Raise ``ValueError``, naming configuration ``name``, where its copy under the tiny root
    ``root`` keeps more than :data:`CPU_TEST_MOST`: a configuration added without CPU test
    sizes would run the suite into its time limit."""
    conf = next(c for c in spec.benchmark(root)["configs"] if c["name"] == name)
    config = json.loads((Path(root) / conf["file"]).read_text())
    most = dict(CPU_TEST_MOST)
    if "tol" in config:
        most.pop("max_iters")
    over = {k: config[k] for k, v in most.items() if config.get(k, 0) > v}
    if over:
        raise ValueError(f"configuration {name!r} keeps {over} at CPU test sizes (at most "
                         f"{most}): give it a \"cpu_test\" object, or its driver smaller sizes")
