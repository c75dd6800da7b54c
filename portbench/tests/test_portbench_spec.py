"""BENCHMARK.json against the benchmark's contract, and every cell, configuration and metric file
loading by its name; a throwaway cell added as files and entries runs with no edit elsewhere."""

import json
import re
from pathlib import Path

import pytest
import torch

from portbench import run, spec, testing, trace

torch.set_num_threads(1)

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def line_ok(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["paths"]) <= 16 and len(BENCH["command"]) <= 32
    for path in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", path) and (spec.ROOT / path).is_dir()
        assert not path.endswith("_torch")
    assert all(line_ok(w) and not w.startswith("/") and ".." not in w for w in BENCH["command"])
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_entries():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [c["name"] for c in BENCH["configs"]] + CELLS
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert line_ok(c["source"]) and line_ok(c["why"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith("portbench/") and (spec.ROOT / c["file"]).is_file()
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and line_ok(w["why"]) and NAME.match(w["traffic"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and line_ok(m["layer"]) and m["moves"] in e2e
        assert set(m["workloads"]) <= set(CELLS)
        assert all(any(x["name"] == m["moves"] for x in spec.cell(c).end_to_end)
                   for c in m["workloads"])


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_loads_by_name(name):
    cell = spec.cell(name)
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2 and cell.per_layer
    assert cell.limits and all(v >= 0 for v in cell.limits.values())
    assert cell.config["precision"] == "float32, TF32 off"
    assert (spec.ROOT / "portbench" / "traffic" / f"{cell.driver}.py").is_file()


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_metric_reader_loads_and_reads_nothing_from_an_empty_window(metric):
    read = spec.reader(metric)
    empty = trace.Trace((0, 10**9), [], [], {}, {}, {})
    assert read(empty) is None


# the paper's section 5.1 design at d = 1,000: m = 20 sites of 250 + 250 rows, so n < d a site
FULL_SIZE = dict(d=1000, m=20, n1=250, n2=250, N=10000, max_iters=500)


@pytest.mark.parametrize("cpu_test", [dict(d=48, n1=12, n2=12, N=96), None],
                         ids=["own_cpu_test", "driver_sizes"])
def test_a_throwaway_cell_config_and_metric_run_from_files_alone(tmp_path, cpu_test):
    src = testing.copy_data_files(spec.ROOT, tmp_path / "src")
    pb = src / "portbench"
    conf = json.loads((pb / "configs" / "sec51_d200_m20.json").read_text())
    conf.update(FULL_SIZE, **({"cpu_test": cpu_test} if cpu_test else {}))
    (pb / "configs" / "throwaway.json").write_text(json.dumps(conf))
    (pb / "workloads" / "throwaway.two.json").write_text(json.dumps(
        {"config": "throwaway", "driver": "fits", "traffic": {"pool": 16, "trace_units": 8},
         "limits": {"beta_gap": 1e-4}}))
    (pb / "layer_metrics" / "fits_seen.two.py").write_text(
        "def read(tr):\n    return tr.counts.get('fits')\n")
    bench = json.loads((src / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "throwaway", "source": "a test", "reduced": [],
                             "file": "portbench/configs/throwaway.json", "why": "a test"})
    bench["workloads"].append({"name": "throwaway.two", "config": "throwaway", "traffic": "two",
                               "chips": 1, "why": "a test"})
    next(m for m in bench["end_to_end"] if m["name"] == "fit_ms")["workloads"].append(
        "throwaway.two")
    bench["per_layer"].append({"name": "fits_seen.two", "unit": "fits", "better": "higher",
                               "source": "program_counter", "layer": "device",
                               "moves": "fit_ms", "workloads": ["throwaway.two"]})
    (src / "BENCHMARK.json").write_text(json.dumps(bench))

    root = testing.tiny_root(tmp_path / "tiny", source=src)
    assert spec.cell("throwaway.two", src).config["d"] == 1000
    cell = spec.cell("throwaway.two", root)
    testing.check_cpu_sizes(root, "throwaway")
    if cpu_test:
        assert cell.config["n1"] + cell.config["n2"] < cell.config["d"] == cpu_test["d"]
    else:
        assert cell.config == spec.cell("sec51_d200_m20.oneshot", root).config
    assert [m["name"] for m in cell.per_layer] == ["fits_seen.two"]
    tr = trace.Trace((0, 1), [], [], {"fits": 3}, {}, {})
    assert spec.reader("fits_seen.two", root)(tr) == 3
    result = run.run_cell("throwaway.two", 2**31 + 5, 0.2, False, torch.device("cpu"),
                          root=root)
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"setup_s", "fit_ms"}


def test_the_data_files_are_only_what_benchmark_json_names():
    pb = Path(spec.ROOT) / "portbench"
    assert {p.stem for p in (pb / "workloads").glob("*.json")} == set(CELLS)
    assert {p.name[:-3] for p in (pb / "layer_metrics").glob("*.py")} == {
        m["name"] for m in BENCH["per_layer"]}
    assert {f"portbench/configs/{p.name}" for p in (pb / "configs").glob("*.json")} == {
        c["file"] for c in BENCH["configs"]}


def test_a_cell_compares_the_numbers_its_limits_name(tmp_path):
    root = testing.tiny_root(tmp_path)
    cell = next(c for c in CELLS if spec.cell(c).driver == "serving")
    path = root / "portbench" / "workloads" / f"{cell}.json"
    dropped = next(iter(spec.cell(cell, root).limits))
    testing.edit_json(path, lambda w: w["limits"].pop(dropped))
    result = run.run_cell(cell, 2**31 + 3, 0.2, False, torch.device("cpu"), root=root)
    assert dropped not in result["checks"] and result["correct"]
    testing.edit_json(path, lambda w: w["limits"].update(no_such_number=1.0))
    with pytest.raises(KeyError, match="no_such_number"):
        run.run_cell(cell, 2**31 + 3, 0.2, False, torch.device("cpu"), root=root)
