"""The CPU tests' tiny checkout: each cell keeps the sizes it was tested at, every configuration
is held to sizes the suite's time limit allows, and the sizes come from the drivers and the
configurations' own files, never from a list of names."""

import json
import sys
import types

import pytest

from portbench import spec, testing

BENCH = spec.benchmark()
CONFIGS = [c["name"] for c in BENCH["configs"]]

FIT_CONFIG = dict(d=24, n_signal=4, m=4, n1=30, n2=30, N=240, max_iters=60)
SERVING_CONFIG = dict(d=24, n_signal=4, n_seed=200, tol=0.01, gate_block_cols=24)
# each cell's configuration changes and whole traffic mix at CPU test sizes
PINNED = {
    "sec51_d200_m20.oneshot": (FIT_CONFIG, {"pool": 4, "trace_units": 2}),
    "serving_d120.qps": (SERVING_CONFIG, {
        "sessions": 1, "judged_sessions": 1, "epoch_ticks": 32, "batch": 256, "ingest": 60,
        "ingest_every": 0, "refresh_every": 0, "query_pool": 4, "sampled_ticks": 8,
        "trace_units": 2}),
    "serving_d120.steady": (SERVING_CONFIG, {
        "sessions": 2, "judged_sessions": 2, "epoch_ticks": 24, "batch": 256, "ingest": 60,
        "ingest_every": 1, "refresh_every": 2, "query_pool": 4, "sampled_ticks": 8,
        "trace_units": 2}),
}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return testing.tiny_root(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("cell", sorted(PINNED))
def test_each_cell_keeps_the_cpu_test_sizes_it_had(root, cell):
    config, traffic = PINNED[cell]
    full = spec.cell(cell)
    tiny = spec.cell(cell, root)
    assert tiny.config == {**full.config, **config}
    assert tiny.traffic == traffic
    assert (tiny.driver, tiny.limits) == (full.driver, full.limits)


@pytest.mark.parametrize("name", CONFIGS)
def test_every_configuration_is_small_at_cpu_test_sizes(root, name):
    testing.check_cpu_sizes(root, name)


@pytest.mark.parametrize("name", CONFIGS)
def test_a_configuration_left_wide_at_cpu_test_sizes_is_named(tmp_path, name):
    src = testing.copy_data_files(spec.ROOT, tmp_path / "src")
    conf = next(c for c in BENCH["configs"] if c["name"] == name)
    testing.edit_json(src / conf["file"], lambda c: c.update(cpu_test={"d": 1000}))
    root = testing.tiny_root(tmp_path / "tiny", source=src)
    with pytest.raises(ValueError, match=name):
        testing.check_cpu_sizes(root, name)


FIRST = BENCH["workloads"][0]
SECOND = f"{FIRST['config']}.second"


def _second_cell(src, driver: str) -> None:
    """A second cell, ``SECOND``, of the first cell's configuration, driven by ``driver``."""
    testing.edit_json(src / "BENCHMARK.json", lambda b: b["workloads"].append(
        {**FIRST, "name": SECOND, "traffic": "second"}))
    (src / "portbench" / "workloads" / f"{SECOND}.json").write_text(json.dumps(
        {"config": FIRST["config"], "driver": driver, "traffic": {"size": 1000}, "limits": {}}))


def test_a_driver_without_cpu_test_sizes_is_named_with_its_file(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "portbench.traffic.sizeless", types.ModuleType("sizeless"))
    src = testing.copy_data_files(spec.ROOT, tmp_path / "src")
    _second_cell(src, "sizeless")
    with pytest.raises(AttributeError, match=rf"'sizeless'.*{SECOND}\.json"):
        testing.tiny_root(tmp_path / "tiny", source=src)


def test_a_configuration_two_drivers_name_is_shrunk_once_by_the_first(root, tmp_path,
                                                                      monkeypatch):
    def shrink_for_cpu_tests(config, traffic):
        config.update(d=7)
        traffic.update(size=1)

    other = types.ModuleType("other")
    other.shrink_for_cpu_tests = shrink_for_cpu_tests
    monkeypatch.setitem(sys.modules, "portbench.traffic.other", other)
    src = testing.copy_data_files(spec.ROOT, tmp_path / "src")
    _second_cell(src, "other")
    both = testing.tiny_root(tmp_path / "tiny", source=src)
    assert spec.cell(FIRST["name"], both).config == spec.cell(FIRST["name"], root).config
    assert spec.cell(SECOND, both).traffic == {"size": 1}
