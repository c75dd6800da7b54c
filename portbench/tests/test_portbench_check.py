"""The correctness check, driven end to end on the CPU at test sizes: the port against the plain
reference in every cell, the TF32 control and each planted fault coming out not correct, the last
line's schema, the import check, and the command refusing to run without a card."""

import json
import os
import subprocess
import sys

import pytest
import torch

from portbench import calibrate, run, spec, testing
from repro_torch.core import distributed, pipeline, rounds, streaming
from repro_torch.kernels import ops

torch.set_num_threads(1)

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
FIT_CELLS = [c for c in CELLS if spec.cell(c).driver == "fits"]
SERVING_CELLS = [c for c in CELLS if spec.cell(c).driver == "serving"]
CPU = torch.device("cpu")
SEEDS = (2**31 + 11, 2**31 + 97, 3 * 2**30 + 5)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return testing.tiny_root(tmp_path_factory.mktemp("tiny"))


@pytest.fixture
def card():
    """Whether this machine has a CUDA card (decided here, never at import)."""
    return torch.cuda.is_available()


def one_run(root, cell, seed=SEEDS[0], seconds=0.3):
    return run.run_cell(cell, seed, seconds, False, CPU, root=root)


@pytest.mark.parametrize("cell", CELLS)
def test_the_port_agrees_with_the_reference(root, cell):
    result = one_run(root, cell)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {m["name"] for m in spec.cell(cell, root).end_to_end}


@pytest.mark.parametrize("cell", CELLS)
def test_the_tf32_control_is_not_correct(root, cell):
    got = list(calibrate.readings(cell, SEEDS, "control", CPU, root=root))
    assert [r["correct"] for r in got] == [False] * len(SEEDS), [r["checks"] for r in got]


def _unchanged_solve(a, b, lam, **kw):
    return torch.zeros_like(b)


def _half_machines_mean(self, x):
    return x[: self.m // 2].mean(0)


def _altered_fit(real):
    calls = []

    def fit(*args, **kw):
        out = real(*args, **kw)
        calls.append(1)
        if len(calls) == 3:  # one answer of the window (the first call is the warm-up)
            out = out.clone()
            out[0] += 0.05 * out.abs().max()
        return out
    return fit


def _plants(cell, monkeypatch):
    """Each fault the cell can have, as a function that plants it in the port."""
    if cell in FIT_CELLS:
        return {
            "state unchanged": lambda: monkeypatch.setattr(ops, "dantzig_fused", _unchanged_solve),
            "half the machines, mean over the rest": lambda: monkeypatch.setattr(
                rounds._SimRound, "mean", _half_machines_mean),
            "no exchange between machines": lambda: monkeypatch.setattr(
                rounds._SimRound, "mean", lambda self, x: x[0]),
            "an answer altered": lambda: monkeypatch.setattr(
                distributed, "simulated_distributed_slda",
                _altered_fit(distributed.simulated_distributed_slda)),
        }
    real_stats, real_classify = pipeline.suff_stats, streaming.classify_batch

    def half_stats(x, y, use_kernel=None):
        return real_stats(x[: x.shape[0] // 2], y[: y.shape[0] // 2], use_kernel)

    def flipped(*args, **kw):
        pred, scores = real_classify(*args, **kw)
        pred = pred.clone()
        pred[0] = 1 - pred[0]
        return pred, scores

    return {
        "state unchanged": lambda: monkeypatch.setattr(
            streaming.ServingRuntime, "ingest_batch", lambda self, aux, *raw: True),
        "half the batch, mean over the rest": lambda: monkeypatch.setattr(
            pipeline, "suff_stats", half_stats),
        "an answer altered": lambda: monkeypatch.setattr(streaming, "classify_batch", flipped),
    }


def _serving_faults(cell):
    """A serving cell's faults: ingest is the step that changes its state, where it ingests at
    all; the statistics (the seed fit's, and each batch's) and the answers are in every one."""
    ingests = spec.cell(cell).traffic["ingest_every"] > 0
    return ("state unchanged",) * ingests + ("half the batch, mean over the rest",
                                             "an answer altered")


FAULTS = [(c, f) for c in FIT_CELLS for f in (
    "state unchanged", "half the machines, mean over the rest", "no exchange between machines",
    "an answer altered")] + [(c, f) for c in SERVING_CELLS for f in _serving_faults(c)]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_planted_fault_is_not_correct(root, cell, fault, monkeypatch):
    _plants(cell, monkeypatch)[fault]()
    result = one_run(root, cell)
    assert not result["correct"], result["checks"]


def test_the_last_line_schema(root):
    result = one_run(root, CELLS[0])
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    assert isinstance(result["correct"], bool)
    assert all(isinstance(result[k], int) for k in ("attempted", "failed"))
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    assert json.loads(json.dumps(result)) == result


def test_the_import_check_compares_whole_top_level_names():
    assert run.forbidden_modules(["repro_torch.core", "repro_torchx", "jaxtyping"]) == []
    assert run.forbidden_modules(["repro.core.pipeline", "jax.numpy", "jaxlib", "flax.linen",
                                  "benchmarks.run", "chip_smoke"]) == [
        "benchmarks", "chip_smoke", "flax", "jax", "jaxlib", "repro"]


def _child_env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(extra)
    return env


def test_a_cell_run_loads_no_jax_and_no_jax_package(root):
    body = ("import sys, torch; torch.set_num_threads(1)\n"
            "from portbench import run\n"
            f"run.run_cell({CELLS[0]!r}, 7, 0.1, False, torch.device('cpu'), root={str(root)!r})\n"
            "print(run.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", body], capture_output=True, text=True,
                         cwd=spec.ROOT, env=_child_env(), timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_command_refuses_to_run_without_a_card(card):
    env = _child_env(CUDA_VISIBLE_DEVICES="") if card else _child_env()
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=spec.ROOT, env=env, timeout=120)
    assert out.returncode == 2 and out.stdout == ""


def _refuse_first_draw(monkeypatch, reference_refuses: bool):
    """The port refuses the first seed sample drawn; the reference refuses it too, or fits it."""
    from portbench.reference import serving as ref_serving
    from portbench.traffic import serving

    real, real_ref, refused = serving.Program.__init__, ref_serving.Server.__init__, []

    def refuse_once(self, x0, *args, **kw):
        if not refused:
            refused.append(x0.clone())
            raise RuntimeError("initial fit did not converge within 3 attempts")
        real(self, x0, *args, **kw)

    def reference(self, x, *args, **kw):
        if reference_refuses and refused and torch.equal(x, refused[0]):
            raise RuntimeError("reference: the seed fit did not converge")
        real_ref(self, x, *args, **kw)

    monkeypatch.setattr(serving.Program, "__init__", refuse_once)
    monkeypatch.setattr(ref_serving.Server, "__init__", reference)
    return refused


def test_a_seed_sample_the_runtime_refuses_is_drawn_again(root, monkeypatch):
    refused = _refuse_first_draw(monkeypatch, reference_refuses=True)
    result = one_run(root, SERVING_CELLS[0])
    assert refused and result["correct"], result["checks"]
    assert result["checks"]["refused_fits"]["value"] == 0


@pytest.mark.parametrize("cell", SERVING_CELLS)
def test_a_seed_sample_only_the_port_refuses_is_not_correct(root, cell, monkeypatch):
    refused = _refuse_first_draw(monkeypatch, reference_refuses=False)
    result = one_run(root, cell)
    assert refused and not result["correct"]
    assert result["checks"]["refused_fits"]["value"] == 1


@pytest.mark.parametrize("cell", SERVING_CELLS)
def test_a_traced_run_times_every_call_of_its_untraced_window(root, cell, monkeypatch):
    seen = {}
    real = run.spec.reader

    def spy(name, root=run.spec.ROOT):
        read = real(name, root)

        def wrapped(tr):
            seen[name] = dict(tr.host_timed)
            return read(tr)
        return wrapped

    monkeypatch.setattr(run.spec, "reader", spy)
    monkeypatch.setattr(run.trace, "capture", _capture_on_the_cpu)
    monkeypatch.setattr(run.trace, "warm_profiler", lambda: None)
    result = run.run_cell(cell, SEEDS[1], 0.3, True, CPU, root=root)
    assert result["correct"], result["checks"]
    group = cell.split(".")[-1]
    timed = seen[f"query_p95_ms.{group}"]
    assert len(timed["classify"]) > 0 and all(t > 0 for t in timed["classify"])
    assert result["metrics"][f"query_p95_ms.{group}"]["value"] > 0
    refreshes = spec.cell(cell, root).traffic["refresh_every"]
    assert bool(timed["refresh"]) == bool(refreshes)
    assert (f"refresh_p95_ms.{group}" in result["metrics"]) == bool(refreshes)


def _capture_on_the_cpu(fn, counts_of, launch_shapes, config):
    """``trace.capture`` without a card: the work runs, and the trace holds one device event."""
    from portbench import trace

    result = fn()
    events = [trace.DeviceEvent("k", 0, 10, "kernel", -1, -1)]
    return result, trace.Trace((0, 100), events, [], counts_of(result), {}, config)


@pytest.mark.parametrize("cell", SERVING_CELLS)
def test_a_session_only_the_port_cannot_refresh_is_not_correct(root, cell, monkeypatch):
    """A session whose epoch the port cannot serve whole (a refresh publishes nothing) is drawn
    again; the reference serves that draw whole, so the check finds the port at fault."""
    from portbench.traffic import serving

    real, calls = serving._misses_a_refresh, []

    def port_misses_first(system, *args):
        calls.append(1)
        return len(calls) == 1 or real(system, *args)

    monkeypatch.setattr(serving, "_misses_a_refresh", port_misses_first)
    result = one_run(root, cell)
    assert not result["correct"] and result["checks"]["refused_fits"]["value"] == 1
