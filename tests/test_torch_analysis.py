"""The port's analyzer analyzed (twin of ``tests/test_analysis.py``).

Every contract kind must (a) hold on a conforming call and (b) trip on
a deliberately violating one, naming what tripped it; the import rules
trip on synthetic trees and hold on ``repro_torch/``; the port's
registry, cases and params equal the reference's; and the lint CLI
passes on the CPU, the four 8-rank remainder cases included.
"""

import io
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from repro.analysis import cases as jax_cases
from repro.analysis import registry as jax_registry
from repro_torch.analysis import (
    AxisPayloadBits,
    CollectiveContract,
    DtypePolicy,
    GramLaunches,
    OpCounts,
    Param,
    PrimitiveBudget,
    SmemConformance,
    check_entry,
    count_ops,
    run_contracts,
    trace_contract,
)
from repro_torch.analysis import cases as cases_mod
from repro_torch.analysis import imports as import_rules
from repro_torch.analysis import lint, registry
from repro_torch.core import collectives
from repro_torch.core.collectives import CollectiveRecord
from repro_torch.core.dantzig import DantzigConfig
from repro_torch.core.solver_dispatch import solve_dantzig
from repro_torch.kernels import ops
from repro_torch.kernels.dantzig_fused import plan_launch
import test_torch_parity  # noqa: F401  (pins torch to one thread)

REPO = Path(__file__).resolve().parents[1]
K1_KEY = "gram_launches"  # the port's one extra param key (K1 on the card)


def _counts(**kw) -> OpCounts:
    """Hand-made counts of a call, empty unless given."""
    base = dict(ops={}, eigh=0, matmul=0, float_outputs={}, bytes_accessed=0, is_finite=0,
                calls=dict.fromkeys(ops.KERNELS, 0), launches=dict.fromkeys(ops.KERNELS, 0),
                call_shapes={}, call_blocks={}, solves=0, collectives=(), unrecorded={},
                on_card=False)
    return OpCounts(**{**base, **kw})


@pytest.fixture
def world(tmp_path):
    """A one-rank gloo group; ``collectives.Axis`` handles for a (data, model) mesh on it."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        yield {name: collectives.Axis(name, dist.group.WORLD) for name in ("data", "model")}
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# primitive budgets
# ---------------------------------------------------------------------------


def test_primitive_budget_trips_on_double_eigh():
    a = torch.eye(3)
    _, counts = count_ops(lambda: (torch.linalg.eigh(a), torch.linalg.eigh(a + 1.0)))
    assert PrimitiveBudget("eigh", exact=1).check(counts) != []
    assert PrimitiveBudget("eigh", max_count=1).check(counts) != []
    assert PrimitiveBudget("eigh", max_count=2).check(counts) == []
    assert PrimitiveBudget("eigh", min_count=3).check(counts) != []
    (violation,) = PrimitiveBudget("eigh", exact=1).check(counts)
    assert "found 2" in violation.message and violation.sites


def test_budget_param_resolution_and_missing_param():
    _, counts = count_ops(lambda: torch.linalg.eigh(torch.eye(3)))
    budget = PrimitiveBudget("eigh", exact=Param("eighs"))
    assert run_contracts([budget], counts, {"eighs": 1}) == []
    assert run_contracts([budget], counts, {"eighs": 2}) != []
    (violation,) = run_contracts([budget], counts, {})
    assert "eighs" in violation.message  # a missing key is itself reported


def test_unknown_primitive_raises():
    with pytest.raises(ValueError, match="no counted category"):
        PrimitiveBudget("custom_call", exact=0).check(_counts())


def test_solver_loops_count_dispatched_solves():
    # the reference's while / scan: any Dantzig solve in the call
    a, b = torch.eye(4) * 2.0, torch.ones(4)
    _, counts = count_ops(solve_dantzig, a, b, 0.1, DantzigConfig(max_iters=5))
    assert counts.solves == 1
    for prim in ("while", "scan"):
        assert PrimitiveBudget(prim, exact=0).check(counts) != []
        assert PrimitiveBudget(prim, exact=1).check(counts) == []


def test_is_finite_counts_screens_not_the_factor_guard():
    from repro_torch.core.faults import Aggregation, screen_weight
    from repro_torch.kernels.spectral import spectral_factor

    x = torch.eye(3)
    _, guard = count_ops(spectral_factor, x)
    _, screened = count_ops(lambda: (screen_weight(Aggregation(), x), x.isfinite()))
    assert guard.is_finite == 0 and guard.eigh == 1
    assert screened.is_finite == 2
    assert PrimitiveBudget("is_finite", exact=1).check(screened) != []


def test_pallas_call_reads_calls_on_the_cpu_and_launches_on_the_card():
    cpu = _counts(calls={**dict.fromkeys(ops.KERNELS, 0), "dantzig_fused": 2})
    assert PrimitiveBudget("pallas_call", exact=2).check(cpu) == []
    card = cpu._replace(on_card=True, launches={**dict.fromkeys(ops.KERNELS, 0),
                                                "dantzig_fused": 2})
    assert PrimitiveBudget("pallas_call", exact=2).check(card) == []
    # a call on the card that did not launch its kernel
    short = card._replace(launches={**card.launches, "dantzig_fused": 1})
    messages = [v.message for v in PrimitiveBudget("pallas_call", exact=1).check(short)]
    assert messages == ["dantzig_fused: 2 calls on the card but 1 launches"]


def test_gram_launches_on_each_device():
    grams = {**dict.fromkeys(ops.KERNELS, 0), "gram": 2}
    assert GramLaunches(2).check(_counts()) == []  # the CPU's statistics take the product
    (cpu,) = GramLaunches(2).check(_counts(calls=grams))
    assert "on the CPU, expected 0" in cpu.message
    card = _counts(calls=grams, launches=grams, on_card=True)
    assert GramLaunches(Param(K1_KEY)).check(card, {K1_KEY: 2}) == []
    (wrong,) = GramLaunches(1).check(card)
    assert "found 2 K1 on the card, expected 1" in wrong.message
    skipped = card._replace(launches={**grams, "gram": 1})
    assert any("2 K1 calls on the card but 1 launches" in v.message
               for v in GramLaunches(2).check(skipped))


def test_wrapper_calls_are_counted_on_the_cpu():
    x = torch.randn(2, 5, 3)
    _, counts = count_ops(ops.gram, x, x.mean(-2))
    assert counts.calls["gram"] == 1 and counts.launches["gram"] == 0
    assert counts.call_shapes == {("gram", 2, 5, 3): 1} and not counts.on_card


# ---------------------------------------------------------------------------
# collective contracts: count, payload shape/dtype, mesh axis
# ---------------------------------------------------------------------------


def test_collective_contract_holds_on_conforming_call(world):
    x = torch.ones(4)
    _, counts = count_ops(collectives.all_reduce_sum, x, (world["data"],))
    good = CollectiveContract("psum", count=1, axis="data", shape=(4,), dtype="float32")
    assert good.check(counts) == []


def test_collective_contract_trips_on_extra_psum(world):
    x = torch.ones(4)
    _, counts = count_ops(lambda: collectives.all_reduce_sum(x, (world["data"],))
                          + collectives.all_reduce_sum(2.0 * x, (world["data"],)))
    violations = CollectiveContract("psum", count=1, axis="data", shape=(4,)).check(counts)
    assert violations and "found 2" in violations[0].message
    assert all("psum" in s for s in violations[0].sites)


def test_collective_contract_trips_on_wrong_payload_shape(world):
    _, counts = count_ops(collectives.all_reduce_sum, torch.ones(4), (world["data"],))
    violations = CollectiveContract("psum", count=1, shape=(5,)).check(counts)
    assert violations and "expected exactly 1" in violations[0].message


def test_collective_contract_trips_on_wrong_axis(world):
    _, counts = count_ops(collectives.all_reduce_sum, torch.ones(4), (world["model"],))
    violations = CollectiveContract("psum", count=1, axis="data", shape=(4,)).check(counts)
    assert violations and "'data'" in violations[0].message


def test_collective_contract_trips_on_payload_dtype(world):
    x = torch.ones(4, dtype=torch.bfloat16)
    _, counts = count_ops(collectives.all_reduce_sum, x, (world["data"],))
    violations = CollectiveContract("psum", count=1, shape=(4,), dtype="float32").check(counts)
    assert violations and "bfloat16" in violations[0].message


def test_collective_contract_axis_filter_ignores_other_axes(world):
    x = torch.ones(4)
    _, counts = count_ops(lambda: (collectives.all_reduce_sum(x, (world["data"],)),
                                   collectives.all_reduce_sum(x, (world["model"],))))
    assert CollectiveContract("psum", count=1, axis="data", shape=(4,),
                              dtype="float32").check(counts) == []
    assert CollectiveContract("psum", count=1, axis="model").check(counts) == []


def test_a_collective_over_two_axes_is_one_record_of_two_hops():
    pod_data = CollectiveRecord("psum", "data", ("pod", "data"), (8, 1), "float32", 256, 2)
    counts = _counts(collectives=(pod_data,))
    assert CollectiveContract("psum", count=1, axis="data").check(counts) == []
    assert CollectiveContract("psum", count=1, axis="pod").check(counts) == []
    assert AxisPayloadBits("data", exact_bits=256).check(counts) == []


def test_unrecorded_backend_collective_trips_the_budget(world):
    x = torch.ones(4)
    _, counts = count_ops(lambda: dist.all_reduce(x))
    assert PrimitiveBudget("psum", exact=0).check(counts) != []
    (violation,) = AxisPayloadBits("data", exact_bits=0).check(counts)
    assert "outside repro_torch.core.collectives" in violation.message


# ---------------------------------------------------------------------------
# axis payload bits: total traffic over one mesh axis, at wire dtypes
# ---------------------------------------------------------------------------


def test_axis_payload_bits_exact_max_and_axis_scope(world):
    # one f32 psum of (4,) over the data axis = 128 bits per link
    _, counts = count_ops(collectives.all_reduce_sum, torch.ones(4), (world["data"],))
    assert AxisPayloadBits("data", exact_bits=128).check(counts) == []
    assert AxisPayloadBits("data", max_bits=128).check(counts) == []
    (violation,) = AxisPayloadBits("data", exact_bits=64).check(counts)
    assert "128" in violation.message and violation.sites
    (violation,) = AxisPayloadBits("data", max_bits=100).check(counts)
    assert "128" in violation.message
    # traffic on OTHER axes does not count toward this axis's total
    assert AxisPayloadBits("model", exact_bits=0).check(counts) == []


def test_axis_payload_bits_sums_wire_dtypes(world):
    # a gather prices what one link uplinks (the operand), not the gathered
    # result; int16 travels as its bytes and is counted as int16
    def body():
        vals = collectives.all_gather_stack(torch.ones(4, dtype=torch.bfloat16),
                                            (world["data"],))
        idx = collectives.all_gather_stack(torch.arange(4, dtype=torch.int16),
                                           (world["data"],))
        return vals, idx

    (vals, idx), counts = count_ops(body)
    assert idx.dtype == torch.int16 and idx.tolist() == [[0, 1, 2, 3]]
    assert [r.dtype for r in counts.collectives] == ["bfloat16", "int16"]
    assert AxisPayloadBits("data", exact_bits=128).check(counts) == []
    assert AxisPayloadBits("data", exact_bits=256).check(counts) != []


# ---------------------------------------------------------------------------
# dtype policy and shared-memory conformance
# ---------------------------------------------------------------------------


def test_dtype_policy_passes_f32_and_trips_at_bf16_ceiling_and_on_f64():
    x = torch.ones(3, 3, dtype=torch.bfloat16)
    _, counts = count_ops(lambda: x.float() @ x.float().mT)
    assert DtypePolicy().check(counts) == []  # f32 ceiling: clean
    violations = DtypePolicy(max_float="bfloat16").check(counts)
    assert violations and "float32" in violations[0].message and violations[0].sites
    _, wide = count_ops(lambda: x.double())
    assert "float64" in DtypePolicy().check(wide)[0].message


def test_smem_conformance_holds_on_fused_calls_and_trips_on_overruns():
    cfg = DantzigConfig(max_iters=5, adapt_rho=False, fused=True)
    a = torch.eye(16) * 2.0
    _, counts = count_ops(solve_dantzig, a, torch.ones(16, 3), 0.1, cfg)
    assert counts.call_blocks == {("dantzig_fused", 16, 3, 3): 1}
    assert SmemConformance().check(counts) == []
    small = [v.message for v in SmemConformance(budget=Param("budget")).check(
        counts, {"budget": 1024})]
    assert any("budget is 1024" in m for m in small)
    # a block wider than the blocking model allows at d = 200
    allowed = plan_launch(200, 200).block_k
    wide = _counts(call_blocks={("dantzig_fused", 200, 200, allowed + 8): 1})
    messages = [v.message for v in SmemConformance().check(wide)]
    assert any(f"exceeds plan_launch's choice {allowed}" in m for m in messages)


@pytest.mark.parametrize("bk,conforms", [(24, True), (32, False)], ids=["model", "wider"])
def test_smem_conformance_reads_the_streamed_footprint_at_d1000(bk, conforms):
    # a d = 1,000 K2 call takes the streamed template: its 24-column block (two product
    # buffers, 192,192 bytes) conforms; 32 columns exceed the model and the budget
    assert plan_launch(1000, 1000).block_k == 24
    counts = _counts(call_blocks={("dantzig_fused", 1000, 1000, bk): 1})
    messages = [v.message for v in SmemConformance().check(counts)]
    if conforms:
        assert messages == []
    else:
        assert any("exceeds plan_launch's choice 24" in m for m in messages)
        assert any("the streamed block (d=1000, W=32) needs 256256 bytes" in m for m in messages)


# ---------------------------------------------------------------------------
# registry: contracts travel with the entry point; breaks are named
# ---------------------------------------------------------------------------


def test_registry_decorator_registers_and_checks():
    @trace_contract("selftest.double_eigh", contracts=(PrimitiveBudget("eigh", exact=1),))
    def double_eigh(a):
        return torch.linalg.eigh(a)[1] + torch.linalg.eigh(a + 1.0)[1]

    try:
        assert "selftest.double_eigh" in registry.registered()
        assert registry.registered()["selftest.double_eigh"].fn is double_eigh
        _, counts = count_ops(double_eigh, torch.eye(3))
        violations = check_entry("selftest.double_eigh", counts, {})
        assert len(violations) == 1 and "eigh" in violations[0].sites[0]
    finally:
        registry.unregister("selftest.double_eigh")
    assert "selftest.double_eigh" not in registry.registered()


def test_lint_run_api_passes_on_real_entry():
    buf = io.StringIO()
    n = lint.run(["pipeline.worker_debiased"], include_imports=False, out=buf, device="cpu")
    assert n == 0, buf.getvalue()
    assert "[ok] binary-fused-d12" in buf.getvalue()


def test_lint_run_reports_broken_entry():
    @trace_contract("selftest.lint_broken", contracts=(PrimitiveBudget("pallas_call", exact=1),))
    def plain(x):
        return x * 2.0

    @cases_mod.case("selftest.lint_broken", "neg", {})
    def _build(device="cuda"):
        return plain, (torch.ones(2, 2, device=device),)

    try:
        buf = io.StringIO()
        n = lint.run(["selftest.lint_broken"], include_imports=False, out=buf, device="cpu")
        report = buf.getvalue()
        assert n == 1
        assert "[FAIL] neg" in report and "pallas_call" in report
    finally:
        registry.unregister("selftest.lint_broken")
        cases_mod._CASES.pop("selftest.lint_broken", None)


def test_every_registered_entry_has_cases():
    for name in registry.registered():
        assert cases_mod.cases_for(name), f"{name} has no cases"


# ---------------------------------------------------------------------------
# parity with the reference's registry and cases
# ---------------------------------------------------------------------------


def test_entries_and_cases_are_the_references():
    ours = cases_mod.all_cases()
    theirs = jax_cases.all_cases()
    assert sorted(registry.registered()) == sorted(jax_registry.registered())
    assert sorted(ours) == sorted(theirs)
    for entry in theirs:
        assert [c.name for c in ours[entry]] == [c.name for c in theirs[entry]], entry
    assert sum(len(v) for v in ours.values()) == 43
    # the reference's min_devices=8 cases are the port's 8-rank (2, 4) meshes
    assert sorted((c.entry, c.name) for v in ours.values() for c in v if c.mesh == (2, 4)) == \
        sorted((c.entry, c.name) for v in theirs.values() for c in v if c.min_devices == 8)


@pytest.mark.parametrize("entry", sorted(jax_cases.all_cases()))
def test_case_params_are_the_references(entry):
    theirs = {c.name: c.params for c in jax_cases.cases_for(entry)}
    for c in cases_mod.cases_for(entry):
        ours = {k: v for k, v in c.params.items() if k != K1_KEY}
        assert ours == theirs[c.name], (entry, c.name)


# ---------------------------------------------------------------------------
# AST import-graph rules (units on synthetic trees)
# ---------------------------------------------------------------------------


def _write_tree(root, files):
    for rel, src in files.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(src)


def test_banned_import_rule_flags_both_import_forms(tmp_path):
    _write_tree(tmp_path, {
        "repro_torch/core/dantzig.py": "def solve_dantzig_scan():\n    pass\n",
        "repro_torch/core/solver_dispatch.py":
            "from repro_torch.core.dantzig import solve_dantzig_scan\n",  # allowed
        "repro_torch/core/evil.py": "from repro_torch.core.dantzig import solve_dantzig_scan\n",
        "repro_torch/core/sneaky.py":
            "from repro_torch.core import dantzig as dz\n"
            "def f(a, b):\n    return dz.solve_dantzig_scan(a, b)\n",
        "repro_torch/core/innocent.py":
            "# from repro_torch.core.dantzig import solve_dantzig_scan (a comment!)\n"
            "S = 'dantzig.solve_dantzig_scan('\n",
    })
    violations = import_rules.banned_import_violations(tmp_path)
    offenders = {v.sites[0].rsplit(":", 1)[0] for v in violations}
    assert offenders == {str(tmp_path / "repro_torch/core/evil.py"),
                         str(tmp_path / "repro_torch/core/sneaky.py")}


def test_exclusive_call_rule_ignores_comments_and_strings(tmp_path):
    _write_tree(tmp_path, {
        "repro_torch/core/collectives.py":
            "import torch.distributed as dist\ndef g(x):\n    dist.all_reduce(x)\n",  # allowed
        "repro_torch/core/rogue.py":
            "import torch.distributed as dist\ndef f(x, parts):\n"
            "    dist.all_gather(parts, x)\n",
        "repro_torch/core/sly.py":
            "from torch.distributed import all_reduce\ndef f(x):\n    all_reduce(x)\n",
        "repro_torch/core/clean.py":
            "# dist.all_gather( in a comment must not trip\n"
            "DOC = 'dist.all_reduce('\ndef h(objs, o, dist):\n"
            "    dist.all_gather_object(objs, o)\n",
    })
    violations = import_rules.exclusive_call_violations(tmp_path)
    assert sorted(Path(v.sites[0].rsplit(":", 1)[0]).name for v in violations) == \
        ["rogue.py", "sly.py"]


def test_gather_rule_allows_only_the_gather_sites(tmp_path):
    _write_tree(tmp_path, {
        "repro_torch/core/pipeline.py":
            "from repro_torch.core import collectives\ndef g(x, ax):\n"
            "    return collectives.all_gather_tiled(x, ax)\n",  # allowed
        "repro_torch/core/rounds.py":
            "from repro_torch.core import collectives\ndef f(x, axes):\n"
            "    return collectives.all_gather_stack(x, axes)\n",
    })
    violations = import_rules.gather_call_violations(tmp_path)
    assert len(violations) == 1 and "rounds.py" in violations[0].sites[0]


def test_pipeline_unification_rule(tmp_path):
    good = {f"repro_torch/core/{leaf}.py":
            "from repro_torch.core import pipeline\n"
            "def run():\n    return pipeline.worker_debiased\n"
            for leaf in ("slda", "distributed", "multiclass")}
    good["repro_torch/core/rounds.py"] = (
        "from repro_torch.core import pipeline\n"
        "def step():\n    return pipeline.worker_solves, pipeline.apply_correction\n")
    _write_tree(tmp_path, good)
    assert import_rules.pipeline_unification_violations(tmp_path) == []
    # break one face: multiclass stops importing the pipeline core
    (tmp_path / "repro_torch/core/multiclass.py").write_text("def run():\n    return 7\n")
    violations = import_rules.pipeline_unification_violations(tmp_path)
    assert violations and any("multiclass" in v.message for v in violations)


def test_reachability_rule_flags_dead_modules(tmp_path):
    _write_tree(tmp_path, {
        "repro_torch/__init__.py": "",
        "repro_torch/quickstart.py": "from repro_torch.core import used\n",
        "repro_torch/core/__init__.py": "",
        "repro_torch/core/used.py": "def f():\n    from repro_torch.core import lazy\n",
        "repro_torch/core/lazy.py": "",
        "repro_torch/core/smoked.py": "",
        "repro_torch/interop.py": "",
        "repro_torch/core/dead.py": "X = 1\n",
        "chip_smoke.py": "from repro_torch.core import smoked\n",
    })
    violations = import_rules.unreachable_module_violations(tmp_path)
    assert [v.message.split()[0] for v in violations] == ["repro_torch.core.dead"]


def test_structural_rules_hold_on_the_port():
    assert import_rules.structural_violations() == []


def test_the_rules_never_walk_the_reference():
    names = [mod for mod, _ in import_rules.iter_modules()]
    assert names and all(m == "repro_torch" or m.startswith("repro_torch.") for m in names)


# ---------------------------------------------------------------------------
# the CLI, every case on the CPU
# ---------------------------------------------------------------------------


def _cli(*args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-m", *args], capture_output=True, text=True,
                          timeout=600, env=env, cwd=REPO)


def test_lint_cli_passes_every_case_on_the_cpu():
    proc = _cli("repro_torch.analysis.lint", "--cpu")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.count("  [ok] ") == 43 and "[FAIL]" not in proc.stdout
    assert "[ok] import-graph rules" in proc.stdout
    for name in ("fused-rounds3-mesh2x4-d70-remainder",
                 "fused-rounds3-mesh2x4-d70-remainder-top16-bf16",
                 "fused-rounds3-mesh2x4-d70-top16-bf16-down8-int8",
                 "fused-rounds3-mesh2x4-d70-masked-faulted"):
        assert f"[ok] {name}\n" in proc.stdout


def test_lint_list_names_the_references_entries_and_cases():
    def names(text):
        return [line.split(" (")[0] for line in text.splitlines() if line.strip()]

    ours = _cli("repro_torch.analysis.lint", "--list")
    assert ours.returncode == 0, ours.stderr
    theirs = [f"{name}" for name in sorted(jax_registry.registered())]
    listed = names(ours.stdout)
    assert [n for n in listed if not n.startswith("  ")] == theirs
    assert [n.strip() for n in listed if n.startswith("  ")] == [
        c.name for entry in theirs for c in jax_cases.cases_for(entry)]
