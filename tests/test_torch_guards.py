"""Structural guards of the port: no JAX, no reference imports, no silent CPU default."""

import ast
import importlib
import inspect
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import quickstart
from repro_torch.stats import synthetic
import test_torch_parity  # noqa: F401  (pins torch to one thread)

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_neither_jax_nor_the_reference(path):
    assert not _imported_roots(path) & {"jax", "jaxlib", "repro"}


def test_every_port_module_imports_without_jax():
    body = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "print(len(names))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", body], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-4000:]
    assert int(res.stdout.strip()) >= 20


def test_entry_points_default_to_the_card(monkeypatch):
    # on a machine without a card, an entry point called without
    # device= raises instead of running on the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    problem = synthetic.make_problem(d=8, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        synthetic.sample_machines(torch.Generator(), problem, 2, 4, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        synthetic.make_problem(d=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        quickstart.main()


SLICE_MODULES = ["repro_torch.core.multiclass", "repro_torch.core.compression",
                 "repro_torch.core.faults", "repro_torch.core.transport",
                 "repro_torch.core.rounds"]


MESH_MODULES = ["repro_torch.core.collectives", "repro_torch.core.distributed",
                "repro_torch.launch.mesh", "repro_torch.launch.mesh_cases",
                "repro_torch.mesh_distributed_lda"]


SERVING_MODULES = ["repro_torch.core.streaming", "repro_torch.checkpoint.io",
                   "repro_torch.launch.serve", "repro_torch.analysis.counts"]


ANALYSIS_MODULES = ["repro_torch.analysis.contracts", "repro_torch.analysis.registry",
                    "repro_torch.analysis.cases", "repro_torch.analysis.imports",
                    "repro_torch.analysis.lint", "repro_torch.launch.dryrun_slda"]


@pytest.mark.parametrize("name", SLICE_MODULES)
def test_multiclass_and_rounds_modules_stand_alone_and_default_to_the_card(name):
    _stands_alone_and_defaults_to_the_card(name)


@pytest.mark.parametrize("name", MESH_MODULES)
def test_mesh_modules_stand_alone_and_default_to_the_card(name):
    _stands_alone_and_defaults_to_the_card(name)


@pytest.mark.parametrize("name", SERVING_MODULES)
def test_serving_modules_stand_alone_and_default_to_the_card(name):
    _stands_alone_and_defaults_to_the_card(name)


@pytest.mark.parametrize("name", ANALYSIS_MODULES)
def test_analysis_modules_stand_alone_and_default_to_the_card(name):
    _stands_alone_and_defaults_to_the_card(name)


def test_configs_keep_the_references_names():
    import repro.configs as jax_configs
    from repro_torch import configs

    assert configs.PAPER_SYNTHETIC.SYNTHETIC is configs.SYNTHETIC
    assert set(jax_configs.__all__) <= set(dir(configs))


def test_analysis_entry_points_default_to_the_card(monkeypatch):
    from repro_torch.analysis import lint
    from repro_torch.launch import dryrun_slda

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lint.main(["--no-imports", "--entry", "streaming.classify_batch"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun_slda.main(["--d", "8", "--n", "8", "--iters", "1", "--out", ""])


def test_serving_entry_points_default_to_the_card(monkeypatch, tmp_path):
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.core.pipeline import suff_stats
    from repro_torch.core.streaming import ServingRuntime
    from repro_torch.launch import serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = torch.randn(20, 6, generator=torch.Generator().manual_seed(0))
    aux = suff_stats(x[:10], x[10:] + 1.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingRuntime(aux, 0.1, 0.2, 1e-3)
    save_checkpoint(str(tmp_path), 1, {"a": torch.zeros(2)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        restore_checkpoint(str(tmp_path), 1, {"a": torch.zeros(2)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingRuntime.restore(str(tmp_path), aux, 0.1, 0.2, 1e-3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--smoke"])
    assert restore_checkpoint(str(tmp_path), 1, {"a": torch.ones(2)}, device="cpu")["a"].eq(0).all()


def _stands_alone_and_defaults_to_the_card(name):
    # each new module is one of the guarded files, and every function or
    # method of it that takes a device takes "cuda" unless told otherwise
    module = importlib.import_module(name)
    path = Path(module.__file__).resolve()
    assert path in PORT_FILES
    assert not _imported_roots(path) & {"jax", "jaxlib", "repro"}
    members = [obj for _, obj in inspect.getmembers(module)
               if getattr(obj, "__module__", None) == name]
    funcs = [f for obj in members
             for f in ([obj] if inspect.isfunction(obj) else
                       [v for v in vars(obj).values() if inspect.isfunction(v)]
                       if inspect.isclass(obj) else [])]
    assert funcs
    for f in funcs:
        param = inspect.signature(f).parameters.get("device")
        if param is not None:
            assert param.default == "cuda", f"{name}.{f.__qualname__}"


def test_multiclass_and_fault_entry_points_default_to_the_card(monkeypatch):
    from repro_torch.core.faults import FaultSchedule

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        synthetic.make_mc_problem(d=8)
    problem = synthetic.make_mc_problem(d=8, num_classes=2, n_signal=2, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        synthetic.sample_mc_machines(torch.Generator(), problem, 2, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FaultSchedule(dropout=0.1).plan(3, 2)
    assert FaultSchedule(dropout=0.1).plan(3, 2, device="cpu").live.shape == (3, 2)


def test_samplers_draw_on_the_requested_device():
    problem = synthetic.make_problem(d=8, device="cpu")
    gen = torch.Generator().manual_seed(0)
    xs, ys = synthetic.sample_machines(gen, problem, 3, 5, 6, device="cpu")
    assert xs.shape == (3, 5, 8) and ys.shape == (3, 6, 8)
    z, labels = synthetic.sample_labeled(gen, problem, 10, device="cpu")
    assert z.shape == (10, 8) and set(labels.tolist()) <= {0, 1}
    x, y = synthetic.sample_two_class(gen, problem, 4, 2, device="cpu")
    assert x.shape == (4, 8) and y.shape == (2, 8)


@pytest.mark.parametrize("alone", [False, True], ids=["in-repo", "alone"])
def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path, alone):
    # with no card visible the smoke must exit non-zero and print no
    # result, and copied alone into an empty directory it must fail too
    script = REPO / "chip_smoke.py"
    cwd = REPO
    if alone:
        cwd = tmp_path
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
