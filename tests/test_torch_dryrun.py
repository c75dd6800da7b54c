"""The production-mesh dry run on the CPU (twin of the reference's ``repro.launch.dryrun_slda``).

One rank of the one-shot estimator runs in a fake process group at
world 256 (16 x 16) and 512 (2 x 16 x 16); its data-axis uplink must be
the reference's analytic accounting, one (d, 1) f32 vector a machine,
and its model-axis gather one tiled block of ceil(d / 16) rows.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.analysis.cases import _comm_params
from repro.core.transport import CommPlan
from repro_torch.launch import dryrun_slda
import test_torch_parity  # noqa: F401  (pins torch to one thread)

REPO = Path(__file__).resolve().parents[1]
D = 32
FIELDS = ("flops_per_device", "bytes_per_device", "collective_bytes_per_device", "collectives",
          "paper_uplink_bytes", "peak_memory_bytes", "wall_s", "compute_s", "memory_s",
          "collective_s", "dominant", "link_bits", "wire_bits_by_hop", "machines", "mesh")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both meshes, both variants, at d = 32, n = 64, 20 iterations: ``{(mesh, variant): json}``."""
    out = tmp_path_factory.mktemp("dryrun")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for variant in ("fused", "baseline"):
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun_slda", "--cpu", "--d", str(D),
             "--n", "64", "--iters", "20", "--mesh", "both", "--variant", variant,
             "--out", str(out)], capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
        assert proc.returncode == 0, proc.stdout + proc.stderr
    return {(mesh, variant): json.loads(
        (out / f"slda-core_d{D}_{mesh}_{variant}.json").read_text())
        for mesh in ("16x16", "2x16x16") for variant in ("fused", "baseline")}


@pytest.mark.parametrize("variant", ["fused", "baseline"])
@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
def test_dry_run_writes_the_reference_fields(runs, mesh, variant):
    r = runs[(mesh, variant)]
    assert all(key in r for key in FIELDS)
    assert r["mesh"] == mesh and r["variant"] == variant and r["device"] == "cpu"
    assert r["machines"] == (32 if mesh == "2x16x16" else 16)
    assert r["flops_per_device"] > 0 and r["bytes_per_device"] > 0 and r["eigh"] == 1
    assert r["paper_uplink_bytes"] == 4 * D
    # the card's time and memory are not measured on the CPU
    assert r["wall_s"] is None and r["peak_memory_bytes"] is None


@pytest.mark.parametrize("variant", ["fused", "baseline"])
@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
def test_uplink_bits_are_the_references_accounting(runs, mesh, variant):
    r = runs[(mesh, variant)]
    data = [c for c in r["collectives"] if c["role"] == "data"]
    assert len(data) == 1 and data[0]["op"] == "psum" and data[0]["dtype"] == "float32"
    assert data[0]["bits"] == 32 * D == _comm_params(CommPlan(), 1, D, 1)["data_psum_bits"]
    assert data[0]["axes"] == (["pod", "data"] if mesh == "2x16x16" else ["data"])
    model = [c for c in r["collectives"] if c["role"] == "model"]
    assert [(c["op"], c["shape"]) for c in model] == [("all_gather", [-(-D // 16), 1])]
    assert r["link_bits"] == {"data": 32 * D, "model": 32 * -(-D // 16)}
    assert r["collective_bytes_per_device"] == (32 * D + 32 * -(-D // 16)) // 8
    # the per-hop tally counts the (pod, data) psum once a hop
    hops = 2 if mesh == "2x16x16" else 1
    assert r["wire_bits_by_hop"] == {"data": hops * 32 * D, "model": 32 * -(-D // 16)}


def test_fused_variant_calls_k2_twice_and_baseline_none(runs):
    fused = runs[("16x16", "fused")]["calls"]
    assert fused == {str(("dantzig_fused", 1, D, 1)): 1, str(("dantzig_fused", 1, D, 2)): 1}
    assert runs[("16x16", "baseline")]["calls"] == {}


def test_kernel_work_counts_k1_and_k2():
    flops, nbytes = dryrun_slda.kernel_work({("gram", 1, 8, 4): 2,
                                             ("dantzig_fused", 1, 4, 1): 1}, iters=10)
    assert flops == 2 * (8 * 4 * 5 + 8 * 4) + 10 * (8 * 16 + 20 * 4)
    assert nbytes == 2 * 4 * (32 + 4 + 16) + 4 * (32 + 4 + 8 + 2)
    with pytest.raises(ValueError, match="not on the dry run's path"):
        dryrun_slda.kernel_work({("dantzig_fused_state", 1, 4, 1): 1}, iters=10)
