"""K2 and K3 on the streamed template: the shapes that take it, and the span that marks each such
launch in a profiled trace (``repro_torch.admm.streamed``), with the CUDA launchers stubbed so that
the launch path runs on CPU tensors."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import test_torch_parity  # noqa: F401  (pins torch to one thread)
from repro_torch.kernels import _launch, ops
from repro_torch.kernels import dantzig_fused as fused
from repro_torch.kernels.spectral import SpectralFactor


def test_the_d1000_fit_takes_the_streamed_template_and_d200_a_cluster():
    # d = 1,000: no cluster size fits, for K2 and K3 alike; K2 is sized by the streamed
    # template's own footprint (two product buffers: 24 columns), K3 keeps its 8
    plan = fused.plan_launch
    assert plan(1000, 48, block_k=48).block_k == 24
    assert plan(1000, 48, block_k=48, state_io=True).block_k == 8
    assert plan(1000, 1000) == (24, 24, 0, fused.streamed_smem_bytes(1000, 24))
    assert plan(1000, 1000, state_io=True) == (8, 8, 0, fused.streamed_smem_bytes(1000, 8, True))
    assert plan(1000, 1)[:3] == (1, 1, 0)
    # d = 200, the benchmarked fit's width: 40-column tiles on a cluster
    assert plan(200, 200)[:2] == (40, 40)
    assert plan(200, 200).cluster in fused.CLUSTER_SIZES
    assert plan(200, 1).cluster in fused.CLUSTER_SIZES


@pytest.fixture
def launches(monkeypatch):
    """The C launchers replaced by recorders of (kernel, cluster size, A^T given, state scratch
    given, columns per block, tile), and the operands allowed on the CPU."""
    seen = []

    def stub(kernel):
        def launch(*args):
            # both launchers take a, q, at, qt first and the scratch last of the pointers,
            # then m, d, k, bk, width, cluster
            n = 10 if kernel == "K2" else 18
            bk, width, cs = args[n + 3:n + 6]
            seen.append((kernel, cs, args[2] is not None, args[n - 1] is not None, bk, width))
            return 0
        return launch

    def check(a, q, inv_eig, b, lam, rho):
        return (*b.shape, b.device)

    monkeypatch.setattr(fused, "_K2", stub("K2"))
    monkeypatch.setattr(fused, "_K3", stub("K3"))
    monkeypatch.setattr(fused, "_check_operands", check)
    monkeypatch.setattr(_launch, "stream", lambda device: 0)
    return seen


def _operands(d: int, k: int, m: int = 2):
    a = torch.eye(d).expand(m, d, d).contiguous()
    return (a, a.clone(), torch.ones(m, d), torch.ones(m, d, k), torch.full((m, k), 0.1),
            torch.ones(m, k))


def _call(kernel: str, d: int, k: int):
    if kernel == "K2":
        return fused.dantzig_fused_cuda(*_operands(d, k), iters=5, alpha=1.7)
    return fused.dantzig_fused_state_cuda(*_operands(d, k), iters=5, alpha=1.7, tol=1e-2)


def _streamed_spans(prof) -> list:
    """Each ``repro_torch.admm.streamed`` span, as the names of the operations inside it."""
    events = prof.events()
    spans = [e for e in events if e.name == fused.STREAMED_SPAN]
    return [[e.name for e in events if e is not s and e.cpu_parent is s] for s in spans]


@pytest.mark.parametrize("kernel", ["K2", "K3"])
@pytest.mark.parametrize("d,k,streamed", [(1000, 1, True), (1000, 8, True), (1000, 20, True),
                                          (1000, 1000, True), (200, 1, False), (200, 40, False)])
def test_a_streamed_launch_is_marked_once_and_a_cluster_launch_never(launches, kernel, d, k,
                                                                     streamed):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            _call(kernel, d, k)
    spans = _streamed_spans(prof)
    plan = fused.plan_launch(d, k, state_io=kernel == "K3")
    assert [(name, cs == 0, at, scratch) for name, cs, at, scratch, _, _ in launches] == [
        (kernel, streamed, streamed, streamed)] * 3
    assert {(b, w) for *_, b, w in launches} == {(plan.block_k, plan.width)}
    assert len(spans) == (3 if streamed else 0)
    # the span holds the transposes the streamed template reads (A^T, Q^T: two copies)
    assert all(inside.count("aten::contiguous") == 2 for inside in spans), spans


def test_with_no_profiler_a_streamed_launch_records_nothing(launches, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) built with no profiler")

    monkeypatch.setattr(fused.obs, "record_function", refuse)
    _call("K2", 1000, 8)
    _call("K3", 1000, 8)
    assert [cs for _, cs, *_ in launches] == [0, 0]


# (columns per block, tile, cluster size) of each (d, k) that the cells, the mesh and the smoke
# run on the cluster template, K2 and K3 alike: the 28·d·W-byte blocking rule, which every shape
# the cluster template takes keeps
CLUSTER_BLOCKING = {
    **{(d, 1): (1, 1, 2 if d < 200 else 4) for d in (120, 128, 200, 256)},
    **{(d, 5): (5, 8, 4 if d < 200 else 8) for d in (120, 128, 200, 256)},
    **{(d, 16): (16, 16, 8 if d < 200 else 16) for d in (120, 128, 200, 256)},
    **{(d, k): (40, 40, 4) for d in (120, 128, 200) for k in (40, 120, 200)},
    (256, 40): (20, 24, 8), (256, 120): (30, 32, 8), (256, 200): (29, 32, 8),
}


@pytest.mark.parametrize("state_io", [False, True], ids=["K2", "K3"])
@pytest.mark.parametrize("d,k", sorted(CLUSTER_BLOCKING))
def test_every_cluster_shape_keeps_its_blocking(d, k, state_io):
    assert fused.plan_launch(d, k, state_io=state_io)[:3] == CLUSTER_BLOCKING[d, k]


@pytest.mark.parametrize("k,state_io,bk", [(1000, False, 24), (1, False, 1), (1000, True, 8),
                                           (1, True, 1)],
                         ids=["K2 CLIME", "K2 direction", "K3 CLIME", "K3 direction"])
def test_a_d1000_call_records_the_model_blocks(k, state_io, bk):
    # the call counts record each K2/K3 call's blocks: at d = 1,000 K2's CLIME block takes
    # the wide tile, K3 keeps its 8 columns
    d = 1000
    factor = SpectralFactor(torch.eye(d), torch.eye(d), torch.ones(d))
    ops.reset_launches()
    ops.dantzig_fused(factor, torch.zeros(d, k), 0.1, iters=0, return_info=state_io)
    name = "dantzig_fused_state" if state_io else "dantzig_fused"
    assert ops.CALL_BLOCKS == {(name, d, k, bk): 1}
    plan = fused.plan_launch(d, k, state_io=state_io)
    assert plan.block_k == bk and plan.streamed
    # the streamed block the launch takes: two product buffers at K2's 24 columns
    assert plan.smem_bytes == fused.streamed_smem_bytes(d, plan.width, state_io)
    assert plan.smem_bytes <= fused.SMEM_BYTES
    if not state_io and k > 1:
        assert fused.streamed_smem_bytes(d, 32) > fused.SMEM_BYTES


# (bk, width, cluster) the wrapper hands the C launcher at each cell's shapes: the d = 200 fit's
# direction and CLIME block, the d = 1,000 fit's (streamed), and the serving refit's K3
@pytest.mark.parametrize("kernel,d,k,block_k,handed", [
    ("K2", 200, 1, None, (1, 1, 4)),
    ("K2", 200, 200, None, (40, 40, 4)),
    ("K2", 1000, 1, None, (1, 1, 0)),
    ("K2", 1000, 1000, None, (24, 24, 0)),
    ("K3", 120, 120, 40, (40, 40, 4)),
    ("K3", 120, 1, None, (1, 1, 2)),
], ids=["d200 direction", "d200 CLIME", "d1000 direction", "d1000 CLIME", "serving CLIME",
        "serving direction"])
def test_the_wrapper_hands_c_the_planned_launch(launches, monkeypatch, kernel, d, k, block_k,
                                                handed):
    monkeypatch.setattr(ops, "_on_card", lambda t: True)
    factor = SpectralFactor(torch.eye(d), torch.eye(d), torch.ones(d))
    ops.reset_launches()
    try:
        ops.dantzig_fused(factor, torch.zeros(d, k), 0.1, iters=5, block_k=block_k,
                          tol=1e-3 if kernel == "K3" else None)
        name = "dantzig_fused_state" if kernel == "K3" else "dantzig_fused"
        assert ops.CALL_BLOCKS == {(name, d, k, handed[0]): 1}
        assert ops.LAUNCH_SHAPES == {(name, 1, d, k): 1}
    finally:
        ops.reset_launches()
    streamed = handed[2] == 0
    assert launches == [(kernel, handed[2], streamed, streamed, *handed[:2])]
