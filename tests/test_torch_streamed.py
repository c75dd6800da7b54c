"""K2 and K3 on the streamed template: the shapes that take it, and the span that marks each such
launch in a profiled trace (``repro_torch.admm.streamed``), with the CUDA launchers stubbed so that
the launch path runs on CPU tensors."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import test_torch_parity  # noqa: F401  (pins torch to one thread)
from repro_torch.kernels import _launch
from repro_torch.kernels import dantzig_fused as fused


def test_the_d1000_fit_takes_the_streamed_template_and_d200_a_cluster():
    # d = 1,000: an 8-column tile, and no cluster size fits it, for K2 and K3 alike
    assert fused.max_block_k(1000) == fused.max_block_k(1000, state_io=True) == 8
    assert fused.pick_cluster_size(1000, 8) == fused.pick_cluster_size(1000, 8, True) == 0
    assert fused.pick_cluster_size(1000, 1) == 0
    assert fused.pick_block_k(1000, 1000) == 8 and fused.pick_block_k(1000, 1) == 1
    # d = 200, the benchmarked fit's width: 40-column tiles on a cluster
    assert fused.pick_block_k(200, 200) == 40
    assert fused.pick_cluster_size(200, 40) in fused.CLUSTER_SIZES
    assert fused.pick_cluster_size(200, 1) in fused.CLUSTER_SIZES


@pytest.fixture
def launches(monkeypatch):
    """The C launchers replaced by recorders of (kernel, cluster size, A^T given), and the
    operands allowed on the CPU."""
    seen = []

    def stub(kernel):
        def launch(*args):
            # both launchers take a, q, at, qt first; the cluster size is argument 14 (K2) or 22 (K3)
            cs = args[9 + 5] if kernel == "K2" else args[17 + 5]
            seen.append((kernel, cs, args[2] is not None))
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
                                          (200, 1, False), (200, 40, False)])
def test_a_streamed_launch_is_marked_once_and_a_cluster_launch_never(launches, kernel, d, k,
                                                                     streamed):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            _call(kernel, d, k)
    spans = _streamed_spans(prof)
    assert [(name, cs == 0, given) for name, cs, given in launches] == [
        (kernel, streamed, streamed)] * 3
    assert len(spans) == (3 if streamed else 0)
    # the span holds the transposes the streamed template reads (A^T, Q^T: two copies)
    assert all(inside.count("aten::contiguous") == 2 for inside in spans), spans


def test_with_no_profiler_a_streamed_launch_records_nothing(launches, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) built with no profiler")

    monkeypatch.setattr(fused.obs, "record_function", refuse)
    _call("K2", 1000, 8)
    _call("K3", 1000, 8)
    assert [cs for _, cs, _ in launches] == [0, 0]
