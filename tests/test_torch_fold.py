"""The direction solve riding in the CLIME launch: where the launch plan has room for its columns
(``dantzig_fused.rides_in_tail``), the narrow K2 mode of ``pipeline.solves_from_stats`` makes one
solve of the joined batch, and its answer is the two separate solves'."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import test_torch_parity  # noqa: F401  (pins torch to one thread)
from repro_torch.core import pipeline
from repro_torch.core.clime import solve_clime_columns
from repro_torch.core.dantzig import DantzigConfig
from repro_torch.core.solver_dispatch import solve_dantzig
from repro_torch.kernels import ops
from repro_torch.kernels.dantzig_fused import plan_launch, rides_in_tail

FUSED = DantzigConfig(max_iters=10, fused=True)


@pytest.mark.parametrize("d,k,extra,state_io,rides", [
    (1000, 1000, 1, False, True),   # the d = 1,000 fit: 42 blocks of 24, 8 lanes spare
    (1000, 1000, 8, False, True),   # every spare lane
    (545, 545, 1, False, True),     # the first d on the streamed template: 12 blocks of 46
    (1000, 1000, 9, False, False),  # a 43rd block
    (200, 200, 1, False, False),    # 5 blocks of 40 become 6 of 34
    (12, 12, 1, False, False),      # one block: 12 columns become 13
    (10, 10, 3, False, False),
    (768, 768, 1, False, False),    # 24 full blocks of 32
    (1000, 1000, 1, True, False),   # K3 never
    (1000, 999, 1, True, False),    # not even where its blocks would not change
])
def test_rides_in_tail(d, k, extra, state_io, rides):
    assert rides_in_tail(d, k, extra, state_io) is rides


def _stats(d: int, m: int = 2, n: int = 60, seed: int = 0) -> pipeline.HeadStats:
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(m, n, d, generator=gen)
    y = torch.randn(m, n, d, generator=gen) + 0.3
    return pipeline.BinaryHead().stats(x, y)


def _solve(hs, cfg, **kw):
    ops.reset_launches()
    return pipeline.solves_from_stats(hs, lam=0.1, lam_prime=0.05, cfg=cfg, **kw)


def test_the_joined_solve_is_the_two_solves(monkeypatch):
    d = 545
    hs = _stats(d)
    monkeypatch.setattr(pipeline, "FOLDS", 0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ws = _solve(hs, FUSED)
    assert pipeline.FOLDS == 1
    bk = plan_launch(d, d).block_k
    assert dict(ops.CALL_BLOCKS) == {("dantzig_fused", d, d + 1, bk): 1}
    names = [e.name for e in prof.events()]
    assert names.count(pipeline.FOLDED_SPAN) == 1
    assert "repro_torch.solve.direction" not in names and "repro_torch.solve.clime" not in names

    beta = solve_dantzig(ws.factor, hs.rhs, 0.1, FUSED)
    theta = solve_clime_columns(ws.factor, torch.arange(d), 0.05, FUSED)
    assert ws.beta_hat.shape == beta.shape and ws.theta.shape == theta.shape
    assert ws.beta_hat.is_contiguous() and ws.theta.is_contiguous()
    for got, want in ((ws.beta_hat, beta), (ws.theta, theta)):
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("d,full", [(200, False), (545, True)])
def test_two_solves_where_the_direction_does_not_ride(monkeypatch, d, full):
    # d = 200: the plan changes with one more column; full=True: K3, with its warm carries
    hs = _stats(d)
    monkeypatch.setattr(pipeline, "FOLDS", 0)
    ws = _solve(hs, FUSED, full=full)
    assert pipeline.FOLDS == 0
    name = "dantzig_fused_state" if full else "dantzig_fused"
    plan = plan_launch(d, d, state_io=full)
    assert dict(ops.CALL_BLOCKS) == {(name, d, 1, 1): 1, (name, d, d, plan.block_k): 1}
    assert (ws.state_beta is not None) is full
