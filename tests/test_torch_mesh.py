"""The port's mesh faces on spawned CPU ranks (gloo) against its simulated faces and the reference.

Each mesh shape is spawned once (cached per module): one spawn runs
every case of that shape in one process group
(:func:`repro_torch.launch.mesh_cases.run_cases`) and the tests read
its reports.  The inputs are numpy draws, shared by the mesh, the
port's simulated faces and, at (2, 4), the JAX package's simulated
faces.  A mesh result is held against the simulated face on the same
split at 1e-5 of its largest entry: the mesh sums over ranks in
another order than a machine mean, and a one-machine solve rounds
apart from a batched one (a (d, d) x (d, 1) product takes another
BLAS kernel alone than in a batch).
"""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import faults as jax_faults
from repro.core import multiclass as jax_mc
from repro.core.dantzig import DantzigConfig as JaxDantzigConfig
from repro.core.distributed import simulated_distributed_slda as jax_distributed
from repro.stats import synthetic as jax_synthetic
from repro_torch import interop
from repro_torch.core import distributed, multiclass, pipeline, rounds
from repro_torch.core.compression import Compression, dense_uplink_bits, uplink_bits
from repro_torch.core.faults import Aggregation, FaultPlan, FaultSchedule
from repro_torch.core.pipeline import BinaryHead
from repro_torch.core.transport import CommPlan
from repro_torch.kernels import build
from repro_torch.launch import mesh as mesh_launch
from repro_torch.launch.mesh_cases import MeshCase, run_cases
from test_torch_parity import assert_parity

T, K = 3, 3

# name: (data, model, d, samples a class a machine, reference DantzigConfig fields)
SHAPES = {
    "1x1": (1, 1, 16, 40, dict(max_iters=150)),
    # the remainder case of tests/test_distributed.py (70 % 4 != 0)
    "2x4": (2, 4, 70, 60, dict(max_iters=200)),
    # the fused remainder case of tests/test_distributed.py (3 columns a rank, 1 pad)
    "1x4": (1, 4, 11, 50, dict(max_iters=250, adapt_rho=False, fused=True)),
}


def _t(a, dtype=torch.float32):
    return interop.tensor(a, device="cpu", dtype=dtype)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class Setup:
    """One shape's shared draws, tuning, configs and materialized fault plans."""

    def __init__(self, name):
        data, model, d, n, cfg = SHAPES[name]
        self.data, self.model, self.d, self.n = data, model, d, n
        self.m = m = data  # one machine a data rank
        rng = np.random.default_rng(sum(map(ord, name)))
        p = jax_synthetic.make_problem(d=d, n_signal=min(5, d // 2), rho=0.6)
        chol, mu1, mu2 = (np.asarray(v) for v in (p.chol, p.mu1, p.mu2))
        self.xs = (mu1 + rng.standard_normal((m, n, d)) @ chol.T).astype(np.float32)
        self.ys = (mu2 + rng.standard_normal((m, n, d)) @ chol.T).astype(np.float32)
        q = jax_synthetic.make_mc_problem(d=d, num_classes=K, n_signal=3, rho=0.6)
        nk = 3 * n
        self.labels = rng.integers(0, K, (m, nk)).astype(np.int32)
        self.xk = (np.asarray(q.means)[self.labels]
                   + rng.standard_normal((m, nk, d)) @ np.asarray(q.chol).T).astype(np.float32)
        self.lam = 0.3 * math.sqrt(math.log(d) / (2 * n)) * 4
        self.t = 0.25 * self.lam
        self.lam_k = 0.3 * math.sqrt(math.log(d) / nk) * 4
        self.jcfg = JaxDantzigConfig(**cfg)
        self.cfg = interop.dantzig_config_from_dict(self.jcfg._asdict())
        # the gate groups of the tol-gated re-entry: one column a block, so a
        # model rank's column share gates as the simulation's columns do
        self.gated = self.cfg._replace(fused=True, adapt_rho=False, tol=1e-3, block_k=1)
        self.comp = Compression(min(16, d), "int8")
        self.down = Compression(min(8, d), "int8")
        garbage = jax_faults.FaultSchedule(dropout=0.3, corrupt=0.4, corrupt_mode="garbage",
                                           seed=7)
        self.garbage_plan = self._plan(garbage)
        self.stale_plan = self._plan(jax_faults.FaultSchedule(straggle=0.6, seed=8))
        self.schedule = FaultSchedule(dropout=0.3, straggle=0.3, corrupt=0.2,
                                      corrupt_mode="mix", seed=11)

    def _plan(self, schedule):
        """The reference's materialized (m, T) plan, as the port's."""
        return interop.fault_plan_from_numpy(*(np.asarray(v) for v in schedule.plan(self.m, T, 1)),
                                             device="cpu")

    def arrays(self):
        d = self.d
        return dict(x=_t(self.xs.reshape(-1, d)), y=_t(self.ys.reshape(-1, d)),
                    xk=_t(self.xk.reshape(-1, d)),
                    labels=_t(self.labels.reshape(-1), torch.int64))

    def cases(self):
        b = dict(lam=self.lam, lam_prime=self.lam, t=self.t, cfg=self.cfg)
        bad_plan = FaultPlan(*(torch.cat([leaf, leaf[:1]]) for leaf in self.garbage_plan))
        cases = [
            MeshCase("binary", "binary", b),
            MeshCase("multiclass", "multiclass",
                     dict(num_classes=K, lam=self.lam_k, lam_prime=self.lam_k, t=self.t,
                          cfg=self.cfg)),
            MeshCase("naive", "naive", dict(lam=self.lam, cfg=self.cfg)),
            MeshCase("rounds", "binary", dict(b, rounds=T)),
            MeshCase("int8", "binary", dict(b, rounds=T, compression=self.comp)),
            MeshCase("garbage", "binary",
                     dict(b, rounds=T, faults=self.garbage_plan,
                          aggregation=Aggregation(envelope=1e6))),
            MeshCase("downlink", "binary", dict(b, rounds=T, comm=CommPlan(downlink=self.down))),
            MeshCase("stale", "binary",
                     dict(b, rounds=T, faults=self.stale_plan, staleness=1,
                          aggregation=Aggregation())),
            MeshCase("reentry", "reentry",
                     dict(lam=self.lam, lam_prime=self.lam, cfg=self.gated)),
            MeshCase("resume", "resume",
                     dict(lam=self.lam, lam_prime=self.lam, cfg=self.cfg, rounds=T, split=1,
                          comm=CommPlan(uplink=self.comp, downlink=self.down))),
            MeshCase("plan", "plan", dict(schedule=self.schedule, rounds=T)),
            MeshCase("raise_plan", "raises", dict(b, call="binary", rounds=T, faults=bad_plan)),
            MeshCase("raise_comm", "raises",
                     dict(b, call="binary", comm=CommPlan(), faults=FaultSchedule())),
        ]
        if self.m > 1:
            cases.append(MeshCase("raise_rows", "raises",
                                  dict(b, call="binary", rows=self.m * self.n - 1)))
        return cases

    def sim(self, name):
        """The port's simulated face of case ``name`` on the same split."""
        xs, ys, cfg = _t(self.xs), _t(self.ys), self.cfg
        b = (xs, ys, self.lam, self.lam, self.t, cfg)
        if name == "binary":
            return distributed.simulated_distributed_slda(*b)
        if name == "multiclass":
            return multiclass.simulated_distributed_mc_slda(
                _t(self.xk), _t(self.labels, torch.int64), K, self.lam_k, self.lam_k, self.t, cfg)
        if name == "naive":
            return distributed.simulated_naive_averaged_slda(xs, ys, self.lam, cfg)
        if name == "rounds":
            return distributed.simulated_distributed_slda(*b, rounds=T)
        if name == "int8":
            return distributed.simulated_distributed_slda(*b, rounds=T, compression=self.comp)
        if name == "garbage":
            return distributed.simulated_distributed_slda(
                *b, rounds=T, faults=self.garbage_plan, aggregation=Aggregation(envelope=1e6))
        if name == "downlink":
            return distributed.simulated_distributed_slda(*b, rounds=T,
                                                          comm=CommPlan(downlink=self.down))
        if name == "stale":
            return distributed.simulated_distributed_slda(
                *b, rounds=T, faults=self.stale_plan, staleness=1, aggregation=Aggregation())
        raise KeyError(name)


@functools.cache
def _spawned(name):
    """One spawn of shape ``name``'s mesh, running every case: ``(setup, reports)``."""
    setup = Setup(name)
    reports = mesh_launch.run_on_mesh(run_cases, setup.data, setup.model, setup.arrays(),
                                      setup.cases(), device="cpu", backend="gloo", timeout=300)
    return setup, reports


@pytest.fixture(params=list(SHAPES))
def shape(request):
    return _spawned(request.param)


def _hold(got, want):
    """``got`` within 1e-5 of the largest entry of ``want`` (the mesh-vs-simulation pin)."""
    assert_parity(got, _np(want))


@pytest.mark.parametrize("name", ["binary", "naive", "rounds", "int8", "garbage", "downlink",
                                  "stale"])
def test_mesh_face_matches_the_simulated_face(shape, name):
    setup, reports = shape
    report = reports[name]
    assert all(report["same_as_rank0"])  # replicated on every rank
    _hold(report["out"], setup.sim(name))


def test_mesh_multiclass_matches_the_simulated_face(shape):
    setup, reports = shape
    beta, means = reports["multiclass"]["out"]
    want_beta, want_means = setup.sim("multiclass")
    assert beta.shape == (setup.d, K) and means.shape == (K, setup.d)
    _hold(beta, want_beta)
    _hold(means, want_means)


def test_mesh_wire_carries_the_counted_bits(shape):
    # a compressed round's data-axis gathers carry exactly the port's
    # uplink_bits a machine; a dense round's sum exactly the (d, 1) f32 block
    setup, reports = shape
    d = setup.d
    assert reports["int8"]["data_bits"] == [T * uplink_bits(setup.comp, d, 1)] * setup.m * \
        setup.model
    assert reports["rounds"]["data_bits"] == [T * dense_uplink_bits(d, 1)] * setup.m * setup.model
    # the model-axis gather moves one (ceil(d / |model|), 1) f32 slice a round
    cols_per = -(-d // setup.model)
    assert reports["rounds"]["model_bits"] == [T * cols_per * 32] * setup.m * setup.model


def test_mesh_reentry_is_warm_and_matches_the_simulation(shape):
    setup, reports = shape
    cold, warm, iters_cold, iters_warm = reports["reentry"]["out"]
    assert iters_warm < iters_cold
    head = BinaryHead()
    data = (_t(setup.xs), _t(setup.ys))
    kw = dict(lam=setup.lam, lam_prime=setup.lam, cfg=setup.gated, collect_info=True)
    want_cold, ws = rounds.simulate_multi_round(head, data, **kw)
    want_warm, ws_warm = rounds.simulate_multi_round(
        head, data, rho_beta=ws.rho_beta, rho_theta=ws.rho_theta, state_beta=ws.state_beta,
        state_theta=ws.state_theta, **kw)
    _hold(cold, want_cold)
    _hold(warm, want_warm)
    if setup.model == 1:
        # rank r is machine r: the executed column-iterations are the
        # simulation's, each column's block within one residual check
        slack = setup.gated.check_every * setup.m * (1 + setup.d)
        for got, w in ((iters_cold, ws), (iters_warm, ws_warm)):
            assert abs(got - int(w.iters_beta.sum()) - int(w.iters_theta.sum())) <= slack


def test_mesh_stream_resumes_exactly(shape):
    # a compressed T = 3 stream (int8 uplink and downlink) cut after one
    # round and resumed from the received aggregate and both wires'
    # residuals is the uninterrupted stream, bit for bit
    whole, resumed = shape[1]["resume"]["out"]
    assert torch.equal(whole, resumed)


def test_every_rank_materializes_the_same_fault_plan(shape):
    setup, reports = shape
    report = reports["plan"]
    assert all(report["same_as_rank0"])
    want = setup.schedule.plan(setup.m, T, 1, device="cpu")
    for got, leaf in zip(report["out"], want):
        torch.testing.assert_close(got, leaf, rtol=0, atol=0)


def test_mesh_faces_refuse_bad_arguments_before_solving(shape):
    setup, reports = shape
    assert reports["raise_plan"]["out"] == "ValueError"
    assert reports["raise_comm"]["out"] == "TypeError"
    if setup.m > 1:
        assert reports["raise_rows"]["out"] == "ValueError"
    for name in ("raise_plan", "raise_comm"):  # refused before any solve
        assert all(sum(n.values()) == 0 for n in reports[name]["launches"])
    with pytest.raises(ValueError, match="symmetrize"):
        pipeline.worker_solves(BinaryHead(), _t(setup.xs[0]), _t(setup.ys[0]), lam=setup.lam,
                               lam_prime=setup.lam, model_axis="model", symmetrize=True)


def test_one_shot_mesh_faces_match_the_reference_at_2x4():
    setup, reports = _spawned("2x4")
    xs, ys = jnp.asarray(setup.xs), jnp.asarray(setup.ys)
    want = jax_distributed(xs, ys, setup.lam, setup.lam, setup.t, setup.jcfg)
    assert_parity(reports["binary"]["out"], np.asarray(want))
    want_b, want_m = jax_mc.simulated_distributed_mc_slda(
        jnp.asarray(setup.xk), jnp.asarray(setup.labels), K, setup.lam_k, setup.lam_k, setup.t,
        setup.jcfg)
    beta, means = reports["multiclass"]["out"]
    assert_parity(beta, np.asarray(want_b))
    assert_parity(means, np.asarray(want_m))


def test_model_columns_pad_and_mask_like_the_reference():
    assert pipeline.model_columns(70, 3, 4)[0].tolist()[-2:] == [69, 69]
    cols, valid = pipeline.model_columns(11, 3, 4)
    assert cols.tolist() == [9, 10, 10] and valid.tolist() == [True, True, False]


def test_run_on_mesh_defaults_to_the_card_and_checks_its_backend(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mesh_launch.run_on_mesh(run_cases, 1, 1, {}, [], backend="gloo")
    with pytest.raises(ValueError, match="backend"):
        mesh_launch.run_on_mesh(run_cases, 1, 1, {}, [], device="cpu", backend="mpi")
    with pytest.raises(ValueError, match="nccl"):
        mesh_launch.run_on_mesh(run_cases, 1, 1, {}, [], device="cpu", backend="nccl")


def _load_gram(mesh):
    """A rank's first use of a kernel library that is not built: it must load, not build."""
    try:
        build.library("gram")
    except RuntimeError as exc:
        return str(exc)
    return "loaded"


def test_ranks_load_kernels_and_never_build(monkeypatch, tmp_path):
    # in this process a missing library would be built (nvcc); in a rank
    # it is an error that names the parent's build, and nvcc never runs
    built = build.library_path("gram").exists()
    out = mesh_launch.run_on_mesh(_load_gram, 1, 1, device="cpu", backend="gloo", timeout=120)
    assert out == "loaded" if built else "only loads" in out
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build, "_LOAD_ONLY", True)
    monkeypatch.setattr(build, "nvcc", lambda: pytest.fail("a rank called nvcc"))
    with pytest.raises(RuntimeError, match="only loads"):
        build.library("gram")


def test_a_failing_rank_fails_the_call():
    with pytest.raises(RuntimeError, match="mesh rank"):
        mesh_launch.run_on_mesh(run_cases, 2, 1, {}, [MeshCase("bad", "no-such-face", {})],
                                device="cpu", backend="gloo", timeout=120)
