"""The port's refinement rounds, codecs, faults and transport against the JAX reference.

Inputs are made once with numpy from a seed and handed to both
packages.  The round loop is held against the reference on the same
machine solves (the reference's, carried across) and the same
materialized fault plan (the reference's ``FaultSchedule.plan``, or a
plan written out by hand); the whole rounds pipeline is held against
the reference on shared draws.  Wire indices, int8 codes and every bit
total equal the reference's exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as jax_comp
from repro.core import faults as jax_faults
from repro.core import rounds as jax_rounds
from repro.core import transport as jax_transport
from repro.core.dantzig import DantzigConfig as JaxDantzigConfig
from repro.core.distributed import simulated_debiased_mean as jax_debiased_mean
from repro.core.pipeline import BinaryHead as JaxBinaryHead
from repro.stats import synthetic as jax_synthetic
from repro_torch import interop
from repro_torch.core import compression, faults, pipeline, rounds, transport
from repro_torch.core.compression import Compression
from repro_torch.core.distributed import simulated_debiased_mean
from repro_torch.core.faults import Aggregation, FaultPlan, FaultSchedule
from repro_torch.core.transport import BitBudget, CommPlan
from test_torch_parity import UlpHead, assert_parity, perturb_ulp, reference_spread

D, M, N_PER, T = 24, 5, 80, 3
LAM = 0.25


def _t(a, dtype=torch.float32):
    return interop.tensor(a, device="cpu", dtype=dtype)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _cfgs(**kw):
    jcfg = JaxDantzigConfig(**kw)
    return jcfg, interop.dantzig_config_from_dict(jcfg._asdict())


def _draws(seed=0):
    """Shared numpy draws of the §5.1 design at d = 24, AR(0.5), m = 5 machines."""
    problem = jax_synthetic.make_problem(d=D, n_signal=4, rho=0.5)
    fields = {k: np.asarray(v) for k, v in problem._asdict().items()}
    rng = np.random.default_rng(seed)
    chol = fields["chol"]
    xs = (fields["mu1"] + rng.standard_normal((M, N_PER // 2, D)) @ chol.T).astype(np.float32)
    ys = (fields["mu2"] + rng.standard_normal((M, N_PER // 2, D)) @ chol.T).astype(np.float32)
    return xs, ys


def _reference_solves(seed=0, **cfg):
    xs, ys = _draws(seed)
    jcfg, _ = _cfgs(max_iters=150, adapt_rho=False, **cfg)
    _, jws = jax_rounds.simulate_multi_round(JaxBinaryHead(), (jnp.asarray(xs), jnp.asarray(ys)),
                                             lam=LAM, lam_prime=LAM, rounds=1, cfg=jcfg)
    return jws


def _port_solves(jws) -> pipeline.WorkerSolves:
    """The reference's machine solves as the port's: the round loop sees the same inputs."""
    hs = pipeline.HeadStats(_t(jws.stats.sigma), _t(jws.stats.rhs), None)
    return pipeline.WorkerSolves(stats=hs, beta_hat=_t(jws.beta_hat), theta=_t(jws.theta),
                                 valid=None, rho_beta=None, rho_theta=None, state_beta=None,
                                 state_theta=None, iters_beta=None, iters_theta=None)


def _plan(schedule=None, rounds=T, bound=1, corrupt_at=None):
    """The reference's materialized plan (all live without a schedule) as numpy arrays;
    ``corrupt_at`` = (machine, round, code) writes one corruption in by hand."""
    if schedule is None:
        live = np.ones((M, rounds), np.float32)
        stale = corrupt = np.zeros((M, rounds), np.int32)
    else:
        live, stale, corrupt = (np.asarray(v) for v in schedule.plan(M, rounds, bound))
    corrupt = corrupt.copy()
    if corrupt_at is not None:
        machine, rnd, code = corrupt_at
        corrupt[machine, rnd] = code
    return live, stale, corrupt


# name: (reference CommPlan fields, schedule of the plan or None, staleness bound, corrupt_at)
SCENARIOS = {
    "dense": ({}, None, 0, None),
    "identity codec": ({"uplink": jax_comp.Compression(D)}, None, 0, None),
    "top-k int8": ({"uplink": jax_comp.Compression(D // 5, "int8")}, None, 0, None),
    "top-k bf16 + downlink": ({"uplink": jax_comp.Compression(6, "bf16"),
                               "downlink": jax_comp.Compression(8)}, None, 0, None),
    "dropout masked": ({"aggregation": jax_faults.Aggregation()},
                       jax_faults.FaultSchedule(dropout=0.3, seed=3), 0, None),
    "dropout unmasked": ({}, jax_faults.FaultSchedule(dropout=0.3, seed=3), 0, None),
    "int8 dropout masked": ({"uplink": jax_comp.Compression(D // 5, "int8"),
                             "aggregation": jax_faults.Aggregation()},
                            jax_faults.FaultSchedule(dropout=0.2, corrupt=0.3,
                                                     corrupt_mode="mix", seed=4), 0, None),
    "int8 dropout unmasked": ({"uplink": jax_comp.Compression(D // 5, "int8")},
                              jax_faults.FaultSchedule(dropout=0.3, seed=3), 0, None),
    "trimmed": ({"aggregation": jax_faults.Aggregation(trim=0.2)},
                jax_faults.FaultSchedule(corrupt=0.3, corrupt_mode="garbage", seed=5), 0, None),
    "staleness 2": ({"staleness": 2, "aggregation": jax_faults.Aggregation()},
                    jax_faults.FaultSchedule(straggle=0.6, seed=6), 2, None),
    "corrupted downlink": ({"downlink": jax_comp.Compression(8, "int8"),
                            "aggregation": jax_faults.Aggregation()},
                           None, 0, (0, 1, jax_faults.CORRUPT_NAN)),
    "bit budget": ({"schedule": jax_transport.BitBudget(total_bits=4000, mode="taper")},
                   None, 0, None),
}


@pytest.mark.parametrize("rounds_", [1, T], ids=["T=1", "T=3"])
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_round_loop_matches_reference(name, rounds_):
    # the same machine solves and the same materialized plan through both
    # round loops: every round's aggregate and both wires' residuals
    fields, schedule, bound, corrupt_at = SCENARIOS[name]
    if corrupt_at is not None and corrupt_at[1] >= rounds_:
        corrupt_at = (corrupt_at[0], rounds_ - 1, corrupt_at[2])
    jws = _reference_solves()
    jcomm = jax_transport.CommPlan(**fields)
    live, stale, corrupt = _plan(schedule, rounds_, max(bound, 1), corrupt_at)
    faulted = schedule is not None or corrupt_at is not None
    jplan = jax_faults.FaultPlan(*map(jnp.asarray, (live, stale, corrupt))) if faulted else None

    def reference(ws):
        return jax_rounds.simulate_round_loop(ws, rounds=rounds_, comm=jcomm, faults=jplan,
                                              return_all_rounds=True,
                                              return_transport_state=True)

    want, wstate = reference(jws)
    comm = interop.comm_plan_from_dict(jcomm._asdict())
    plan = interop.fault_plan_from_numpy(live, stale, corrupt, device="cpu") if faulted else None
    got, state = rounds.simulate_round_loop(_port_solves(jws), rounds=rounds_, comm=comm,
                                            faults=plan, return_all_rounds=True,
                                            return_transport_state=True)
    assert got.shape == (rounds_, D, 1)
    assert bool(torch.isfinite(got).all())
    # the pin: 1e-5 of the largest entry, or twice the reference's own
    # spread when the machines' Sigma_hat moves by one ulp (an int8 code at
    # a half or a top-k tie can move with it)
    sigma = np.asarray(jws.stats.sigma)
    spread = reference_spread(lambda s: reference(jws._replace(stats=jws.stats._replace(
        sigma=jnp.asarray(perturb_ulp(sigma, s)))))[0], want)
    assert_parity(got, want, spread)
    # the residuals are u - decode(u): held at 1e-5 of the messages' scale,
    # the aggregate's and the solves' largest entry
    scale = max(float(np.abs(np.asarray(want)).max()), float(np.abs(jws.beta_hat).max()))
    for g, w in zip(state, wstate):
        assert (g is None) == (w is None)
        if w is not None:
            assert_parity(g, w, scale=scale)


@pytest.mark.parametrize("name", ["dense", "dropout masked", "top-k bf16 + downlink"])
def test_multi_round_pipeline_matches_reference(name):
    # the whole pipeline on shared draws: the port's own solves (scan, fixed
    # rho) and three rounds; the pin is 1e-5 of the largest entry or twice
    # the reference's own spread when its Sigma_hat moves by one ulp
    fields, schedule, bound, _ = SCENARIOS[name]
    xs, ys = _draws(1)
    jcfg, cfg = _cfgs(max_iters=150, adapt_rho=False)
    jcomm = jax_transport.CommPlan(**fields)
    live, stale, corrupt = _plan(schedule, T, max(bound, 1))
    jplan = None if schedule is None else jax_faults.FaultPlan(*map(jnp.asarray,
                                                                   (live, stale, corrupt)))
    data = (jnp.asarray(xs), jnp.asarray(ys))

    def reference(head):
        return jax_rounds.simulate_multi_round(head, data, lam=LAM, lam_prime=LAM, rounds=T,
                                               cfg=jcfg, comm=jcomm, faults=jplan,
                                               return_all_rounds=True)[0]

    want = reference(JaxBinaryHead())
    plan = None if schedule is None else interop.fault_plan_from_numpy(live, stale, corrupt,
                                                                       device="cpu")
    got, ws = rounds.simulate_multi_round(
        pipeline.BinaryHead(), (_t(xs), _t(ys)), lam=LAM, lam_prime=LAM, rounds=T, cfg=cfg,
        comm=interop.comm_plan_from_dict(jcomm._asdict()), faults=plan, return_all_rounds=True)
    assert ws.beta_hat.shape == (M, D, 1) and ws.theta.shape == (M, D, D)
    assert_parity(got, want, reference_spread(lambda s: reference(UlpHead(JaxBinaryHead(), s)),
                                              want))


def test_one_round_is_the_one_shot_mean_bit_for_bit():
    xs, ys = _draws(2)
    _, cfg = _cfgs(max_iters=100, adapt_rho=False)
    beta_tilde, _, _ = pipeline.worker_debiased(pipeline.BinaryHead(), _t(xs), _t(ys), lam=LAM,
                                                lam_prime=LAM, cfg=cfg)
    one_shot = beta_tilde.mean(0)[:, 0]
    for kw in ({}, {"comm": CommPlan()}, {"rounds": 1}):
        got = simulated_debiased_mean(_t(xs), _t(ys), LAM, LAM, cfg, **kw)
        assert torch.equal(got, one_shot)
    # and the reference's face agrees within the pin
    jcfg, _ = _cfgs(max_iters=100, adapt_rho=False)
    want = jax_debiased_mean(jnp.asarray(xs), jnp.asarray(ys), LAM, LAM, jcfg)
    spread = reference_spread(lambda s: jax_rounds.simulate_multi_round(
        UlpHead(JaxBinaryHead(), s), (jnp.asarray(xs), jnp.asarray(ys)), lam=LAM,
        lam_prime=LAM, rounds=1, cfg=jcfg)[0][:, 0], want)
    assert_parity(one_shot, want, spread)


def test_identity_codec_is_dense_bit_for_bit():
    jws = _reference_solves(3)
    ws = _port_solves(jws)
    dense, dstate = rounds.simulate_round_loop(ws, rounds=T, return_all_rounds=True,
                                               return_transport_state=True)
    ident, istate = rounds.simulate_round_loop(ws, rounds=T, compression=Compression(D),
                                               return_all_rounds=True,
                                               return_transport_state=True)
    assert torch.equal(ident, dense)
    assert dstate.up_residual is None
    assert not bool(istate.up_residual.any())  # the identity codec leaves nothing behind


def test_faces_take_rounds_and_comms_like_the_reference():
    # the binary faces with three rounds, a top-k int8 uplink and a trimmed
    # aggregation, on shared draws (no fault schedule: the plans' draws differ)
    xs, ys = _draws(4)
    jcfg, cfg = _cfgs(max_iters=120, adapt_rho=False)
    for kw, jkw in (
            (dict(rounds=3), dict(rounds=3)),
            (dict(rounds=3, compression=Compression(D, None)),
             dict(rounds=3, compression=jax_comp.Compression(D, None))),
            (dict(rounds=2, comm=CommPlan(aggregation=Aggregation(trim=0.2))),
             dict(rounds=2, comm=jax_transport.CommPlan(
                 aggregation=jax_faults.Aggregation(trim=0.2))))):
        want = jax_debiased_mean(jnp.asarray(xs), jnp.asarray(ys), LAM, LAM, jcfg, **jkw)
        got = simulated_debiased_mean(_t(xs), _t(ys), LAM, LAM, cfg, **kw)
        spread = reference_spread(lambda s: jax_rounds.simulate_multi_round(
            UlpHead(JaxBinaryHead(), s), (jnp.asarray(xs), jnp.asarray(ys)), lam=LAM,
            lam_prime=LAM, cfg=jcfg, **jkw)[0][:, 0], want)
        assert_parity(got, want, spread)


def test_multi_round_slda_matches_reference():
    from repro.core.slda import multi_round_slda as jax_multi_round_slda
    from repro_torch.core.slda import multi_round_slda

    xs, ys = _draws(8)
    jcfg, cfg = _cfgs(max_iters=120, adapt_rho=False)
    jcomm = jax_transport.CommPlan(uplink=jax_comp.Compression(D))
    want = jax_multi_round_slda(jnp.asarray(xs), jnp.asarray(ys), LAM, LAM, 0.0, cfg=jcfg,
                                comm=jcomm)
    got = multi_round_slda(_t(xs), _t(ys), LAM, LAM, 0.0, cfg=cfg,
                           comm=interop.comm_plan_from_dict(jcomm._asdict()))
    spread = reference_spread(lambda s: jax_rounds.simulate_multi_round(
        UlpHead(JaxBinaryHead(), s), (jnp.asarray(xs), jnp.asarray(ys)), lam=LAM, lam_prime=LAM,
        rounds=3, cfg=jcfg, comm=jcomm)[0][:, 0], want)
    assert_parity(got, want, spread)
    t = 0.5 * float(np.abs(np.asarray(want)).max())
    assert torch.equal(multi_round_slda(_t(xs), _t(ys), LAM, LAM, t, cfg=cfg),
                       torch.where(got.abs() > t, got, torch.zeros_like(got)))


def test_warm_reentry_matches_reference_and_runs_fewer_iterations():
    # collect_info=True fills the warm carries; a re-entry with tol set
    # resumes both solves on K3's plain version (block_k pinned: the column
    # blocks are the gate groups) in fewer iterations, block counts equal to
    # the reference's for every machine, the solves within the pins
    xs, ys = _draws(5)
    jcfg, cfg = _cfgs(max_iters=200, adapt_rho=False, tol=1e-3, fused=True, block_k=8)
    data = (_t(xs), _t(ys))
    cold_bar, cold = rounds.simulate_multi_round(pipeline.BinaryHead(), data, lam=LAM,
                                                 lam_prime=LAM, rounds=2, cfg=cfg,
                                                 collect_info=True)
    warm_bar, warm = rounds.simulate_multi_round(
        pipeline.BinaryHead(), data, lam=LAM, lam_prime=LAM, rounds=2, cfg=cfg,
        collect_info=True, rho_beta=cold.rho_beta, rho_theta=cold.rho_theta,
        state_beta=cold.state_beta, state_theta=cold.state_theta)
    total = {name: int(ws.iters_beta.sum() + ws.iters_theta.sum())
             for name, ws in (("cold", cold), ("warm", warm))}
    assert total["warm"] < total["cold"], total
    jdata = (jnp.asarray(xs), jnp.asarray(ys))

    def reference(head, warm=None):
        carries = {} if warm is None else dict(
            rho_beta=warm.rho_beta, rho_theta=warm.rho_theta, state_beta=warm.state_beta,
            state_theta=warm.state_theta)
        return jax_rounds.simulate_multi_round(head, jdata, lam=LAM, lam_prime=LAM, rounds=2,
                                               cfg=jcfg, collect_info=True, **carries)[1]

    jcold = reference(JaxBinaryHead())
    jwarm = reference(JaxBinaryHead(), jcold)
    for ws, jws, warm in ((cold, jcold, None), (warm, jwarm, jcold)):
        np.testing.assert_array_equal(_np(ws.iters_beta), np.asarray(jws.iters_beta))
        np.testing.assert_array_equal(_np(ws.iters_theta), np.asarray(jws.iters_theta))
        spread = reference_spread(
            lambda s: reference(UlpHead(JaxBinaryHead(), s), warm).beta_hat, jws.beta_hat)
        assert_parity(ws.beta_hat, jws.beta_hat, spread)
    assert bool(torch.isfinite(warm_bar).all()) and warm_bar.shape == cold_bar.shape == (D, 1)


# --- the codec ---------------------------------------------------------------------------

QUANTIZE = [None, "bf16", "int8"]


def _tied_inputs(seed=0, m=3, d=16, k=2):
    """(m, d, k) messages and a shared reference whose deltas hold exact ties."""
    rng = np.random.default_rng(seed)
    ref = rng.standard_normal((d, k)).astype(np.float32)
    delta = rng.choice(np.array([0.5, -0.5, 0.25, 1.0, -1.0, 0.0], np.float32), (m, d, k))
    delta[:, :4] = 0.75  # the same magnitude in four rows of every column
    delta[:, 6] = -0.75
    message = (ref + delta).astype(np.float32)
    residual = rng.choice(np.array([0.0, 0.0, 0.125, -0.125], np.float32), (m, d, k))
    return message, residual, ref


def _jax_payload_np(p):
    return [None if v is None else np.asarray(v) for v in p]


@pytest.mark.parametrize("quantize", QUANTIZE, ids=lambda q: str(q))
@pytest.mark.parametrize("k_top", [1, 5, 16])
def test_encode_decode_ef_match_reference_on_ties(quantize, k_top):
    message, residual, ref = _tied_inputs()
    jc = jax_comp.Compression(k_top, quantize)
    comp = interop.compression_from_dict(jc._asdict())
    for i in range(message.shape[0]):
        u = message[i] + residual[i]
        want = _jax_payload_np(jax_comp.encode(jc, jnp.asarray(u), jnp.asarray(ref)))
        got = compression.encode(comp, _t(u), _t(ref))
        assert got.indices.dtype == torch.int16 and want[1].dtype == np.int16
        np.testing.assert_array_equal(_np(got.indices), want[1])  # ties: lower row first
        assert got.values.dtype == compression.wire_value_dtype(comp)
        np.testing.assert_array_equal(_np(got.values.to(torch.float32)),
                                      want[0].astype(np.float32))
        if quantize == "int8":
            np.testing.assert_array_equal(_np(got.scales), want[2])
        else:
            assert got.scales is None and want[2] is None
        jpay = jax_comp.Payload(*(None if v is None else jnp.asarray(v) for v in want))
        for screen in (True, False):
            np.testing.assert_array_equal(
                _np(compression.decode(comp, got, _t(ref), screen_nonfinite=screen)),
                np.asarray(jax_comp.decode(jc, jpay, jnp.asarray(ref),
                                           screen_nonfinite=screen)))
        jp, jres = jax_comp.ef_step(jc, jnp.asarray(message[i]), jnp.asarray(residual[i]),
                                    jnp.asarray(ref))
        p, res = compression.ef_step(comp, _t(message[i]), _t(residual[i]), _t(ref))
        np.testing.assert_array_equal(_np(p.indices), np.asarray(jp.indices))
        np.testing.assert_array_equal(_np(res), np.asarray(jres))
    # the machine stack in one call: every machine as alone, and the mean
    stack = compression.encode(comp, _t(message + residual), _t(ref))
    jstack = [jax_comp.encode(jc, jnp.asarray(message[i] + residual[i]), jnp.asarray(ref))
              for i in range(message.shape[0])]
    np.testing.assert_array_equal(_np(stack.indices),
                                  np.stack([np.asarray(p.indices) for p in jstack]))
    jstacked = jax_comp.Payload(*(None if v[0] is None else jnp.stack(v)
                                  for v in zip(*jstack)))
    np.testing.assert_array_equal(_np(compression.decode_stack(comp, stack, _t(ref))),
                                  np.asarray(jax_comp.decode_stack(jc, jstacked,
                                                                   jnp.asarray(ref))))
    assert_parity(compression.decode_mean(comp, stack, _t(ref)),
                  jax_comp.decode_mean(jc, jstacked, jnp.asarray(ref)))


def test_int8_rounds_half_to_even_and_bf16_at_halfway_values():
    # int8: a column whose largest delta is 127 * 2^-7 has the scale 2^-7
    # exactly, so deltas at (j + 1/2) * 2^-7 quantize at the halves
    d = 12
    halves = (np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, 126.5, -126.5, 4.0, 127.0, 0.0],
                       np.float32) * 2.0 ** -7)
    u = np.stack([halves, halves[::-1]], axis=1).astype(np.float32)
    ref = np.zeros((d, 2), np.float32)
    jc = jax_comp.Compression(d, "int8")
    want = jax_comp.encode(jc, jnp.asarray(u), jnp.asarray(ref))
    got = compression.encode(Compression(d, "int8"), _t(u), _t(ref))
    np.testing.assert_array_equal(_np(got.values), np.asarray(want.values))
    np.testing.assert_array_equal(_np(got.scales), [2.0 ** -7] * 2)
    codes = dict(zip(_np(got.indices)[:, 0].tolist(), _np(got.values)[:, 0].tolist()))
    assert [codes[i] for i in range(6)] == [0, 2, 2, 0, -2, -2]
    # bf16: values halfway between two bfloat16 neighbours round to the even one
    base = np.array([1.0, 1.0078125, -1.0, 3.0], np.float32)  # 1 + 2^-7 is a bf16 step
    half = (base + np.float32(2.0 ** -8) * np.sign(base)).astype(np.float32)
    u = np.stack([half, base], axis=1)
    jc = jax_comp.Compression(4, "bf16")
    want = jax_comp.encode(jc, jnp.asarray(u), jnp.zeros((4, 2)))
    got = compression.encode(Compression(4, "bf16"), _t(u), torch.zeros(4, 2))
    np.testing.assert_array_equal(_np(got.values.to(torch.float32)),
                                  np.asarray(want.values).astype(np.float32))


@pytest.mark.parametrize("d", [24, 200, 32767, 32768])
def test_bit_accounting_equals_reference(d):
    assert compression.wire_index_dtype(d) == {24: torch.int16, 200: torch.int16,
                                               32767: torch.int16, 32768: torch.int32}[d]
    assert compression.index_bits(d) == jax_comp.index_bits(d)
    for k in (1, 2, 5):
        assert compression.dense_uplink_bits(d, k) == jax_comp.dense_uplink_bits(d, k)
        for quantize in QUANTIZE:
            for k_top in (1, d // 5 or 1, d):
                jc = jax_comp.Compression(k_top, quantize)
                c = Compression(k_top, quantize)
                assert compression.uplink_bits(c, d, k) == jax_comp.uplink_bits(jc, d, k)
                assert compression.compression_ratio(c, d, k) == jax_comp.compression_ratio(
                    jc, d, k)


BUDGETS = [dict(total_bits=20000, mode="taper"), dict(total_bits=5000, mode="constant",
                                                      quantize=None),
           dict(total_bits=50, mode="taper", quantize="bf16"),
           dict(total_bits=10 ** 7, mode="constant"),
           dict(total_bits=9000, mode="adaptive", weights=(3.0, 1.0, 0.5), down_fraction=0.25),
           dict(total_bits=9000, mode="taper", taper=0.3, down_fraction=0.0)]


@pytest.mark.parametrize("budget", BUDGETS, ids=lambda b: f"{b['mode']}-{b['total_bits']}")
def test_bit_budget_plans_and_transport_totals_equal_reference(budget):
    jb = jax_transport.BitBudget(**budget)
    b = interop.bit_budget_from_dict(jb._asdict())
    for d, k in ((24, 1), (200, 5)):
        want = jb.plan_rounds(d, k, 3)
        got = b.plan_rounds(d, k, 3)
        assert [tuple(c) for pair in got for c in pair] == [tuple(c) for pair in want
                                                            for c in pair]
        jtr = jax_transport.Transport(jax_transport.CommPlan(schedule=jb), d, k, 3)
        tr = transport.Transport(CommPlan(schedule=b), d, k, 3)
        assert tr.uplink_total_bits() == jtr.uplink_total_bits()
        assert tr.downlink_total_bits() == jtr.downlink_total_bits()
        assert (tr.any_up, tr.any_down) == (jtr.any_up, jtr.any_down)


@pytest.mark.parametrize("fields", [{}, {"uplink": jax_comp.Compression(5, "int8")},
                                    {"uplink": jax_comp.Compression(40),
                                     "downlink": jax_comp.Compression(8, "bf16")}])
def test_transport_totals_and_links_equal_reference(fields):
    jcomm = jax_transport.CommPlan(**fields)
    comm = interop.comm_plan_from_dict(jcomm._asdict())
    for d, k, rounds_ in ((40, 1, 3), (200, 4, 2)):
        jtr = jax_transport.Transport(jcomm, d, k, rounds_)
        tr = transport.Transport(comm, d, k, rounds_)
        assert tr.uplink_total_bits() == jtr.uplink_total_bits()
        assert tr.downlink_total_bits() == jtr.downlink_total_bits()
        for t in range(1, rounds_ + 1):
            assert tr.up(t).bits(d, k) == jtr.up(t).bits(d, k)
            assert tr.down(t).compressed == jtr.down(t).compressed


def test_comm_plan_rules_match_reference():
    with pytest.raises(ValueError, match="schedule"):
        CommPlan(uplink=Compression(3), schedule=BitBudget(100)).validate()
    with pytest.raises(TypeError, match="not both"):
        transport.resolve_comm(CommPlan(), compression=Compression(3))
    with pytest.raises(TypeError, match="CommPlan"):
        transport.resolve_comm("plan")
    assert transport.resolve_comm(None, staleness=2, aggregation=Aggregation()) == CommPlan(
        staleness=2, aggregation=Aggregation())
    with pytest.raises(ValueError, match="k_top"):
        Compression(30).validate(24)
    with pytest.raises(ValueError, match="adaptive"):
        BitBudget(100, mode="adaptive").round_shares(3)
    jplan = jax_transport.CommPlan(uplink=jax_comp.Compression(3, "bf16"), staleness=1,
                                   faults=jax_faults.FaultSchedule(dropout=0.1, seed=2),
                                   aggregation=jax_faults.Aggregation(trim=0.1, envelope=5.0))
    plan = interop.comm_plan_from_dict(jplan._asdict())
    assert plan == CommPlan(uplink=Compression(3, "bf16"), staleness=1,
                            faults=FaultSchedule(dropout=0.1, seed=2),
                            aggregation=Aggregation(trim=0.1, envelope=5.0))
    nested = interop.comm_plan_from_dict({"schedule": {"total_bits": 10, "weights": [1.0, 2.0],
                                                       "mode": "adaptive"}})
    assert nested.schedule.weights == (1.0, 2.0) and hash(nested)


# --- faults ------------------------------------------------------------------------------


def _fault_stack(seed=0, m=6, d=5, k=2):
    """An (m, d, k) stack with a NaN machine, an inf machine, a garbage machine and a dead one."""
    rng = np.random.default_rng(seed)
    stack = rng.standard_normal((m, d, k)).astype(np.float32)
    stack[1, 2, 0] = np.nan
    stack[2, 0, 1] = np.inf
    stack[3] = 1e12
    w = np.ones(m, np.float32)
    w[4] = 0.0
    return stack, w


@pytest.mark.parametrize("agg", [dict(), dict(screen=False), dict(envelope=10.0),
                                 dict(screen=False, envelope=10.0)])
def test_screen_weight_matches_reference(agg):
    stack, _ = _fault_stack()
    jagg = jax_faults.Aggregation(**agg)
    want = np.stack([np.asarray(jax_faults.screen_weight(jagg, jnp.asarray(b))) for b in stack])
    got = faults.screen_weight(Aggregation(**agg), _t(stack))
    np.testing.assert_array_equal(_np(got), want)


@pytest.mark.parametrize("trim", [0.0, 0.2, 0.4])
def test_masked_and_trimmed_means_match_reference(trim):
    stack, w = _fault_stack(1)
    agg = Aggregation()
    w = w * _np(faults.screen_weight(agg, _t(stack)))  # NaN and inf machines screened
    if trim == 0.0:
        want, wden = jax_faults.masked_mean(jnp.asarray(stack), jnp.asarray(w))
        got, den = faults.masked_mean(_t(stack), _t(w))
    else:
        want, wden = jax_faults.trimmed_mean(jnp.asarray(stack), jnp.asarray(w), trim)
        got, den = faults.trimmed_mean(_t(stack), _t(w), trim)
    assert float(den) == float(wden)
    assert bool(torch.isfinite(got).all())
    assert_parity(got, want)
    # every machine dead: count 0, a zero mean, no NaN
    for fn in (lambda s, z: faults.masked_mean(s, z), lambda s, z: faults.trimmed_mean(s, z, 0.2)):
        mean, count = fn(_t(stack), torch.zeros(stack.shape[0]))
        assert float(count) == 0.0 and not bool(mean.any())


@pytest.mark.parametrize("quantize", QUANTIZE, ids=lambda q: str(q))
def test_corruption_matches_reference(quantize):
    stack = _fault_stack(2, d=6)[0][:4]
    codes = np.array([0, 1, 2, 3], np.int32)
    want = np.stack([np.asarray(jax_faults.corrupt_block(jnp.asarray(c), jnp.asarray(b)))
                     for c, b in zip(codes, stack)])
    np.testing.assert_array_equal(_np(faults.corrupt_block(_t(codes, torch.int32),
                                                           _t(stack))), want)
    jc = jax_comp.Compression(3, quantize)
    comp = interop.compression_from_dict(jc._asdict())
    ref = np.zeros((6, 2), np.float32)
    pay = compression.encode(comp, _t(stack[:, :, :2].copy()), _t(ref))
    got = faults.corrupt_payload(comp, _t(codes, torch.int32), pay)
    for i, c in enumerate(codes):
        jp = jax_comp.Payload(jnp.asarray(_np(pay.values[i].to(torch.float32))).astype(
            jax_comp.wire_value_dtype(jc)), jnp.asarray(_np(pay.indices[i])),
            None if pay.scales is None else jnp.asarray(_np(pay.scales[i])))
        jw = jax_faults.corrupt_payload(jc, jnp.asarray(c), jp)
        np.testing.assert_array_equal(_np(got.values[i].to(torch.float32)),
                                      np.asarray(jw.values).astype(np.float32))
        if quantize == "int8":
            np.testing.assert_array_equal(_np(got.scales[i]), np.asarray(jw.scales))


def test_select_anchor_matches_reference():
    rng = np.random.default_rng(3)
    history = [rng.standard_normal((M, D, 1)).astype(np.float32) for _ in range(4)]
    stale = np.array([0, 1, 2, 3, 5], np.int32)
    for t in (2, 3, 4):
        for bound in (1, 2, 3):
            want = jax_faults.select_anchor([jnp.asarray(h) for h in history],
                                            jnp.asarray(stale), t, bound)
            got = faults.select_anchor([_t(h) for h in history], _t(stale, torch.int32), t,
                                       bound)
            np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_fault_schedule_plan_rates_and_seed():
    sched = FaultSchedule(dropout=0.2, straggle=0.3, corrupt=0.1, corrupt_mode="mix", seed=11)
    plan = sched.plan(400, 50, 3, device="cpu")
    n = 400 * 50
    for got, p in ((1.0 - plan.live.mean(), 0.2), ((plan.stale > 0).float().mean(), 0.3),
                   ((plan.corrupt > 0).float().mean(), 0.1)):
        assert abs(float(got) - p) <= 4 * (p * (1 - p) / n) ** 0.5, (float(got), p)
    assert plan.live.dtype == torch.float32 and plan.stale.dtype == torch.int32
    assert set(plan.stale.unique().tolist()) == {0, 1, 2, 3}
    hit = plan.corrupt > 0
    rows, cols = torch.meshgrid(torch.arange(400), torch.arange(50), indexing="ij")
    assert torch.equal(plan.corrupt[hit], (1 + (rows + cols) % 3)[hit].to(torch.int32))
    again = sched.plan(400, 50, 3, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(plan, again))
    other = sched._replace(seed=12).plan(400, 50, 3, device="cpu")
    assert not torch.equal(plan.live, other.live)
    assert plan.row(2)[0].shape == (400,) and plan.rounds == 50
    with pytest.raises(ValueError, match="corrupt_mode"):
        FaultSchedule(corrupt_mode="zeros").plan(2, 2, device="cpu")


def test_chaos_rounds_stay_finite_and_schedules_materialize_on_the_solves_device():
    # every machine NaN in every round: the masked aggregate never leaves the
    # last good value (zeros); every machine dead: zeros
    ws = _port_solves(_reference_solves(6))
    nan = rounds.simulate_round_loop(ws, rounds=T, faults=FaultSchedule(corrupt=1.0, seed=7),
                                     aggregation=Aggregation())
    assert bool(torch.isfinite(nan).all()) and not bool(nan.any())
    dead = FaultPlan(torch.zeros(M, T), torch.zeros(M, T, dtype=torch.int32),
                     torch.zeros(M, T, dtype=torch.int32))
    assert not bool(rounds.simulate_round_loop(ws, rounds=T, faults=dead,
                                               aggregation=Aggregation()).any())
    unmasked = rounds.simulate_round_loop(ws, rounds=T, faults=FaultSchedule(corrupt=1.0, seed=7))
    assert not bool(torch.isfinite(unmasked).any())  # the fragile baseline is poisoned
    with pytest.raises(TypeError, match="inside comm"):
        rounds.simulate_round_loop(ws, rounds=T, comm=CommPlan(), faults=FaultSchedule())
    with pytest.raises(ValueError, match="FaultPlan leaves"):
        rounds.simulate_round_loop(ws, rounds=2, faults=dead)
    with pytest.raises(ValueError, match="rounds"):
        rounds.simulate_round_loop(ws, rounds=0)


def test_resume_reproduces_an_uninterrupted_stream():
    # a 3-round stream split 2 + 1 with the carried residuals and the last
    # received aggregate equals the straight run bit for bit
    ws = _port_solves(_reference_solves(7))
    comm = CommPlan(uplink=Compression(6, "int8"), downlink=Compression(8))
    straight = rounds.simulate_round_loop(ws, rounds=3, comm=comm)
    first, state = rounds.simulate_round_loop(ws, rounds=2, comm=comm,
                                              return_transport_state=True)
    rest = rounds.simulate_round_loop(ws, rounds=1, comm=comm, ef_residual=state.up_residual,
                                      down_residual=state.down_residual, resume_from=first)
    assert torch.equal(rest, straight)
