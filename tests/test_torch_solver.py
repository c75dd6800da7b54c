"""The port's eager ADMM scan solver and dispatch against the JAX reference, on shared inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.dantzig import DantzigConfig as JaxDantzigConfig
from repro.core.dantzig import kkt_violation as jax_kkt_violation
from repro.core.dantzig import solve_dantzig_scan as jax_solve_dantzig_scan
from repro.core.solver_dispatch import solve_dantzig_with_rho as jax_solve_dantzig_with_rho
from repro.stats.synthetic import ar1_covariance
from repro_torch import interop
from repro_torch.core import dantzig, solver_dispatch
from repro_torch.core.dantzig import DantzigConfig
from test_torch_parity import assert_parity, perturb_ulp, reference_spread


def _t(a):
    return interop.tensor(a, device="cpu")


def _inputs(d=32, k=9, seed=0):
    rng = np.random.default_rng(seed)
    chol = np.linalg.cholesky(ar1_covariance(d, 0.8))
    x = (rng.standard_normal((120, d)) @ chol.T).astype(np.float32)
    xc = x - x.mean(0)
    sigma = (xc.T @ xc / 120).astype(np.float32)
    b = np.eye(d, dtype=np.float32)[:, ::d // k][:, :k]
    b[:, 0] = np.r_[np.ones(5), np.zeros(d - 5)]  # one direction-like column
    lam = rng.uniform(0.08, 0.2, k).astype(np.float32)
    return sigma, b, lam


def _cfgs(**kw):
    jcfg = JaxDantzigConfig(**kw)
    return jcfg, interop.dantzig_config_from_dict(jcfg._asdict())


def test_scan_fixed_rho_matches_reference():
    # adapt_rho=False, 200 iterations: the 1e-5 pin, relative to the
    # largest entry (the f32 sums run in another order than XLA's), or
    # the reference's own spread when Sigma moves by one ulp
    sigma, b, lam = _inputs()
    jcfg, cfg = _cfgs(max_iters=200, adapt_rho=False)

    def reference(s):
        return np.asarray(jax_solve_dantzig_scan(jnp.asarray(s), jnp.asarray(b),
                                                 jnp.asarray(lam), jcfg))

    want = reference(sigma)
    got = dantzig.solve_dantzig_scan(_t(sigma), _t(b), _t(lam), cfg).numpy()
    assert_parity(got, want, reference_spread(lambda s: reference(perturb_ulp(sigma, s)), want))


def test_scan_adaptive_rho_matches_reference_support_and_l2():
    # residual balancing makes discrete rho choices that f32 noise can
    # flip, so the pin is on the support and a 1e-3 l2 gap
    sigma, b, lam = _inputs(seed=1)
    jcfg, cfg = _cfgs(max_iters=200)
    want, want_rho = jax_solve_dantzig_scan(jnp.asarray(sigma), jnp.asarray(b),
                                            jnp.asarray(lam), jcfg, return_rho=True)
    got, got_rho = dantzig.solve_dantzig_scan(_t(sigma), _t(b), _t(lam), cfg, return_rho=True)
    want, got = np.asarray(want), got.numpy()
    assert ((got != 0) == (want != 0)).all()
    assert np.linalg.norm(got - want) <= 1e-3
    np.testing.assert_array_equal(got_rho.numpy(), np.asarray(want_rho))


@pytest.mark.parametrize("fused", [False, True])
def test_dispatch_matches_reference_with_rho_seed(fused):
    sigma, b, lam = _inputs(d=24, k=5, seed=2)
    rho = np.linspace(0.5, 2.0, 5).astype(np.float32)
    jcfg, cfg = _cfgs(max_iters=150, adapt_rho=False, fused=fused)

    def reference(s):
        return jax_solve_dantzig_with_rho(jnp.asarray(s), jnp.asarray(b), jnp.asarray(lam), jcfg,
                                          rho=jnp.asarray(rho))

    want, want_rho = reference(sigma)
    got, got_rho = solver_dispatch.solve_dantzig_with_rho(_t(sigma), _t(b), _t(lam), cfg,
                                                          rho=_t(rho))
    spread = reference_spread(lambda s: reference(perturb_ulp(sigma, s))[0], want)
    assert_parity(got, want, spread)
    np.testing.assert_array_equal(got_rho.numpy(), np.asarray(want_rho))


def test_single_rhs_squeezes_like_reference():
    sigma, b, _ = _inputs(d=24, k=3, seed=3)
    jcfg, cfg = _cfgs(max_iters=100)
    want = np.asarray(jax_solve_dantzig_with_rho(jnp.asarray(sigma), jnp.asarray(b[:, 0]),
                                                 0.1, jcfg)[0])
    got = dantzig.solve_dantzig(_t(sigma), _t(b[:, 0]), 0.1, cfg)
    assert got.shape == (24,)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_shrink_kernel_switch_is_the_same_math_on_cpu():
    # use_kernel=True routes the shrink through the K4 wrapper, whose
    # plain version on the CPU is bit-identical to the inline shrink
    sigma, b, lam = _inputs(d=24, k=4, seed=4)
    _, cfg = _cfgs(max_iters=120)
    plain = dantzig.solve_dantzig_scan(_t(sigma), _t(b), _t(lam), cfg)
    kern = dantzig.solve_dantzig_scan(_t(sigma), _t(b), _t(lam), cfg._replace(use_kernel=True))
    torch.testing.assert_close(kern, plain, rtol=0, atol=0)


def test_machine_batch_matches_per_machine_solves():
    mats = [_inputs(d=24, k=4, seed=s) for s in range(3)]
    sigma = _t(np.stack([s for s, _, _ in mats]))
    b = _t(mats[0][1])
    _, cfg = _cfgs(max_iters=100)
    batched = dantzig.solve_dantzig(sigma, b.expand(3, 24, 4), 0.12, cfg)
    assert batched.shape == (3, 24, 4)
    for i in range(3):
        one = dantzig.solve_dantzig(sigma[i], b, 0.12, cfg)
        torch.testing.assert_close(batched[i], one, rtol=0, atol=1e-6)


def test_kkt_violation_matches_reference():
    sigma, b, lam = _inputs(d=24, k=4, seed=5)
    beta = np.random.default_rng(6).standard_normal((24, 4)).astype(np.float32) * 0.2
    want = np.asarray(jax_kkt_violation(jnp.asarray(sigma), jnp.asarray(b),
                                        jnp.asarray(beta), jnp.asarray(lam)))
    got = dantzig.kkt_violation(_t(sigma), _t(b), _t(beta), _t(lam)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    want1 = float(jax_kkt_violation(jnp.asarray(sigma), jnp.asarray(b[:, 0]),
                                    jnp.asarray(beta[:, 0]), 0.1))
    got1 = float(dantzig.kkt_violation(_t(sigma), _t(b[:, 0]), _t(beta[:, 0]), 0.1))
    assert got1 == pytest.approx(want1, rel=1e-5, abs=1e-6)


def _scan_inputs(d=24, k=5, seed=8):
    """A well-conditioned AR(0.3) sample covariance and CLIME-like columns for the tol gate."""
    rng = np.random.default_rng(seed)
    chol = np.linalg.cholesky(ar1_covariance(d, 0.3))
    x = (rng.standard_normal((400, d)) @ chol.T).astype(np.float32)
    xc = x - x.mean(0)
    sigma = (xc.T @ xc / 400).astype(np.float32)
    b = np.eye(d, dtype=np.float32)[:, :k]
    lam = np.linspace(0.1, 0.5, k).astype(np.float32)
    return sigma, b, lam


def _jax_state(leaves):
    from repro.kernels.dantzig_fused import AdmmState as JaxAdmmState

    return JaxAdmmState(*(jnp.asarray(v) for v in leaves))


def _close(got, want, pin=1e-5):
    want = np.asarray(want)
    assert np.abs(np.asarray(got) - want).max() <= pin * max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("mode", ["tol", "state0", "return_info"])
def test_scan_state_modes_match_reference(mode):
    # each of the three modes the port's scan gained, alone, against the
    # reference's scan: the 1e-5 pin at 200 fixed-rho iterations, equal
    # executed iterations, every state leaf
    sigma, b, lam = _scan_inputs()
    jcfg, cfg = _cfgs(max_iters=200, adapt_rho=False, **({"tol": 1e-3} if mode == "tol" else {}))
    jkw, kw = {"return_info": True}, {"return_info": True}
    if mode == "state0":
        warm = jax_solve_dantzig_scan(jnp.asarray(sigma), jnp.asarray(b), jnp.asarray(lam),
                                      jcfg._replace(max_iters=30), return_info=True)[1]
        jkw["state0"] = warm
        kw["state0"] = interop.state_from_numpy(*(np.asarray(v) for v in warm), device="cpu")
    want_beta, want_state, want_iters = jax_solve_dantzig_scan(
        jnp.asarray(sigma), jnp.asarray(b), jnp.asarray(lam), jcfg, **jkw)
    beta, state, iters = dantzig.solve_dantzig_scan(_t(sigma), _t(b), _t(lam), cfg, **kw)
    assert int(iters) == int(want_iters)
    if mode == "tol":
        assert int(iters) < 200
    _close(beta, want_beta)
    for got, want in zip(state, want_state):
        _close(got, want)


def test_scan_tol_with_adaptive_rho_matches_reference():
    # the balancing index runs on the global iteration count across
    # chunks; rho choices are discrete, so the pins are the executed
    # count, the support and a 1e-3 l2 gap
    sigma, b, lam = _scan_inputs(seed=9)
    jcfg, cfg = _cfgs(max_iters=200, tol=1e-3, adapt_every=7)
    want, want_rho, _, want_iters = jax_solve_dantzig_scan(
        jnp.asarray(sigma), jnp.asarray(b), jnp.asarray(lam), jcfg, return_rho=True,
        return_info=True)
    got, got_rho, _, iters = dantzig.solve_dantzig_scan(_t(sigma), _t(b), _t(lam), cfg,
                                                        return_rho=True, return_info=True)
    assert int(iters) == int(want_iters) < 200
    want, got = np.asarray(want), got.numpy()
    assert ((got != 0) == (want != 0)).all()
    assert np.linalg.norm(got - want) <= 1e-3
    np.testing.assert_array_equal(got_rho.numpy(), np.asarray(want_rho))


def test_scan_resume_restarts_the_balancing_index():
    # a resumed call counts its iterations from 0 again, as the
    # reference does: 20 + 30 resumed is not 50 straight once rho adapts
    # (a far-off rho of 20 makes the balancing act)
    sigma, b, lam = _scan_inputs(seed=10)
    jcfg, cfg = _cfgs(max_iters=20, adapt_every=7, rho=20.0)
    jwarm, jrho = jax_solve_dantzig_scan(jnp.asarray(sigma), jnp.asarray(b), jnp.asarray(lam),
                                         jcfg, return_rho=True, return_info=True)[1:3][::-1]
    jbeta = jax_solve_dantzig_scan(jnp.asarray(sigma), jnp.asarray(b), jnp.asarray(lam),
                                   jcfg._replace(max_iters=30), jrho, state0=jwarm)
    _, rho, warm, _ = dantzig.solve_dantzig_scan(_t(sigma), _t(b), _t(lam), cfg,
                                                 return_rho=True, return_info=True)
    beta = dantzig.solve_dantzig_scan(_t(sigma), _t(b), _t(lam), cfg._replace(max_iters=30),
                                      rho, state0=warm)
    straight = dantzig.solve_dantzig_scan(_t(sigma), _t(b), _t(lam), cfg._replace(max_iters=50))
    _close(beta, jbeta)
    assert not torch.equal(beta, straight)


def test_scan_gate_is_per_machine():
    # machines on the leading axis: a converged machine freezes while the
    # others run on, so each machine's count and solution equal the
    # machine solved alone
    mats = [_scan_inputs(seed=s) for s in (11, 12, 13)]
    sigma = _t(np.stack([m[0] for m in mats]))
    b, lam = _t(mats[0][1]), _t(mats[0][2])
    _, cfg = _cfgs(max_iters=200, tol=1e-3, adapt_rho=False)
    beta, state, iters = dantzig.solve_dantzig_scan(sigma, b.expand(3, 24, 5), lam, cfg,
                                                    return_info=True)
    assert iters.shape == (3,) and iters.dtype == torch.int32
    for i in range(3):
        one_beta, _, one_iters = dantzig.solve_dantzig_scan(sigma[i], b, lam, cfg,
                                                            return_info=True)
        assert int(iters[i]) == int(one_iters)
        torch.testing.assert_close(beta[i], one_beta, rtol=0, atol=1e-6)
        want_iters = jax_solve_dantzig_scan(jnp.asarray(mats[i][0]), jnp.asarray(b.numpy()),
                                            jnp.asarray(lam.numpy()), _cfgs(
                                                max_iters=200, tol=1e-3, adapt_rho=False)[0],
                                            return_info=True)[2]
        assert int(iters[i]) == int(want_iters)
    assert len(set(iters.tolist())) >= 2, iters


@pytest.mark.parametrize("kind,block_k", [("scan", None), ("fused", None),
                                          ("fused_blocked", 2)])
@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_solve_dantzig_full_matches_reference(kind, block_k, warm):
    # every dispatch path with tol and a warm state: solution, rho, state
    # and per-column iteration counts (a block's count repeated over its
    # columns) against the reference's solve_dantzig_full
    from repro.core.solver_dispatch import solve_dantzig_full as jax_solve_dantzig_full

    sigma, b, lam = _scan_inputs(seed=14)
    jcfg, cfg = _cfgs(max_iters=200, adapt_rho=False, tol=1e-3, fused=kind != "scan",
                      block_k=block_k)
    assert solver_dispatch.select_solver(cfg, 24, 5).kind == kind
    rho = np.linspace(0.8, 1.2, 5).astype(np.float32)
    jstate = state = None
    if warm:
        pre = jax_solve_dantzig_full(jnp.asarray(sigma), jnp.asarray(b), jnp.asarray(lam),
                                     jcfg._replace(tol=None, max_iters=40), rho=jnp.asarray(rho))
        jstate = pre.state
        state = interop.state_from_numpy(*(np.asarray(v) for v in jstate), device="cpu")
    want = jax_solve_dantzig_full(jnp.asarray(sigma), jnp.asarray(b), jnp.asarray(lam), jcfg,
                                  rho=jnp.asarray(rho), state=jstate, backend="cpu")
    got = solver_dispatch.solve_dantzig_full(_t(sigma), _t(b), _t(lam), cfg, rho=_t(rho),
                                             state=state)
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(want.iters))
    assert got.iters.numpy().max() < 200
    _close(got.beta, want.beta)
    np.testing.assert_array_equal(got.rho.numpy(), np.asarray(want.rho))
    for g, w in zip(got.state, want.state):
        _close(g, w)
    # the narrow entry point routes tol and state through the full solve
    beta, rho_out = solver_dispatch.solve_dantzig_with_rho(_t(sigma), _t(b), _t(lam), cfg,
                                                           rho=_t(rho), state=state)
    torch.testing.assert_close(beta, got.beta, rtol=0, atol=0)


def test_solve_dantzig_full_vector_rhs_squeezes_like_reference():
    from repro.core.solver_dispatch import solve_dantzig_full as jax_solve_dantzig_full

    sigma, b, _ = _scan_inputs(seed=15)
    jcfg, cfg = _cfgs(max_iters=150, adapt_rho=False, tol=1e-3, fused=True)
    want = jax_solve_dantzig_full(jnp.asarray(sigma), jnp.asarray(b[:, 1]), 0.2, jcfg)
    got = solver_dispatch.solve_dantzig_full(_t(sigma), _t(b[:, 1]), 0.2, cfg)
    assert got.beta.shape == (24,) and got.iters.shape == () and got.rho.shape == ()
    assert int(got.iters) == int(want.iters)
    _close(got.beta, want.beta)
    for g, w in zip(got.state, want.state):
        assert g.shape == (24,)
        _close(g, w)
