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
    # largest entry (the f32 sums run in another order than XLA's)
    sigma, b, lam = _inputs()
    jcfg, cfg = _cfgs(max_iters=200, adapt_rho=False)
    want = np.asarray(jax_solve_dantzig_scan(jnp.asarray(sigma), jnp.asarray(b),
                                             jnp.asarray(lam), jcfg))
    got = dantzig.solve_dantzig_scan(_t(sigma), _t(b), _t(lam), cfg).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


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
    want, want_rho = jax_solve_dantzig_with_rho(jnp.asarray(sigma), jnp.asarray(b),
                                                jnp.asarray(lam), jcfg, rho=jnp.asarray(rho))
    got, got_rho = solver_dispatch.solve_dantzig_with_rho(_t(sigma), _t(b), _t(lam), cfg,
                                                          rho=_t(rho))
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-5 * np.abs(want).max()
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


@pytest.mark.parametrize("kw", [dict(tol=1e-4), dict(state0=True), dict(return_info=True)])
def test_next_slice_modes_raise(kw):
    sigma, b, lam = _inputs(d=16, k=2, seed=7)
    cfg = DantzigConfig(max_iters=5)
    if "tol" in kw:
        cfg, kw = cfg._replace(tol=kw["tol"]), {}
    elif "state0" in kw:
        kw = {"state0": dantzig.AdmmState.zeros(16, 2)}
    with pytest.raises(NotImplementedError, match="next slice"):
        dantzig.solve_dantzig_scan(_t(sigma), _t(b), _t(lam), cfg, **kw)
    with pytest.raises(NotImplementedError, match="next slice"):
        solver_dispatch.solve_dantzig_full(_t(sigma), _t(b), 0.1)
