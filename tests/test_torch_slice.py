"""The port's one-shot Algorithm 1 (the quickstart path) against the JAX reference, on shared draws.

The machines' samples are drawn once with numpy and handed to both
packages; neither package's own sampler is used for the comparison.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import classifier as jax_classifier
from repro.core.dantzig import DantzigConfig as JaxDantzigConfig
from repro.core.distributed import simulated_debiased_mean as jax_debiased_mean
from repro.core.distributed import simulated_distributed_slda as jax_distributed
from repro.core.distributed import simulated_naive_averaged_slda as jax_naive
from repro.core.slda import centralized_slda as jax_centralized
from repro.core.slda import hard_threshold as jax_hard_threshold
from repro.stats import synthetic as jax_synthetic
from repro_torch import interop, quickstart
from repro_torch.core import classifier, pipeline, slda
from repro_torch.core.clime import solve_clime, symmetrize_min
from repro_torch.core.distributed import simulated_debiased_mean, simulated_distributed_slda
from repro_torch.stats import synthetic
import test_torch_parity  # noqa: F401  (pins torch to one thread)

D, M, N_PER = 32, 3, 80


def _t(a, dtype=torch.float32):
    return interop.tensor(a, device="cpu", dtype=dtype)


def _draws(seed=0, n_test=400):
    """Shared numpy draws of the §5.1 design at d = 32: machines and a labeled test set."""
    problem = jax_synthetic.make_problem(d=D, n_signal=6, rho=0.8)
    fields = {k: np.asarray(v) for k, v in problem._asdict().items()}
    rng = np.random.default_rng(seed)
    n1 = N_PER // 2
    chol = fields["chol"]
    xs = (fields["mu1"] + rng.standard_normal((M, n1, D)) @ chol.T).astype(np.float32)
    ys = (fields["mu2"] + rng.standard_normal((M, n1, D)) @ chol.T).astype(np.float32)
    labels = (rng.random(n_test) < 0.5).astype(np.int32)
    z = np.where(labels[:, None] == 0, fields["mu1"], fields["mu2"])
    z = (z + rng.standard_normal((n_test, D)) @ chol.T).astype(np.float32)
    return fields, xs, ys, z, labels


def test_make_problem_equals_reference_bit_for_bit():
    ref = jax_synthetic.make_problem(d=D, n_signal=6, rho=0.8)
    port = synthetic.make_problem(d=D, n_signal=6, rho=0.8, device="cpu")
    for name in ref._fields:
        np.testing.assert_array_equal(getattr(port, name).numpy(), np.asarray(getattr(ref, name)))
    np.testing.assert_array_equal(
        interop.problem_from_numpy({k: np.asarray(v) for k, v in ref._asdict().items()},
                                   device="cpu").sigma.numpy(), np.asarray(ref.sigma))


def test_interop_carries_reference_objects_across():
    from repro.kernels.dantzig_fused import AdmmState as JaxAdmmState
    from repro.kernels.spectral import spectral_factor as jax_spectral_factor

    sigma = jnp.asarray(np.eye(4, dtype=np.float32) * 2)
    jf = jax_spectral_factor(sigma)
    factor = interop.factor_from_numpy(*(np.asarray(v) for v in jf), device="cpu")
    np.testing.assert_array_equal(factor.inv_eig.numpy(), np.asarray(jf.inv_eig))
    js = JaxAdmmState(*(jnp.full((4, 2), float(i)) for i in range(4)))
    state = interop.state_from_numpy(*(np.asarray(v) for v in js), device="cpu")
    assert [float(v[0, 0]) for v in state] == [0.0, 1.0, 2.0, 3.0]
    jcfg = JaxDantzigConfig(max_iters=7, fused=True, block_k=3)
    assert tuple(interop.dantzig_config_from_dict(jcfg._asdict())) == tuple(jcfg)
    with pytest.raises(ValueError, match="does not have"):
        interop.dantzig_config_from_dict({"not_a_field": 1})


@pytest.mark.parametrize("fused", [False, True])
def test_debiased_mean_matches_reference(fused):
    # before the threshold, adapt_rho=False, 200 iterations: the 1e-5
    # pin relative to the largest entry (f32 sums in another order)
    _, xs, ys, _, _ = _draws()
    jcfg = JaxDantzigConfig(max_iters=200, adapt_rho=False, fused=fused)
    cfg = interop.dantzig_config_from_dict(jcfg._asdict())
    want = np.asarray(jax_debiased_mean(jnp.asarray(xs), jnp.asarray(ys), 0.2, 0.15, jcfg))
    got = simulated_debiased_mean(_t(xs), _t(ys), 0.2, 0.15, cfg).numpy()
    assert got.shape == (D,)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def _reference_quickstart(fields, xs, ys, z, labels, jcfg):
    """examples/quickstart.py's estimators and table on given draws, in JAX."""
    d, m = D, M
    N = m * N_PER
    b1 = float(np.abs(fields["beta_star"]).sum())
    lam = 0.3 * math.sqrt(math.log(d) / N_PER) * b1
    lam_c = 0.3 * math.sqrt(math.log(d) / N) * b1
    t = 0.5 * math.sqrt(math.log(d) / N) * b1
    xs, ys = jnp.asarray(xs), jnp.asarray(ys)
    dist = jax_distributed(xs, ys, lam, lam, t, jcfg)
    naive = jax_naive(xs, ys, lam, jcfg)
    cent = jax_hard_threshold(
        jax_centralized(xs.reshape(-1, d), ys.reshape(-1, d), lam_c, jcfg), 0.5 * t)
    mu1 = jnp.mean(xs.reshape(-1, d), axis=0)
    mu2 = jnp.mean(ys.reshape(-1, d), axis=0)
    beta_star = jnp.asarray(fields["beta_star"])
    rows = {}
    for name, beta in zip(quickstart.METHODS, (dist, cent, naive)):
        err = jax_classifier.estimation_errors(beta, beta_star)
        rows[name] = (float(jax_classifier.f1_score(beta, beta_star)), float(err["l2"]),
                      float(err["linf"]),
                      float(jax_classifier.misclassification_rate(
                          jnp.asarray(z), jnp.asarray(labels), beta, mu1, mu2)))
    return rows, (lam, lam_c, t), {n: np.asarray(b) for n, b in
                                  zip(quickstart.METHODS, (dist, cent, naive))}


def test_quickstart_table_matches_reference_on_shared_draws():
    # the quickstart's own adaptive-rho config at 200 iterations: the
    # estimates may differ by discrete rho choices, so the pins are the
    # table's statistics -- F1 equal, l2 / linf / misclass within 1e-3
    fields, xs, ys, z, labels = _draws(seed=1)
    jcfg = JaxDantzigConfig(max_iters=200)
    want, (lam, lam_c, t), want_betas = _reference_quickstart(fields, xs, ys, z, labels, jcfg)
    cfg = interop.dantzig_config_from_dict(jcfg._asdict())
    problem = interop.problem_from_numpy(fields, device="cpu")
    assert quickstart.tuning(problem.beta_star, D, N_PER, M * N_PER) == pytest.approx(
        (lam, lam_c, t), rel=1e-6)
    betas = quickstart.estimators(_t(xs), _t(ys), lam, lam_c, t, cfg)
    got = quickstart.metrics(betas, problem.beta_star, _t(z), _t(labels),
                             _t(xs.reshape(-1, D)).mean(0), _t(ys.reshape(-1, D)).mean(0))
    assert list(got) == list(want)
    for name in want:
        assert got[name][0] == want[name][0], name
        np.testing.assert_allclose(got[name][1:], want[name][1:], atol=1e-3, err_msg=name)
        assert ((betas[name].numpy() != 0) == (want_betas[name] != 0)).all(), name


def test_one_eigh_for_the_whole_machine_batch(monkeypatch):
    _, xs, ys, _, _ = _draws()
    calls = []
    eigh = torch.linalg.eigh

    def counting(a, *args, **kw):
        calls.append(tuple(a.shape))
        return eigh(a, *args, **kw)

    monkeypatch.setattr(torch.linalg, "eigh", counting)
    cfg = interop.dantzig_config_from_dict(JaxDantzigConfig(max_iters=20, fused=True)._asdict())
    simulated_distributed_slda(_t(xs), _t(ys), 0.2, 0.2, 0.05, cfg)
    assert calls == [(M, D, D)]


def test_worker_pieces_agree():
    _, xs, ys, _, _ = _draws()
    cfg = interop.dantzig_config_from_dict(JaxDantzigConfig(max_iters=60)._asdict())
    beta_tilde, beta_hat, stats = pipeline.worker_debiased(
        pipeline.BinaryHead(), _t(xs), _t(ys), lam=0.2, lam_prime=0.2, cfg=cfg)
    assert beta_tilde.shape == beta_hat.shape == (M, D, 1)
    theta = solve_clime(stats.sigma, 0.2, cfg)
    torch.testing.assert_close(
        slda.debias(stats.aux, beta_hat[..., 0], theta), beta_tilde[..., 0], rtol=0, atol=0)
    tilde1, hat1 = slda.debiased_local_estimator(_t(xs), _t(ys), 0.2, cfg=cfg)
    torch.testing.assert_close(tilde1, beta_tilde[..., 0], rtol=0, atol=0)
    sym = symmetrize_min(theta)
    torch.testing.assert_close(sym, sym.mT, rtol=0, atol=0)
    agg = slda.aggregate(beta_tilde[..., 0], 0.05)
    torch.testing.assert_close(agg, slda.hard_threshold(beta_tilde[..., 0].mean(0), 0.05))


def test_classifier_metrics_match_reference():
    fields, xs, ys, z, labels = _draws(seed=2)
    rng = np.random.default_rng(3)
    beta = np.where(rng.random(D) < 0.3, rng.standard_normal(D), 0).astype(np.float32)
    mu1, mu2 = xs.reshape(-1, D).mean(0), ys.reshape(-1, D).mean(0)
    star = fields["beta_star"]
    assert float(classifier.f1_score(_t(beta), _t(star))) == pytest.approx(
        float(jax_classifier.f1_score(jnp.asarray(beta), jnp.asarray(star))), abs=1e-7)
    assert float(classifier.misclassification_rate(_t(z), _t(labels), _t(beta), _t(mu1),
                                                   _t(mu2))) == pytest.approx(
        float(jax_classifier.misclassification_rate(jnp.asarray(z), jnp.asarray(labels),
                                                    jnp.asarray(beta), jnp.asarray(mu1),
                                                    jnp.asarray(mu2))), abs=1e-7)
    want = jax_classifier.estimation_errors(jnp.asarray(beta), jnp.asarray(star))
    got = classifier.estimation_errors(_t(beta), _t(star))
    for key in want:
        assert float(got[key]) == pytest.approx(float(want[key]), rel=1e-6)


@pytest.mark.parametrize("kw", [dict(rounds=0), dict(staleness=-1), dict(comm="plan")])
def test_later_slice_options_raise(kw, monkeypatch):
    # rounds, every comms option and the model-axis worker are ported
    # (tests/test_torch_rounds.py, tests/test_torch_mesh.py); what stays
    # refused is a value the reference refuses too, and it is refused
    # before any solve, as the reference's jitted faces refuse it at trace
    # time; the model axis with symmetrize=True is refused as in the
    # reference (the shards cannot pair theta_ij with theta_ji)
    _, xs, ys, _, _ = _draws()

    def no_solve(*args, **kwargs):
        raise AssertionError("a solve ran before the arguments were checked")

    monkeypatch.setattr(pipeline, "solves_from_stats", no_solve)
    with pytest.raises((ValueError, TypeError)):
        simulated_distributed_slda(_t(xs), _t(ys), 0.2, 0.2, 0.05, **kw)
    with pytest.raises(ValueError, match="symmetrize"):
        pipeline.worker_solves(pipeline.BinaryHead(), _t(xs), _t(ys), lam=0.2, lam_prime=0.2,
                               model_axis="model", symmetrize=True)


def test_quickstart_main_runs_on_cpu(capsys):
    cfg = interop.dantzig_config_from_dict(JaxDantzigConfig(max_iters=100)._asdict())
    rows = quickstart.main(device="cpu", d=24, m=2, n_per_machine=80, cfg=cfg, n_test=200)
    assert list(rows) == list(quickstart.METHODS)
    assert all(np.isfinite(v).all() and 0 <= v[0] <= 1 and 0 <= v[3] <= 1
               for v in map(np.asarray, rows.values()))
    assert "distributed (paper)" in capsys.readouterr().out


@pytest.mark.parametrize("d,block,rho", [(25, 10, 0.5), (30, 7, 0.3), (8, 10, 0.9)])
def test_block_covariance_equals_reference(d, block, rho):
    np.testing.assert_array_equal(synthetic.block_covariance(d, block, rho),
                                  jax_synthetic.block_covariance(d, block, rho))


def test_block_design_problem_equals_reference_bit_for_bit():
    ref = jax_synthetic.make_problem(d=D, n_signal=6, rho=0.8, design="block")
    port = synthetic.make_problem(d=D, n_signal=6, rho=0.8, design="block", device="cpu")
    for name in ref._fields:
        np.testing.assert_array_equal(getattr(port, name).numpy(), np.asarray(getattr(ref, name)))
    assert not np.array_equal(port.sigma.numpy(), synthetic.make_problem(
        d=D, n_signal=6, rho=0.8, device="cpu").sigma.numpy())
    with pytest.raises(ValueError, match="design"):
        synthetic.make_problem(d=D, design="toeplitz", device="cpu")


def test_heart_disease_surrogate_matches_reference_on_its_draws():
    # the reference's own draws, taken from its key as it takes them,
    # go through the port's assembly; the port's sampler draws the same
    # kinds on a torch.Generator
    import jax

    n, d, n_sites = 300, 22, 4
    key = jax.random.PRNGKey(3)
    want_z, want_labels, want_sites = jax_synthetic.heart_disease_surrogate(key, n, d, n_sites)
    kp, ks, kz = jax.random.split(key, 3)
    kl, kn = jax.random.split(kz)
    labels = np.asarray(jax.random.bernoulli(kl, 0.5, (n,)).astype(jnp.int32))
    noise = np.asarray(jax.random.normal(kn, (n, d)))
    sites = np.asarray(jax.random.randint(ks, (n,), 0, n_sites))
    shift = np.asarray(0.15 * jax.random.normal(kp, (n_sites, d)))
    np.testing.assert_array_equal(labels, np.asarray(want_labels))
    np.testing.assert_array_equal(sites, np.asarray(want_sites))
    problem = synthetic.make_problem(d=d, n_signal=6, rho=0.85, signal=0.8, device="cpu")
    z = synthetic.surrogate_from_draws(problem, _t(labels, torch.int32), _t(noise),
                                       _t(sites, torch.int64), _t(shift))
    want_z = np.asarray(want_z)
    np.testing.assert_allclose(z.numpy(), want_z, rtol=0, atol=1e-6 * np.abs(want_z).max())

    z, labels, sites = synthetic.heart_disease_surrogate(torch.Generator().manual_seed(0), n, d,
                                                         n_sites, device="cpu")
    again = synthetic.heart_disease_surrogate(torch.Generator().manual_seed(0), n, d, n_sites,
                                              device="cpu")
    assert z.shape == (n, d) and z.dtype == torch.float32 and torch.equal(z, again[0])
    assert set(labels.tolist()) == {0, 1} and set(sites.tolist()) == set(range(n_sites))
