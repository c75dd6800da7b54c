"""The port's multiclass family against the JAX reference, on shared draws.

The K-class samples are drawn once with numpy and handed to both
packages.  The reference's fused paths run its Pallas kernels in
interpret mode, as its own tests do; the port's run the kernels' plain
versions on the CPU.  Solutions are held within 1e-5 of the reference's
largest entry, or twice the reference's own spread when its Sigma_hat
moves by one ulp (``tests/test_torch_parity.py``); the tol-gated lambda
path pins ``block_k`` in both packages and holds every block's count.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import classifier as jax_classifier
from repro.core import multiclass as jax_mc
from repro.core import path as jax_path
from repro.core import pipeline as jax_pipeline
from repro.core import rounds as jax_rounds
from repro.core import transport as jax_transport
from repro.core.compression import Compression as JaxCompression
from repro.core.dantzig import DantzigConfig as JaxDantzigConfig
from repro.core.slda import hard_threshold as jax_hard_threshold
from repro.stats import synthetic as jax_synthetic
from repro_torch import interop
from repro_torch.core import classifier, multiclass, pipeline
from repro_torch.stats import synthetic
from test_torch_parity import UlpHead, assert_parity, reference_spread

D, K, M, N_PER = 24, 3, 3, 90
LAM = 0.2
LAMS = np.geomspace(0.12, 0.4, 4).astype(np.float32)


def _t(a, dtype=torch.float32):
    return interop.tensor(a, device="cpu", dtype=dtype)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _cfgs(**kw):
    jcfg = JaxDantzigConfig(**kw)
    return jcfg, interop.dantzig_config_from_dict(jcfg._asdict())


def _problem():
    return jax_synthetic.make_mc_problem(d=D, num_classes=K, n_signal=4, rho=0.5)


def _draws(seed=0, m=M, n=N_PER):
    """Shared numpy K-class draws: xs (m, n, d), labels (m, n) int32."""
    fields = {k: np.asarray(v) for k, v in _problem()._asdict().items()}
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, K, (m, n)).astype(np.int32)
    noise = rng.standard_normal((m, n, D)) @ fields["chol"].T
    xs = (fields["means"][labels] + noise).astype(np.float32)
    return fields, xs, labels


def test_make_mc_problem_equals_reference_bit_for_bit():
    ref = _problem()
    port = synthetic.make_mc_problem(d=D, num_classes=K, n_signal=4, rho=0.5, device="cpu")
    for name in ref._fields:
        np.testing.assert_array_equal(_np(getattr(port, name)), np.asarray(getattr(ref, name)))
    carried = interop.mc_problem_from_numpy({k: np.asarray(v) for k, v in ref._asdict().items()},
                                            device="cpu")
    assert isinstance(carried, synthetic.MCProblem)
    np.testing.assert_array_equal(_np(carried.betas), np.asarray(ref.betas))


def test_sample_mc_machines_on_a_generator():
    problem = synthetic.make_mc_problem(d=D, num_classes=K, n_signal=4, device="cpu")
    gen = torch.Generator().manual_seed(0)
    xs, labels = synthetic.sample_mc_machines(gen, problem, 4, 3000, device="cpu")
    assert xs.shape == (4, 3000, D) and labels.shape == (4, 3000)
    counts = torch.bincount(labels.flatten(), minlength=K).float() / labels.numel()
    assert (counts - 1 / K).abs().max() < 0.02
    # the class means come back, and an imbalanced draw follows class_probs
    for k in range(K):
        mean = xs[labels == k].mean(0)
        assert (mean - problem.means[k]).abs().max() < 0.1
    probs = [0.6, 0.3, 0.1]
    _, skewed = synthetic.sample_mc_machines(gen, problem, 2, 5000, class_probs=probs,
                                             device="cpu")
    freq = torch.bincount(skewed.flatten(), minlength=K).float() / skewed.numel()
    assert (freq - torch.tensor(probs)).abs().max() < 0.02
    again = synthetic.sample_mc_machines(torch.Generator().manual_seed(0), problem, 4, 3000,
                                         device="cpu")
    assert torch.equal(again[0], xs) and torch.equal(again[1], labels)


def test_mc_suff_stats_and_rhs_match_reference():
    _, xs, labels = _draws()
    stats = pipeline.mc_suff_stats(_t(xs), _t(labels, torch.int32), K)
    rhs = pipeline.mc_direction_rhs(stats)
    assert stats.sigma.shape == (M, D, D) and stats.means.shape == (M, K, D)
    assert rhs.shape == (M, D, K)
    for i in range(M):
        want = jax_pipeline.mc_suff_stats(jnp.asarray(xs[i]), jnp.asarray(labels[i]), K)
        np.testing.assert_array_equal(_np(stats.counts[i]), np.asarray(want.counts))
        assert_parity(stats.sigma[i], want.sigma)
        assert_parity(stats.means[i], want.means)
        assert_parity(rhs[i], jax_pipeline.mc_direction_rhs(want))
    hs = pipeline.MulticlassHead(K).stats(_t(xs), _t(labels, torch.int32))
    torch.testing.assert_close(hs.rhs, rhs, rtol=0, atol=0)


@pytest.mark.parametrize("priors", [None, (0.5, 0.3, 0.2)], ids=["equal", "priors"])
def test_classify_scores_match_reference(priors):
    rng = np.random.default_rng(4)
    z = rng.standard_normal((50, D)).astype(np.float32)
    beta = (rng.standard_normal((D, K)) * (rng.random((D, K)) < 0.3)).astype(np.float32)
    means = rng.standard_normal((K, D)).astype(np.float32)
    jp = None if priors is None else jnp.asarray(priors)
    want = jax_classifier.classify_scores(jnp.asarray(z), jnp.asarray(beta), jnp.asarray(means),
                                          jp)
    got = classifier.classify_scores(_t(z), _t(beta), _t(means), priors)
    assert_parity(got, want)
    np.testing.assert_array_equal(_np(multiclass.mc_classify(_t(z), _t(beta), _t(means), priors)),
                                  np.asarray(jax_mc.mc_classify(jnp.asarray(z), jnp.asarray(beta),
                                                                jnp.asarray(means), jp)))


def _mc_spread(run, want):
    """The reference's own spread on these draws: ``run(head)`` with Sigma_hat moved one ulp."""
    return reference_spread(lambda s: run(UlpHead(jax_pipeline.MulticlassHead(K), s)), want)


@pytest.mark.parametrize("fused", [False, True], ids=["scan", "fused"])
def test_mc_debiased_local_matches_reference(fused):
    _, xs, labels = _draws(1)
    jcfg, cfg = _cfgs(max_iters=150, adapt_rho=False, fused=fused)
    beta_tilde, stats = multiclass.mc_debiased_local(_t(xs), _t(labels, torch.int32), K, LAM,
                                                     cfg=cfg)
    assert beta_tilde.shape == (M, D, K) and stats.means.shape == (M, K, D)
    for i in range(M):
        x, lab = jnp.asarray(xs[i]), jnp.asarray(labels[i])
        want, _ = jax_mc.mc_debiased_local(x, lab, K, LAM, cfg=jcfg)
        spread = _mc_spread(lambda head: jax_pipeline.worker_debiased(
            head, x, lab, lam=LAM, lam_prime=LAM, cfg=jcfg)[0], want)
        assert_parity(beta_tilde[i], want, spread)
    # the pieces agree: the local estimate debiased with one CLIME solve
    from repro_torch.core.clime import solve_clime

    theta = solve_clime(stats.sigma, LAM, cfg)
    beta_hat = multiclass.local_mc_slda(stats, LAM, cfg)
    torch.testing.assert_close(multiclass.mc_debias(stats, beta_hat, theta), beta_tilde,
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("fused", [False, True], ids=["scan", "fused"])
def test_estimators_match_reference(fused):
    # distributed (raw mean, t = 0, and hard-thresholded), naive and
    # centralized, the class means beside each
    fields, xs, labels = _draws(2)
    jcfg, cfg = _cfgs(max_iters=150, adapt_rho=False, fused=fused)
    jx, jl = jnp.asarray(xs), jnp.asarray(labels)
    x, lab = _t(xs), _t(labels, torch.int32)

    raw, means = multiclass.simulated_distributed_mc_slda(x, lab, K, LAM, LAM, 0.0, cfg)
    jraw, jmeans = jax_mc.simulated_distributed_mc_slda(jx, jl, K, LAM, LAM, 0.0, jcfg)
    assert raw.shape == (D, K) and means.shape == (K, D)
    spread = _mc_spread(lambda head: jax_rounds.simulate_multi_round(
        head, (jx, jl), lam=LAM, lam_prime=LAM, cfg=jcfg)[0], jraw)
    assert_parity(raw, jraw, spread)
    assert_parity(means, jmeans)
    t = 0.3 * float(np.abs(np.asarray(jraw)).max())
    ht, _ = multiclass.simulated_distributed_mc_slda(x, lab, K, LAM, LAM, t, cfg)
    np.testing.assert_array_equal(_np(ht) != 0, np.asarray(jax_hard_threshold(jraw, t)) != 0)

    naive, nmeans = multiclass.simulated_naive_mc_slda(x, lab, K, LAM, cfg)
    jnaive, jnmeans = jax_mc.simulated_naive_mc_slda(jx, jl, K, LAM, jcfg)
    spread = _mc_spread(lambda head: jnp.mean(jax_rounds.simulate_multi_round(
        head, (jx, jl), lam=LAM, lam_prime=LAM, cfg=jcfg)[1].beta_hat, axis=0), jnaive)
    assert_parity(naive, jnaive, spread)
    assert_parity(nmeans, jnmeans)

    cent, cmeans = multiclass.centralized_mc_slda(x.reshape(-1, D), lab.reshape(-1), K, LAM / 2,
                                                  cfg)
    jcent, jcmeans = jax_mc.centralized_mc_slda(jx.reshape(-1, D), jl.reshape(-1), K, LAM / 2,
                                                jcfg)
    spread = _mc_spread(lambda head: jax_pipeline.worker_solves(
        head, jx.reshape(-1, D), jl.reshape(-1), lam=LAM / 2, lam_prime=LAM / 2,
        cfg=jcfg).beta_hat, jcent)
    assert_parity(cent, jcent, spread)
    assert_parity(cmeans, jcmeans)
    # accuracy on a held-out draw, and F1 against the true directions
    _, zs, zl = _draws(3, m=1, n=400)
    for beta, jbeta, mu, jmu in ((raw, jraw, means, jmeans), (naive, jnaive, nmeans, jnmeans),
                                 (cent, jcent, cmeans, jcmeans)):
        pred = multiclass.mc_classify(_t(zs[0]), beta, mu)
        jpred = jax_mc.mc_classify(jnp.asarray(zs[0]), jbeta, jmu)
        assert (float((pred == _t(zl[0], torch.int64)).float().mean())
                == float(jnp.mean(jpred == jnp.asarray(zl[0]))))
        assert float(classifier.f1_score(beta, _t(fields["betas"]))) == pytest.approx(
            float(jax_classifier.f1_score(jbeta, jnp.asarray(fields["betas"]))), abs=1e-7)


def test_mc_rounds_and_compression_match_reference():
    # three refinement rounds with the identity codec on the uplink: the
    # K-class face through the shared rounds core
    _, xs, labels = _draws(4)
    jcfg, cfg = _cfgs(max_iters=120, adapt_rho=False)
    jx, jl = jnp.asarray(xs), jnp.asarray(labels)
    jcomm = jax_transport.CommPlan(uplink=JaxCompression(D))
    jbar, jmeans = jax_mc.mc_multi_round_slda(jx, jl, K, LAM, LAM, 0.0, comm=jcomm, cfg=jcfg)
    bar, means = multiclass.mc_multi_round_slda(
        _t(xs), _t(labels, torch.int32), K, LAM, LAM, 0.0, cfg=cfg,
        comm=interop.comm_plan_from_dict(jcomm._asdict()))
    spread = _mc_spread(lambda head: jax_rounds.simulate_multi_round(
        head, (jx, jl), lam=LAM, lam_prime=LAM, rounds=3, cfg=jcfg, comm=jcomm)[0], jbar)
    assert_parity(bar, jbar, spread)
    assert_parity(means, jmeans)
    dense, _ = multiclass.mc_multi_round_slda(_t(xs), _t(labels, torch.int32), K, LAM, LAM, 0.0,
                                              cfg=cfg)
    assert torch.equal(dense, bar)  # the identity codec is the dense round bit for bit


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_mc_debiased_local_path_matches_reference(warm):
    # K * L = 12 direction columns fold into blocks of 5, 5 and 2, each gated
    # on its own at tol 1e-2; lam_prime is the grid's middle
    _, xs, labels = _draws(5, n=200)
    jcfg, cfg = _cfgs(max_iters=200, adapt_rho=False, tol=1e-2, fused=True, block_k=5)
    res = multiclass.mc_debiased_local_path(_t(xs), _t(labels, torch.int32), K, _t(LAMS),
                                            cfg=cfg)
    if warm:
        res = multiclass.mc_debiased_local_path(_t(xs), _t(labels, torch.int32), K, _t(LAMS),
                                                cfg=cfg, rho_beta=res.rho_beta,
                                                state_beta=res.state_beta)
    assert res.beta_tilde.shape == (M, 4, D, K) and res.iters.shape == (M, 4, K)
    for i in range(M):
        x, lab = jnp.asarray(xs[i]), jnp.asarray(labels[i])

        def reference(head, carries=None):
            return jax_path.worker_debiased_path(head, x, lab, lams=jnp.asarray(LAMS),
                                                 lam_prime=jnp.asarray(LAMS)[2], cfg=jcfg,
                                                 **(carries or {}))

        want = jax_mc.mc_debiased_local_path(x, lab, K, jnp.asarray(LAMS), cfg=jcfg)
        carries = None
        if warm:
            carries = dict(rho_beta=want.rho_beta, state_beta=want.state_beta)
            want = jax_mc.mc_debiased_local_path(x, lab, K, jnp.asarray(LAMS), cfg=jcfg,
                                                 **carries)
        np.testing.assert_array_equal(_np(res.iters[i]), np.asarray(want.iters))
        np.testing.assert_array_equal(_np(res.rho_beta[i]), np.asarray(want.rho_beta))
        spread = _mc_spread(lambda head: reference(head, carries).beta_tilde, want.beta_tilde)
        assert_parity(res.beta_tilde[i], want.beta_tilde, spread)
        np.testing.assert_allclose(_np(res.kkt[i]), np.asarray(want.kkt), rtol=1e-4, atol=1e-5)
    assert int(res.iters.max()) < 200


def test_mc_path_warm_sweep_runs_fewer_iterations_and_factorizes_once(monkeypatch):
    _, xs, labels = _draws(6, n=200)
    calls = []
    eigh = torch.linalg.eigh

    def counting(a, *args, **kw):
        calls.append(tuple(a.shape))
        return eigh(a, *args, **kw)

    monkeypatch.setattr(torch.linalg, "eigh", counting)
    _, cfg = _cfgs(max_iters=200, adapt_rho=False, tol=1e-2, fused=True)
    cold = multiclass.mc_debiased_local_path(_t(xs), _t(labels, torch.int32), K, _t(LAMS),
                                             cfg=cfg)
    assert calls == [(M, D, D)]
    warm = multiclass.mc_debiased_local_path(_t(xs), _t(labels, torch.int32), K, _t(LAMS),
                                             cfg=cfg, rho_beta=cold.rho_beta,
                                             state_beta=cold.state_beta)
    assert int(warm.iters.sum()) < int(cold.iters.sum())
    calls.clear()
    multiclass.simulated_distributed_mc_slda(_t(xs), _t(labels, torch.int32), K, LAM, LAM, 0.05,
                                             cfg._replace(tol=None, max_iters=30))
    assert calls == [(M, D, D)]
