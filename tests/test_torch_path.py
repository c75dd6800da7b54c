"""The port's lambda path (folded sweeps, warm re-sweeps, selection) against the JAX reference.

Inputs are made once with numpy from a seed and handed to both
packages.  The reference's fused paths run its Pallas state kernel in
interpret mode, as its own tests do; the port's run the state kernel's
plain version on the CPU.  Both packages pin the same ``block_k``: with
``tol`` set the gate is per column block, so the blocking is part of
the result.  The reference has no machine axis, so machine batches of
the port are held against one reference call per machine.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import path as jax_path
from repro.core import slda as jax_slda
from repro.core.dantzig import DantzigConfig as JaxDantzigConfig
from repro.core.pipeline import BinaryHead as JaxBinaryHead
from repro.kernels.dantzig_fused import AdmmState as JaxAdmmState
from repro.stats import synthetic as jax_synthetic
from repro.stats.synthetic import ar1_covariance
from repro_torch import interop
from repro_torch.core import path, pipeline, slda
from repro_torch.core.solver_dispatch import solve_dantzig
from repro_torch.kernels.dantzig_fused import AdmmState
from test_torch_parity import UlpHead, assert_parity, reference_spread

D, M, N_PER = 24, 3, 200
LAMS = np.geomspace(0.1, 0.4, 4).astype(np.float32)


def _t(a):
    return interop.tensor(a, device="cpu")


def _cfgs(**kw):
    jcfg = JaxDantzigConfig(**kw)
    return jcfg, interop.dantzig_config_from_dict(jcfg._asdict())


def _close(got, want, pin=1e-5):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got - want).max() <= pin * max(np.abs(want).max(), 1e-30)


def _sigma(seed=0, d=D):
    rng = np.random.default_rng(seed)
    chol = np.linalg.cholesky(ar1_covariance(d, 0.3))
    x = (rng.standard_normal((400, d)) @ chol.T).astype(np.float32)
    xc = x - x.mean(0)
    return (xc.T @ xc / 400).astype(np.float32)


def _draws(seed=0, n_val=300):
    """Shared numpy draws of the §5.1 design at d = 24, AR(0.5): machines and a validation set."""
    problem = jax_synthetic.make_problem(d=D, n_signal=4, rho=0.5)
    fields = {k: np.asarray(v) for k, v in problem._asdict().items()}
    rng = np.random.default_rng(seed)
    chol = fields["chol"]
    xs = (fields["mu1"] + rng.standard_normal((M, N_PER // 2, D)) @ chol.T).astype(np.float32)
    ys = (fields["mu2"] + rng.standard_normal((M, N_PER // 2, D)) @ chol.T).astype(np.float32)
    labels = (rng.random(n_val) < 0.5).astype(np.int32)
    z = np.where(labels[:, None] == 0, fields["mu1"], fields["mu2"])
    z = (z + rng.standard_normal((n_val, D)) @ chol.T).astype(np.float32)
    return xs, ys, z, labels


def _compare_path(got, want):
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(want.iters))
    _close(got.beta, want.beta)
    np.testing.assert_allclose(got.kkt.numpy(), np.asarray(want.kkt), rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(got.rho.numpy(), np.asarray(want.rho))
    np.testing.assert_array_equal(got.lam.numpy(), np.asarray(want.lam))
    for g, w in zip(got.state, want.state):
        _close(g, w)


PATHS = [("scan", None), ("fused", None), ("fused_blocked", 3)]


@pytest.mark.parametrize("kind,block_k", PATHS, ids=[p[0] for p in PATHS])
@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_solve_dantzig_path_matches_reference(kind, block_k, warm):
    # L = 4 grid points over k = 2 columns fold into 8 columns: fused runs
    # them in one block, fused_blocked in blocks of 3, 3 and 2.  The warm
    # sweep resumes from the cold sweep's states and penalties
    sigma = _sigma()
    b = np.eye(D, dtype=np.float32)[:, [2, 9]]
    jcfg, cfg = _cfgs(max_iters=200, adapt_rho=False, tol=1e-3, fused=kind != "scan",
                      block_k=block_k)
    want = jax_path.solve_dantzig_path(jnp.asarray(sigma), jnp.asarray(b), jnp.asarray(LAMS),
                                       jcfg, backend="cpu")
    got = path.solve_dantzig_path(_t(sigma), _t(b), _t(LAMS), cfg)
    if warm:
        state = AdmmState(*(_t(v) for v in want.state))
        want = jax_path.solve_dantzig_path(jnp.asarray(sigma), jnp.asarray(b),
                                           jnp.asarray(LAMS), jcfg, rho=want.rho,
                                           state=want.state, backend="cpu")
        got = path.solve_dantzig_path(_t(sigma), _t(b), _t(LAMS), cfg, rho=got.rho,
                                      state=state)
    assert got.beta.shape == (4, D, 2) and got.iters.shape == (4, 2)
    _compare_path(got, want)
    assert got.iters.max() < 200


def test_path_fold_equals_single_solves_at_tol_none():
    # columns never interact: grid point l of the folded sweep is the
    # single solve at lams[l] (the card holds this bit for bit)
    sigma = _sigma(1)
    b = np.eye(D, dtype=np.float32)[:, :3]
    _, cfg = _cfgs(max_iters=150, adapt_rho=False, fused=True)
    swept = path.solve_dantzig_path(_t(sigma), _t(b), _t(LAMS), cfg)
    for i, lam in enumerate(LAMS):
        one = solve_dantzig(_t(sigma), _t(b), float(lam), cfg)
        _close(swept.beta[i], one.numpy(), pin=1e-6)
    np.testing.assert_array_equal(swept.iters.numpy(), np.full((4, 3), 150))


def test_path_vector_rhs_from_a_single_solve_state_matches_reference():
    # a (d,) vector right-hand side, warm-started from one single solve's
    # (d,) state broadcast to every grid point
    sigma = _sigma(2)
    b = np.r_[np.ones(4), np.zeros(D - 4)].astype(np.float32)
    jcfg, cfg = _cfgs(max_iters=200, adapt_rho=False, tol=1e-3, fused=True)
    from repro.core.solver_dispatch import solve_dantzig_full as jax_solve_dantzig_full

    single = jax_solve_dantzig_full(jnp.asarray(sigma), jnp.asarray(b), 0.2,
                                    jcfg._replace(tol=None, max_iters=40))
    want = jax_path.solve_dantzig_path(jnp.asarray(sigma), jnp.asarray(b), jnp.asarray(LAMS),
                                       jcfg, state=single.state)
    got = path.solve_dantzig_path(
        _t(sigma), _t(b), _t(LAMS), cfg,
        state=AdmmState(*(_t(v) for v in single.state)))
    assert got.beta.shape == (4, D) and got.kkt.shape == (4,) and got.iters.shape == (4,)
    assert got.rho.shape == (4, 1)
    _compare_path(got, want)


def test_path_machine_batch_equals_each_machine_alone():
    sigmas = np.stack([_sigma(s) for s in (3, 4, 5)])
    b = np.eye(D, dtype=np.float32)[:, :2]
    _, cfg = _cfgs(max_iters=200, adapt_rho=False, tol=1e-3, fused=True, block_k=3)
    batched = path.solve_dantzig_path(_t(sigmas), _t(b).expand(3, D, 2), _t(LAMS), cfg)
    assert batched.beta.shape == (3, 4, D, 2) and batched.iters.shape == (3, 4, 2)
    for i in range(3):
        one = path.solve_dantzig_path(_t(sigmas[i]), _t(b), _t(LAMS), cfg)
        torch.testing.assert_close(batched.iters[i], one.iters, rtol=0, atol=0)
        torch.testing.assert_close(batched.beta[i], one.beta, rtol=0, atol=1e-6)


def test_state_layout_ambiguity_raises_like_reference():
    # at L == d == k a 2-D leaf reads both as a (d, k) single solve and as
    # an (L, d) vector sweep: "auto" raises, an explicit layout decides
    d = L = k = 4
    sigma = _sigma(6, d=d)
    b = np.eye(d, dtype=np.float32)
    lams = np.linspace(0.1, 0.4, L).astype(np.float32)
    leaf = np.full((d, k), 0.01, np.float32)
    jcfg, cfg = _cfgs(max_iters=20, adapt_rho=False)
    with pytest.raises(ValueError, match="ambiguous"):
        jax_path.solve_dantzig_path(jnp.asarray(sigma), jnp.asarray(b), jnp.asarray(lams), jcfg,
                                    state=JaxAdmmState(*(jnp.asarray(leaf),) * 4))
    with pytest.raises(ValueError, match="ambiguous"):
        path.solve_dantzig_path(_t(sigma), _t(b), _t(lams), cfg,
                                state=AdmmState(*(_t(leaf),) * 4))
    for layout in ("single", "grid"):
        want = jax_path.solve_dantzig_path(jnp.asarray(sigma), jnp.asarray(b), jnp.asarray(lams),
                                           jcfg, state=JaxAdmmState(*(jnp.asarray(leaf),) * 4),
                                           state_layout=layout)
        got = path.solve_dantzig_path(_t(sigma), _t(b), _t(lams), cfg,
                                      state=AdmmState(*(_t(leaf),) * 4), state_layout=layout)
        _close(got.beta, want.beta)
    with pytest.raises(ValueError, match="state_layout"):
        path.solve_dantzig_path(_t(sigma), _t(b), _t(lams), cfg,
                                state=AdmmState(*(_t(leaf),) * 4), state_layout="wide")
    with pytest.raises(ValueError, match="matches neither"):
        path.solve_dantzig_path(_t(sigma), _t(b), _t(lams), cfg,
                                state=AdmmState(*(torch.zeros(2, d, k),) * 4))


def test_rho_ambiguity_raises_at_l_equal_k_like_reference():
    sigma = _sigma(7)
    b = np.eye(D, dtype=np.float32)[:, :4]
    rho = np.linspace(0.5, 2.0, 4).astype(np.float32)
    jcfg, cfg = _cfgs(max_iters=30, adapt_rho=False, fused=True)
    for solve, mk in ((jax_path.solve_dantzig_path, jnp.asarray),
                      (path.solve_dantzig_path, _t)):
        with pytest.raises(ValueError, match="ambiguous"):
            solve(mk(sigma), mk(b), mk(LAMS), jcfg if mk is jnp.asarray else cfg, rho=mk(rho))
    # the explicit 2-D broadcasts are per-lambda and per-column penalties
    for r in (rho[:, None], rho[None, :]):
        want = jax_path.solve_dantzig_path(jnp.asarray(sigma), jnp.asarray(b), jnp.asarray(LAMS),
                                           jcfg, rho=jnp.asarray(r))
        got = path.solve_dantzig_path(_t(sigma), _t(b), _t(LAMS), cfg, rho=_t(r))
        np.testing.assert_array_equal(got.rho.numpy(), np.asarray(want.rho))
        _close(got.beta, want.beta)


def test_seed_path_state_matches_reference():
    rng = np.random.default_rng(8)
    leaves = [rng.standard_normal((4, D, 2)).astype(np.float32) for _ in range(4)]
    to = np.array([0.09, 0.2, 0.25, 0.5, 0.13], np.float32)
    want = jax_path.seed_path_state(JaxAdmmState(*map(jnp.asarray, leaves)), jnp.asarray(LAMS),
                                    jnp.asarray(to))
    got = path.seed_path_state(AdmmState(*map(_t, leaves)), _t(LAMS), _t(to))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # machines lead: every machine's leaves are re-mapped alike
    batched = path.seed_path_state(AdmmState(*(_t(v).expand(3, 4, D, 2) for v in leaves)),
                                   _t(LAMS), _t(to))
    assert batched.z.shape == (3, 5, D, 2)
    torch.testing.assert_close(batched.z[2], got.z, rtol=0, atol=0)


@pytest.mark.parametrize("fused", [False, True], ids=["scan", "fused"])
def test_worker_debiased_path_matches_reference(fused):
    # cold sweep, then the warm re-sweep from its carries; every machine
    # against one reference call.  Under the fused config the direction
    # fold (4 columns) runs in blocks of 3 and 1
    xs, ys, _, _ = _draws()
    jcfg, cfg = _cfgs(max_iters=200, adapt_rho=False, tol=1e-3, fused=fused,
                      block_k=3 if fused else None)
    cold = path.worker_debiased_path(pipeline.BinaryHead(), _t(xs), _t(ys), lams=_t(LAMS),
                                     lam_prime=0.2, cfg=cfg)
    warm = path.worker_debiased_path(pipeline.BinaryHead(), _t(xs), _t(ys), lams=_t(LAMS),
                                     lam_prime=0.2, cfg=cfg, rho_beta=cold.rho_beta,
                                     state_beta=cold.state_beta)
    assert cold.beta_tilde.shape == (M, 4, D, 1) and cold.iters.shape == (M, 4, 1)
    for i in range(M):
        jcold = jax_path.worker_debiased_path(JaxBinaryHead(), jnp.asarray(xs[i]),
                                              jnp.asarray(ys[i]), lams=jnp.asarray(LAMS),
                                              lam_prime=0.2, cfg=jcfg)
        jwarm = jax_path.worker_debiased_path(JaxBinaryHead(), jnp.asarray(xs[i]),
                                              jnp.asarray(ys[i]), lams=jnp.asarray(LAMS),
                                              lam_prime=0.2, cfg=jcfg, rho_beta=jcold.rho_beta,
                                              state_beta=jcold.state_beta)
        for got, want in ((cold, jcold), (warm, jwarm)):
            np.testing.assert_array_equal(got.iters[i].numpy(), np.asarray(want.iters))
            _close(got.beta_tilde[i], want.beta_tilde)
            _close(got.beta_hat[i], want.beta_hat)
            np.testing.assert_allclose(got.kkt[i].numpy(), np.asarray(want.kkt), rtol=1e-4,
                                       atol=1e-5)
            np.testing.assert_array_equal(got.rho_beta[i].numpy(), np.asarray(want.rho_beta))
    assert int(warm.iters.sum()) < int(cold.iters.sum())


def test_worker_debiased_path_factorizes_once(monkeypatch):
    xs, ys, _, _ = _draws(seed=1)
    calls = []
    eigh = torch.linalg.eigh

    def counting(a, *args, **kw):
        calls.append(tuple(a.shape))
        return eigh(a, *args, **kw)

    monkeypatch.setattr(torch.linalg, "eigh", counting)
    _, cfg = _cfgs(max_iters=20, adapt_rho=False, tol=1e-3, fused=True)
    path.worker_debiased_path(pipeline.BinaryHead(), _t(xs), _t(ys), lams=_t(LAMS),
                              lam_prime=0.2, cfg=cfg)
    assert calls == [(M, D, D)]


def test_selection_matches_reference_per_machine():
    # debiased_local_estimator_path (lam_prime from the grid's middle),
    # then one index per machine from the validation rule and the KKT rule
    xs, ys, z, labels = _draws(seed=2)
    jcfg, cfg = _cfgs(max_iters=200, adapt_rho=False, tol=1e-3, fused=True, block_k=3)
    res = slda.debiased_local_estimator_path(_t(xs), _t(ys), _t(LAMS), cfg=cfg)
    idx, errors = slda.tune_lambda_validation(res, _t(z), _t(labels))
    kkt_idx = path.select_by_kkt(res, tol=1e-3)
    assert idx.shape == kkt_idx.shape == (M,) and errors.shape == (M, 4)
    for i in range(M):
        jres = jax_slda.debiased_local_estimator_path(jnp.asarray(xs[i]), jnp.asarray(ys[i]),
                                                      jnp.asarray(LAMS), cfg=jcfg)
        np.testing.assert_array_equal(res.iters[i].numpy(), np.asarray(jres.iters))
        # the pin: 1e-5 of the largest entry, or twice the reference's own
        # spread when its Sigma_hat moves by one ulp (lam_prime: the grid's middle)
        spread = reference_spread(lambda s: jax_path.worker_debiased_path(
            UlpHead(JaxBinaryHead(), s), jnp.asarray(xs[i]), jnp.asarray(ys[i]),
            lams=jnp.asarray(LAMS), lam_prime=jnp.asarray(LAMS)[len(LAMS) // 2],
            cfg=jcfg).beta_tilde, jres.beta_tilde)
        assert_parity(res.beta_tilde[i], jres.beta_tilde, spread)
        jidx, jerrors = jax_slda.tune_lambda_validation(jres, jnp.asarray(z),
                                                        jnp.asarray(labels))
        np.testing.assert_allclose(errors[i].numpy(), np.asarray(jerrors), atol=1e-7)
        assert int(idx[i]) == int(jidx)
        assert int(kkt_idx[i]) == int(jax_path.select_by_kkt(jres, tol=1e-3))
        want = jax_path.take_lambda(jres.beta_tilde, jidx)
        assert_parity(path.take_lambda(res.beta_tilde, idx)[i], want, spread)


@pytest.mark.parametrize("tol", [0.0, 1e-3, 1.0])
def test_select_by_kkt_rule_matches_reference(tol):
    # feasible grid points: the smallest lambda; none: the smallest violation
    rng = np.random.default_rng(9)
    kkt = np.abs(rng.standard_normal((M, 4, 2))).astype(np.float32) * 2e-3
    kkt[1, 2] = 0.0
    beta = np.zeros((M, 4, D, 2), np.float32)
    for i in range(M):
        want = jax_path.select_by_kkt(jax_path.PathResult(
            jnp.asarray(beta[i]), jnp.asarray(LAMS), jnp.asarray(kkt[i]), None, None, None), tol)
        got = path.select_by_kkt(path.PathResult(_t(beta), _t(LAMS), _t(kkt), None, None, None),
                                 tol)
        assert int(got[i]) == int(want)


def test_select_by_validation_and_take_lambda():
    rng = np.random.default_rng(10)
    betas = rng.standard_normal((4, 5)).astype(np.float32)

    def score(beta):
        return -jnp.abs(beta - 0.3).sum()

    jidx, jscores = jax_path.select_by_validation(jnp.asarray(betas), score)
    idx, scores = path.select_by_validation(_t(betas), lambda b: -(b - 0.3).abs().sum())
    assert int(idx) == int(jidx)
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores), rtol=1e-6)
    # one index per machine along a lambda axis after the machines
    per = _t(rng.standard_normal((M, 4, D, 1)).astype(np.float32))
    idx, scores = path.select_by_validation(per.movedim(1, 0), lambda b: b.sum((-2, -1)))
    assert idx.shape == (M,) and scores.shape == (M, 4)
    picked = path.take_lambda(per, idx)
    for i in range(M):
        torch.testing.assert_close(picked[i], per[i, int(idx[i])], rtol=0, atol=0)
    torch.testing.assert_close(path.take_lambda(per[0], 2), per[0, 2], rtol=0, atol=0)


def test_interop_carries_a_reference_path_result_across():
    sigma = _sigma(11)
    b = np.eye(D, dtype=np.float32)[:, :2]
    jcfg, cfg = _cfgs(max_iters=60, adapt_rho=False, tol=1e-3, fused=True)
    want = jax_path.solve_dantzig_path(jnp.asarray(sigma), jnp.asarray(b), jnp.asarray(LAMS),
                                       jcfg)
    carried = interop.path_result_from_numpy(
        {k: (v._asdict() if k == "state" else v) for k, v in want._asdict().items()},
        device="cpu")
    assert isinstance(carried, path.PathResult) and isinstance(carried.state, AdmmState)
    assert carried.iters.dtype == torch.int32
    np.testing.assert_array_equal(carried.state.u1.numpy(), np.asarray(want.state.u1))
    got = path.solve_dantzig_path(_t(sigma), _t(b), _t(LAMS), cfg, rho=carried.rho,
                                  state=carried.state)
    again = jax_path.solve_dantzig_path(jnp.asarray(sigma), jnp.asarray(b), jnp.asarray(LAMS),
                                        jcfg, rho=want.rho, state=want.state)
    _compare_path(got, again)
