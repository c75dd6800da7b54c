"""The port's kernel modules (K1 gram, K2 fused ADMM, K4 shrink) against the JAX reference.

Inputs are made once with numpy from a seed and handed to both
packages.  The reference runs its Pallas kernels in interpret mode, as
its own kernel tests do; on the CPU the port's wrappers run their plain
PyTorch versions (the kernels themselves run only on the card, where
``chip_smoke.py`` holds each against its plain version).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.dantzig import DantzigConfig as JaxDantzigConfig
from repro.core.solver_dispatch import select_solver as jax_select_solver
from repro.kernels import ref as jax_ref
from repro.kernels.dantzig_fused import dantzig_fused_pallas
from repro.kernels.gram import gram_pallas
from repro.kernels.soft_threshold import soft_threshold_pallas
from repro.stats.synthetic import ar1_covariance
from repro_torch import interop
from repro_torch.core.dantzig import DantzigConfig
from repro_torch.core.solver_dispatch import select_solver
from repro_torch.kernels import dantzig_fused as fused_model
from repro_torch.kernels import ops, ref


def _t(a):
    return interop.tensor(a, device="cpu")


def _sample_cov(d, rho, n, seed):
    """A sample covariance of n AR(rho) draws, and its f32 eigendecomposition."""
    rng = np.random.default_rng(seed)
    chol = np.linalg.cholesky(ar1_covariance(d, rho))
    x = (rng.standard_normal((n, d)) @ chol.T).astype(np.float32)
    xc = x - x.mean(0)
    sigma = (xc.T @ xc / n).astype(np.float32)
    evals, q = np.linalg.eigh(sigma.astype(np.float64))
    return sigma, q.astype(np.float32), evals.astype(np.float32)


# --- K1: gram ---------------------------------------------------------------


@pytest.mark.parametrize("n,d", [(80, 32), (37, 29), (13, 40), (64, 24)])
def test_gram_matches_pallas(n, d):
    # f32 sums run in another order than the Pallas interpreter's, so
    # the pin is 1e-5 relative to the largest entry of G
    rng = np.random.default_rng(n * 100 + d)
    x = rng.standard_normal((n, d)).astype(np.float32) * 2 + 1
    mu = x.mean(0)
    want = np.asarray(gram_pallas(jnp.asarray(x), jnp.asarray(mu), block_n=16, block_d=8,
                                  interpret=True))
    got = ops.gram(_t(x), _t(mu)).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_gram_batches_machines():
    rng = np.random.default_rng(3)
    xs = rng.standard_normal((3, 37, 29)).astype(np.float32)
    mus = xs.mean(1)
    got = ops.gram(_t(xs), _t(mus)).numpy()
    for i in range(3):
        want = np.asarray(gram_pallas(jnp.asarray(xs[i]), jnp.asarray(mus[i]),
                                      block_n=16, block_d=8, interpret=True))
        assert np.abs(got[i] - want).max() <= 1e-5 * np.abs(want).max()


# --- K4: soft threshold -----------------------------------------------------


@pytest.mark.parametrize("shape", [(7,), (4, 36), (40, 33)])
@pytest.mark.parametrize("t", [0.0, 0.05, 1.5])
def test_soft_threshold_scalar_equals_pallas(shape, t):
    x = (np.random.default_rng(42).standard_normal(shape) * 2).astype(np.float32)
    want = np.asarray(soft_threshold_pallas(jnp.asarray(x), t, block_r=8, block_c=16,
                                            interpret=True))
    np.testing.assert_array_equal(ops.soft_threshold(_t(x), t).numpy(), want)


def test_soft_threshold_per_column_equals_ref():
    # the reference's Pallas wrapper cannot take a (1, k) threshold
    # (it reshapes t to (1,)), so the per-column form is held against
    # its plain jnp version, per machine
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 24, 11)).astype(np.float32)
    t = rng.uniform(0.1, 1.0, (3, 1, 11)).astype(np.float32)
    got = ops.soft_threshold(_t(x), _t(t)).numpy()
    for i in range(3):
        want = np.asarray(jax_ref.soft_threshold_ref(jnp.asarray(x[i]), jnp.asarray(t[i])))
        np.testing.assert_array_equal(got[i], want)


# --- K2: fused ADMM ----------------------------------------------------------


def _fused_inputs(rhs):
    """AR(0.8) sample covariance, k = 13 right-hand sides, per-column lam and rho."""
    d, k = 32, 13
    sigma, q, evals = _sample_cov(d, 0.8, 200, seed=1)
    rng = np.random.default_rng(2)
    b = (np.eye(d, dtype=np.float32)[:, :k] if rhs == "unit"
         else (rng.standard_normal((d, k)) * 0.3).astype(np.float32))
    lam = rng.uniform(0.05, 0.2, k).astype(np.float32)
    rho = rng.uniform(0.5, 2.0, k).astype(np.float32)
    inv = (1.0 / (evals * evals + 1.0)).astype(np.float32)
    return sigma, q, evals, inv, b, lam, rho


def _fused_pair(rhs, iters=200):
    """(port, reference Pallas kernel, reference plain oracle) on shared inputs.

    The Pallas call tiles k = 13 into blocks of 8, leaving a tail of 5.
    """
    sigma, q, evals, inv, b, lam, rho = _fused_inputs(rhs)
    args = [jnp.asarray(v) for v in (sigma, q, inv, b, lam)]
    pallas = np.asarray(dantzig_fused_pallas(*args, jnp.asarray(rho), iters=iters,
                                             block_k=8, interpret=True))
    plain = np.asarray(jax_ref.dantzig_fused_ref(*args, iters=iters, rho=jnp.asarray(rho)))
    factor = interop.factor_from_numpy(sigma, q, evals, device="cpu")
    port = ops.dantzig_fused(factor, _t(b), _t(lam), iters=iters, rho=_t(rho)).numpy()
    return port, pallas, plain


def test_dantzig_fused_matches_pallas_on_clime_columns():
    # the CLIME block (unit right-hand sides), 200 iterations: the repo's
    # 1e-5 pin, relative to the solution's largest entry because the
    # products' f32 sums run in another order than the interpreter's
    port, pallas, _ = _fused_pair("unit")
    assert np.abs(port - pallas).max() <= 1e-5 * np.abs(pallas).max()
    assert ((port != 0) == (pallas != 0)).all()


def test_dantzig_fused_matches_pallas_within_reference_spread():
    # generic right-hand sides amplify summation-order noise more: here
    # the reference's own Pallas kernel and its own plain oracle differ
    # by ~5e-5 after 200 iterations.  The port may differ from the
    # Pallas kernel by no more than twice that, and agrees on the support.
    port, pallas, plain = _fused_pair("normal")
    assert np.abs(port - pallas).max() <= 2 * np.abs(plain - pallas).max()
    assert ((port != 0) == (pallas != 0)).all()


def test_dantzig_fused_batches_machines_like_single_solves():
    sig = [_sample_cov(24, 0.8, 80, seed=s) for s in range(3)]
    sigma = np.stack([s[0] for s in sig])
    factor = interop.factor_from_numpy(sigma, np.stack([s[1] for s in sig]),
                                       np.stack([s[2] for s in sig]), device="cpu")
    b = _t(np.eye(24, dtype=np.float32))
    batched = ops.dantzig_fused(factor, b.expand(3, 24, 24), 0.1, iters=50)
    for i in range(3):
        one = ops.dantzig_fused(type(factor)(*(f[i] for f in factor)), b, 0.1, iters=50)
        torch.testing.assert_close(batched[i], one, rtol=0, atol=1e-6)


def test_cpu_wrappers_launch_nothing():
    ops.reset_launches()
    x = torch.randn(2, 10, 6)
    ops.gram(x, x.mean(1))
    ops.soft_threshold(x, 0.1)
    ops.dantzig_fused(torch.eye(6), torch.eye(6), 0.1, iters=3)
    assert ops.LAUNCHES == {"gram": 0, "dantzig_fused": 0, "soft_threshold": 0}


# --- the Hopper blocking model ------------------------------------------------


def test_blocking_model_at_paper_shape():
    # d = 200: a 40-column tile fills 224,320 of the 232,448 bytes, so
    # k = 200 runs as 5 blocks of 40; one column alone also fits
    assert fused_model.max_block_k(200) == 40
    assert fused_model.pick_block_k(200, 200) == 40
    assert fused_model.pick_block_k(200, 1) == 1
    assert fused_model.pick_block_k(200, 41) == 21  # two equal blocks
    assert fused_model.tile_width(21) == 24
    assert (fused_model.fused_block_smem_bytes(200, 40)
            <= fused_model.SMEM_BYTES < fused_model.fused_block_smem_bytes(200, 48))


def test_fused_never_falls_back_to_scan():
    # the reference's TPU model sends d >~ 1250 to the scan; the port's
    # streams A and Q, so fused stays fused, and raises past one column
    cfg = DantzigConfig(fused=True)
    assert select_solver(cfg, 2000, 2000).kind == "fused_blocked"
    assert select_solver(cfg, 2000, 1) == ("fused", 1)
    with pytest.raises(ValueError, match="shared memory"):
        select_solver(cfg, 9000, 1)


@pytest.mark.parametrize("d,k", [(24, 1), (24, 24), (32, 32), (40, 40), (40, 1)])
@pytest.mark.parametrize("fused", [False, True])
def test_select_solver_kind_matches_reference_at_test_shapes(d, k, fused):
    want = jax_select_solver(JaxDantzigConfig(fused=fused), d, k, backend="cpu")
    assert select_solver(DantzigConfig(fused=fused), d, k).kind == want.kind


def test_block_k_override_caps_at_widest_tile():
    assert select_solver(DantzigConfig(fused=True, block_k=8), 40, 40) == ("fused_blocked", 8)
    assert select_solver(DantzigConfig(fused=True, block_k=500), 200, 200) == ("fused_blocked", 40)


def test_plain_versions_match_reference_oracles():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((20, 16)).astype(np.float32)
    np.testing.assert_array_equal(
        ref.hard_threshold_ref(_t(x), 0.5).numpy(),
        np.asarray(jax_ref.hard_threshold_ref(jnp.asarray(x), 0.5)))
    sigma, q, evals = _sample_cov(16, 0.5, 60, seed=4)
    inv = (1.0 / (evals * evals + 1.0)).astype(np.float32)
    b = np.eye(16, dtype=np.float32)[:, :5]
    want = np.asarray(jax_ref.dantzig_fused_ref(jnp.asarray(sigma), jnp.asarray(q),
                                                jnp.asarray(inv), jnp.asarray(b), 0.1,
                                                iters=100))
    got = ref.dantzig_fused_ref(_t(sigma), _t(q), _t(inv), _t(b), 0.1, iters=100).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
