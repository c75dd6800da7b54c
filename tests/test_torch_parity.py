"""The parity pins the port's tests share, and tests of them.

A port result is held against the JAX reference within 1e-5 of the
reference's largest entry.  Where the reference's own f32 result moves
further than that when its input covariance moves by one ulp, that
spread is what the summation order alone can do on these inputs, and
the pin is ``SPREAD_FACTOR`` times it, measured on the test's own
inputs (:func:`reference_spread`).  The perturbations are symmetric
(Sigma stays symmetric), each entry moved one ulp up or down by a fixed
numpy draw, so a test's pin is the same on every run of one machine.

Every ``tests/test_torch_*.py`` module imports this one, which pins
torch's intra-op thread pool to one thread at import.  The suite runs
under several pytest workers at once, and each worker's default pool
(one thread a core) oversubscribes the CPU by the worker count; one
thread also fixes how a batched product splits its work, so a batched
solve equals the same solves one by one.
"""

from typing import Any, NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.pipeline import HeadStats

torch.set_num_threads(1)

# How many times the reference's own one-ulp spread a port result may sit from it.
SPREAD_FACTOR = 2.0
# The fixed numpy seeds of the one-ulp perturbations.
SPREAD_DRAWS = (1, 2, 3, 4, 5)
# The repo's budget, relative to the reference's largest entry.
REL_PIN = 1e-5


def ulp_signs(d: int, seed: int) -> np.ndarray:
    """A symmetric (d, d) matrix of +-1 from one numpy draw."""
    s = np.random.default_rng(seed).choice(np.array([-1.0, 1.0], np.float32), (d, d))
    return np.triu(s) + np.triu(s, 1).T


def perturb_ulp(sigma: np.ndarray, seed: int) -> np.ndarray:
    """``sigma`` (d, d) f32 with every entry moved one ulp, up or down by :func:`ulp_signs`."""
    sigma = np.asarray(sigma, np.float32)
    return np.nextafter(sigma, sigma + ulp_signs(sigma.shape[-1], seed) * np.float32(np.inf))


class UlpHead(NamedTuple):
    """A reference head whose Sigma_hat is moved by :func:`perturb_ulp`'s draw ``seed``."""

    base: Any
    seed: int

    def stats(self, *data):
        hs = self.base.stats(*data)
        signs = jnp.asarray(ulp_signs(hs.sigma.shape[-1], self.seed))
        return HeadStats(jnp.nextafter(hs.sigma, hs.sigma + signs * jnp.inf), hs.rhs, hs.aux)


def reference_spread(run, want, draws=SPREAD_DRAWS) -> float:
    """max |run(seed) - want| over the perturbation seeds: the reference's own spread.

    ``run(seed)`` is the reference on the test's inputs with Sigma_hat
    perturbed by that seed's draw (:func:`perturb_ulp` or
    :class:`UlpHead`); ``want`` is its unperturbed result.
    """
    want = np.asarray(want)
    return max(float(np.abs(np.asarray(run(seed)) - want).max()) for seed in draws)


def pin(want, spread: float = 0.0, scale: float = 0.0) -> float:
    """max(1e-5 * max(max|want|, scale), SPREAD_FACTOR * spread).

    ``scale`` is the largest entry of what ``want`` was taken from, where
    that is larger: an error-feedback residual ``u - decode(u)`` carries
    the rounding of ``u``, not of its own small entries.
    """
    return max(REL_PIN * max(float(np.abs(np.asarray(want)).max()), scale, 1e-30),
               SPREAD_FACTOR * spread)


def assert_parity(got, want, spread: float = 0.0, scale: float = 0.0) -> None:
    """``got`` (a tensor or array) within :func:`pin` of the reference's ``want``."""
    want = np.asarray(want)
    got = got.detach().cpu().numpy() if hasattr(got, "detach") else np.asarray(got)
    assert got.shape == want.shape, (got.shape, want.shape)
    gap = float(np.abs(got - want).max())
    bound = pin(want, spread, scale)
    assert gap <= bound, (
        f"gap {gap:.3e} > pin {bound:.3e} (max|want| {np.abs(want).max():.3e}, "
        f"reference spread {spread:.3e}, scale {scale:.3e})")


def test_perturbation_moves_every_entry_one_ulp_and_stays_symmetric():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((7, 7)).astype(np.float32)
    sigma = a @ a.T
    moved = perturb_ulp(sigma, 3)
    np.testing.assert_array_equal(moved, moved.T)
    up = moved > sigma
    np.testing.assert_array_equal(up, ulp_signs(7, 3) > 0)
    np.testing.assert_array_equal(np.where(up, np.nextafter(sigma, np.inf),
                                           np.nextafter(sigma, -np.inf)), moved)
    assert not np.array_equal(perturb_ulp(sigma, 3), perturb_ulp(sigma, 4))


def test_ulp_head_moves_sigma_like_the_numpy_perturbation():
    from repro.core.pipeline import BinaryHead

    rng = np.random.default_rng(1)
    x = rng.standard_normal((30, 6)).astype(np.float32)
    y = rng.standard_normal((20, 6)).astype(np.float32) + 0.5
    base = BinaryHead().stats(jnp.asarray(x), jnp.asarray(y))
    moved = UlpHead(BinaryHead(), 2).stats(jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_array_equal(np.asarray(moved.sigma), perturb_ulp(np.asarray(base.sigma), 2))
    np.testing.assert_array_equal(np.asarray(moved.rhs), np.asarray(base.rhs))


def test_pin_is_the_larger_of_the_budget_and_the_spread():
    want = np.array([0.5, -2.0])
    assert pin(want) == pytest.approx(2e-5)
    assert pin(want, 1e-6) == pytest.approx(2e-5)
    assert pin(want, 4e-5) == pytest.approx(SPREAD_FACTOR * 4e-5)
    assert reference_spread(lambda s: want + s * 1e-6, want, draws=(1, 3)) == pytest.approx(3e-6)
    assert_parity(want + 1.9e-5, want)
    with pytest.raises(AssertionError, match="pin"):
        assert_parity(want + 2.1e-5, want)
    assert_parity(want + 7e-5, want, spread=4e-5)
    assert pin(want, scale=10.0) == pytest.approx(1e-4)
    assert_parity(want + 9e-5, want, scale=10.0)
