"""The port's serving path and checkpoints against the JAX reference.

Inputs are made with numpy from a seed and handed to both packages at
the reference CLI's ``--smoke`` size (d = 28).  Merges are held within
1e-5 of the largest entry of the reference's result and of the one-shot
statistics; a quarantine leaves the statistics bit for bit; refits at
fixed rho and at most 150 iterations within the repo's parity pin
(``tests/test_torch_parity.py``), and at the default config by support
and an l2 distance of at most 1e-3; the ladder's rungs, the runtime's
statuses, versions, quarantine flags and served predictions equal the
reference's tick by tick, under the reference's materialized
``ServeFaultPlan``.  Snapshots restore across the two packages in both
directions.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jax_io
from repro.core import streaming as jst
from repro.core.dantzig import DantzigConfig as JaxDantzigConfig
from repro.core.faults import Aggregation as JaxAggregation
from repro.core.pipeline import mc_suff_stats as jax_mc_suff_stats
from repro.core.pipeline import suff_stats as jax_suff_stats
from repro.stats import synthetic as jax_synthetic
from repro_torch import interop
from repro_torch.analysis import check_entry, count_ops
from repro_torch.checkpoint import io as ckpt
from repro_torch.core import classifier, faults, pipeline
from repro_torch.core import streaming as st
from repro_torch.core.pipeline import mc_suff_stats, suff_stats
from repro_torch.kernels.spectral import spectral_factor
from test_torch_parity import assert_parity

REPO = Path(__file__).resolve().parents[1]
D = 28
LAM, LAM_P, THRESH = 0.1, 0.2, 1e-3


def _t(a, dtype=torch.float32):
    return interop.tensor(a, device="cpu", dtype=dtype)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _cfgs(**kw):
    jcfg = JaxDantzigConfig(**kw)
    return jcfg, interop.dantzig_config_from_dict(jcfg._asdict())


def _fields(d=D, n_signal=4):
    """The serve CLI's binary problem (AR(0.5)) as numpy fields."""
    problem = jax_synthetic.make_problem(d=d, n_signal=n_signal, rho=0.5)
    return {k: np.asarray(v) for k, v in problem._asdict().items()}


def _two_class(rng, f, n1, n2):
    d = f["mu1"].shape[0]
    x = (f["mu1"] + rng.standard_normal((n1, d)) @ f["chol"].T).astype(np.float32)
    y = (f["mu2"] + rng.standard_normal((n2, d)) @ f["chol"].T).astype(np.float32)
    return x, y


def _labeled(rng, f, n):
    lab = (rng.random(n) < 0.5).astype(np.int32)
    d = f["mu1"].shape[0]
    noise = rng.standard_normal((n, d)) @ f["chol"].T
    z = np.where(lab[:, None] == 0, f["mu1"], f["mu2"]) + noise
    return z.astype(np.float32), lab


def _both_stats(x, y):
    """(reference SuffStats, port SuffStats) of the same numpy draws."""
    return (jax_suff_stats(jnp.asarray(x), jnp.asarray(y)),
            suff_stats(torch.from_numpy(x), torch.from_numpy(y)))


def _assert_stats(got, want, exact=False):
    for name, g, w in zip(want._fields, got, want):
        if exact:
            np.testing.assert_array_equal(_np(g), np.asarray(w), err_msg=name)
        else:
            assert_parity(torch.as_tensor(g).to(torch.float32), np.asarray(w, np.float32))


# ---------------------------------------------------------------------------
# merges
# ---------------------------------------------------------------------------


def _chunked(kind, rng):
    """(chunks as numpy (x, y) or (x, labels), one-shot arrays) of one merge case."""
    f = _fields(17, 4)
    empty = np.zeros((0, 17), np.float32)
    if kind == "binary":  # uneven per-class chunks: 48 divides neither 130 nor 150
        x, y = _two_class(rng, f, 130, 150)
        chunks = [(x[i:i + 48], empty) for i in range(0, 130, 48)]
        chunks += [(empty, y[i:i + 48]) for i in range(0, 150, 48)]
        return chunks, (x, y)
    if kind == "single class":  # a chunk holding one class only: NaN mean on its empty side
        x, y = _two_class(rng, f, 60, 70)
        return [(x, empty), (empty, y)], (x, y)
    if kind == "rank-1":  # one sample a merge
        x, y = _two_class(rng, f, 25, 20)
        return [(x[i:i + 1], empty) for i in range(25)] + [
            (empty, y[i:i + 1]) for i in range(20)], (x, y)
    x = rng.standard_normal((205, 13)).astype(np.float32)  # K = 3, n not a chunk multiple
    labels = rng.integers(0, 3, 205)
    return [(x[i:i + 64], labels[i:i + 64]) for i in range(0, 205, 64)], (x, labels)


@pytest.mark.parametrize("kind", ["binary", "single class", "rank-1", "multiclass"])
def test_chunked_merges_match_reference_and_oneshot(kind):
    chunks, whole = _chunked(kind, np.random.default_rng(0))
    if kind == "multiclass":
        def port_stats(x, lab):
            return mc_suff_stats(torch.from_numpy(x), torch.from_numpy(lab), 3)

        def ref_stats(x, lab):
            return jax_mc_suff_stats(jnp.asarray(x), jnp.asarray(lab), 3)
    else:
        def port_stats(x, y):
            return suff_stats(torch.from_numpy(x), torch.from_numpy(y))

        def ref_stats(x, y):
            return jax_suff_stats(jnp.asarray(x), jnp.asarray(y))
    acc, ref = port_stats(*chunks[0]), ref_stats(*chunks[0])
    for chunk in chunks[1:]:
        acc = st.merge_stats(acc, port_stats(*chunk))
        ref = jst.merge_stats(ref, ref_stats(*chunk))
    assert all(bool(torch.isfinite(torch.as_tensor(leaf)).all()) for leaf in acc)
    _assert_stats(acc, ref)
    _assert_stats(acc, ref_stats(*whole))
    if kind != "multiclass":
        assert acc.n1.dtype == torch.int32 and acc.n1.shape == ()
        assert (int(acc.n1), int(acc.n2)) == (int(ref.n1), int(ref.n2))


def test_head_stats_round_trip():
    rng = np.random.default_rng(1)
    x, y = _two_class(rng, _fields(11), 40, 44)
    direct = pipeline.BinaryHead().stats(torch.from_numpy(x), torch.from_numpy(y))
    rebuilt = st.head_stats_of(direct.aux)
    assert torch.equal(rebuilt.sigma, direct.sigma) and torch.equal(rebuilt.rhs, direct.rhs)
    mc = pipeline.MulticlassHead(3).stats(torch.from_numpy(x), torch.from_numpy(
        rng.integers(0, 3, 40)))
    assert torch.equal(st.head_stats_of(mc.aux).rhs, mc.rhs)
    with pytest.raises(TypeError):
        st.head_stats_of(object())


# ---------------------------------------------------------------------------
# screening / quarantine / corruption
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("poison", ["nan", "inf", "garbage"])
def test_quarantine_bit_identical(poison):
    rng = np.random.default_rng(5)
    x, y = _two_class(rng, _fields(10), 50, 50)
    acc = st.stats_on(suff_stats(torch.from_numpy(x), torch.from_numpy(y)), "cpu")
    bad = torch.full((8, 10), {"nan": float("nan"), "inf": float("inf"), "garbage": 1e12}[poison])
    bad_stats = suff_stats(bad, torch.zeros(0, 10))
    w = st.screen_batch(faults.Aggregation(envelope=1e6), bad)
    assert float(w) == 0.0
    after = st.ingest_stats(acc, bad_stats, w)
    for name, got, want in zip(acc._fields, after, acc):
        assert got.dtype == want.dtype and torch.equal(got, want), name
    # a clean batch passes and merges as the reference merges it
    bx, by = _two_class(rng, _fields(10), 20, 20)
    w = st.screen_batch(faults.Aggregation(envelope=1e6), torch.from_numpy(bx),
                        torch.from_numpy(by))
    assert float(w) == 1.0
    merged = st.ingest_stats(acc, suff_stats(torch.from_numpy(bx), torch.from_numpy(by)), w)
    ref = jst.merge_suff_stats(jax_suff_stats(jnp.asarray(x), jnp.asarray(y)),
                               jax_suff_stats(jnp.asarray(bx), jnp.asarray(by)))
    _assert_stats(merged, ref)


@pytest.mark.parametrize("fill", [float("nan"), float("inf"), -float("inf"), 1e12, 1e5])
@pytest.mark.parametrize("envelope", [None, 1e6])
def test_screen_batch_matches_reference(fill, envelope):
    # one poisoned entry in a 1-D array, an (n, d) array and a 3-D one, beside
    # integer labels, which pass unscreened
    rng = np.random.default_rng(6)
    arrays = [rng.standard_normal(12).astype(np.float32),
              rng.standard_normal((9, 5)).astype(np.float32),
              rng.standard_normal((2, 3, 4)).astype(np.float32)]
    labels = rng.integers(0, 3, 9).astype(np.int32)
    for i in range(len(arrays)):
        batch = [a.copy() for a in arrays]
        batch[i].reshape(-1)[7] = fill
        want = jst.screen_batch(JaxAggregation(envelope=envelope),
                                *(jnp.asarray(a) for a in batch), jnp.asarray(labels))
        got = st.screen_batch(faults.Aggregation(envelope=envelope),
                              *(torch.from_numpy(a) for a in batch), torch.from_numpy(labels))
        assert got.shape == () and float(got) == float(want), (i, float(got), float(want))


@pytest.mark.parametrize("code", [0, 1, 2, 3])
def test_corrupt_batch_arrays_match_reference(code):
    rng = np.random.default_rng(7)
    arrays = (rng.standard_normal((6, 4)).astype(np.float32),
              rng.standard_normal(5).astype(np.float32),
              rng.standard_normal((3, 2, 2)).astype(np.float32),
              rng.integers(0, 3, 6).astype(np.int32))
    want = jst.corrupt_batch_arrays(code, tuple(jnp.asarray(a) for a in arrays))
    got = st.corrupt_batch_arrays(code, tuple(torch.from_numpy(a) for a in arrays))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))


# ---------------------------------------------------------------------------
# slots and the hot path
# ---------------------------------------------------------------------------


def test_binary_slot_is_the_fisher_rule_and_the_reference_slot():
    rng = np.random.default_rng(8)
    f = _fields(17)
    x, y = _two_class(rng, f, 120, 140)
    jaux, aux = _both_stats(x, y)
    _, cfg = _cfgs(tol=1e-3)
    res, _ = st.refit_with_escalation(st.head_stats_of(st.stats_on(aux, "cpu")), LAM, LAM_P,
                                      cfg, None)
    slot = st.slot_from_stats(aux, res.beta_tilde, THRESH, version=1)
    z, _ = _labeled(rng, f, 400)
    pred, scores = st.classify_batch(torch.from_numpy(z), slot.beta, slot.means)
    beta = st.hard_threshold(res.beta_tilde, THRESH).reshape(-1)
    assert torch.equal(pred, classifier.fisher_rule(torch.from_numpy(z), beta, aux.mu1, aux.mu2))
    assert scores.shape == (400, 2) and slot.version.dtype == torch.int32
    # the same direction through the reference's slot_from_stats
    jslot = jst.slot_from_stats(jaux, jnp.asarray(_np(res.beta_tilde)), THRESH, version=1)
    for name, got, want in zip(jslot._fields, slot, jslot):
        assert_parity(got.to(torch.float32), np.asarray(want, np.float32))
    jpred, _ = jst.classify_batch(jnp.asarray(z), jslot.beta, jslot.means, jslot.priors)
    assert np.array_equal(_np(st.classify_batch(torch.from_numpy(z), slot.beta, slot.means,
                                                slot.priors)[0]), np.asarray(jpred))


def test_multiclass_slot_and_priors_match_reference():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((90, 12)).astype(np.float32)
    labels = np.repeat(np.arange(3), [10, 30, 50])
    aux = mc_suff_stats(torch.from_numpy(x), torch.from_numpy(labels), 3)
    jaux = jax_mc_suff_stats(jnp.asarray(x), jnp.asarray(labels), 3)
    beta = rng.standard_normal((12, 3)).astype(np.float32)
    slot = st.slot_from_stats(aux, torch.from_numpy(beta), 0.3, version=4)
    jslot = jst.slot_from_stats(jaux, jnp.asarray(beta), 0.3, version=4)
    for got, want in zip(slot, jslot):
        assert_parity(got.to(torch.float32), np.asarray(want, np.float32))
    z = rng.standard_normal((64, 12)).astype(np.float32)
    pred, _ = st.classify_batch(torch.from_numpy(z), slot.beta, slot.means, slot.priors)
    jpred, _ = jst.classify_batch(jnp.asarray(z), jslot.beta, jslot.means, jslot.priors)
    np.testing.assert_array_equal(_np(pred), np.asarray(jpred))


# ---------------------------------------------------------------------------
# refits and the ladder
# ---------------------------------------------------------------------------


def _merged_stats(seed=11):
    """(reference HeadStats, port HeadStats) of a seed fit's data merged with one batch,
    and of the seed data alone."""
    rng = np.random.default_rng(seed)
    f = _fields()
    x, y = _two_class(rng, f, 160, 160)
    bx, by = _two_class(rng, f, 40, 40)
    j0, p0 = _both_stats(x, y)
    j1, p1 = _both_stats(bx, by)
    return ((jst.head_stats_of(jst.merge_suff_stats(j0, j1)),
             st.head_stats_of(st.merge_suff_stats(p0, p1))),
            (jst.head_stats_of(j0), st.head_stats_of(st.stats_on(p0, "cpu"))))


def _assert_refit(got, want):
    for name in ("beta_tilde", "beta_hat", "theta"):
        assert_parity(getattr(got, name), getattr(want, name))
    for name in ("rho_beta", "rho_theta"):
        assert_parity(getattr(got.carry, name), getattr(want.carry, name))
    for name in ("state_beta", "state_theta"):
        for g, w in zip(getattr(got.carry, name), getattr(want.carry, name)):
            assert_parity(g, w)
    np.testing.assert_array_equal(_np(got.iters_beta), np.asarray(want.iters_beta))
    np.testing.assert_array_equal(_np(got.iters_theta), np.asarray(want.iters_theta))


@pytest.mark.parametrize("fused", [False, True], ids=["scan", "fused"])
@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_refit_step_matches_reference(fused, warm):
    (jhs, hs), (jhs0, hs0) = _merged_stats()
    jcfg, cfg = _cfgs(max_iters=150, adapt_rho=False, fused=fused, block_k=8 if fused else None)
    jcarry = carry = None
    if warm:  # the seed fit's carry, from the reference, resumed on the merged statistics
        jcarry = jst.refit_step(jhs0, LAM, LAM_P, jcfg).carry
        carry = interop.refit_carry_from_numpy(jcarry, "cpu")
    want = jst.refit_step(jhs, LAM, LAM_P, jcfg, carry=jcarry)
    got = st.refit_step(hs, LAM, LAM_P, cfg, carry=carry)
    _assert_refit(got, want)
    assert_parity(spectral_factor(hs.sigma).evals, want.factor.evals)


def test_refit_step_at_the_default_config_matches_reference_by_support_and_l2():
    (jhs, hs), _ = _merged_stats(12)
    jcfg, cfg = _cfgs(tol=1e-3)
    want = jst.refit_step(jhs, LAM, LAM_P, jcfg)
    got = st.refit_step(hs, LAM, LAM_P, cfg)
    beta, jbeta = st.hard_threshold(got.beta_tilde, THRESH), np.asarray(
        jst.hard_threshold(want.beta_tilde, THRESH))
    np.testing.assert_array_equal(_np(beta) != 0, jbeta != 0)
    assert float(np.linalg.norm(_np(got.beta_tilde) - np.asarray(want.beta_tilde))) <= 1e-3
    assert st.refit_converged(got, cfg) == jst.refit_converged(want, jcfg)


@pytest.mark.parametrize("fused", [False, True], ids=["scan", "fused"])
@pytest.mark.parametrize("inject", [0, 1, 2, 3])
def test_escalation_ladder_rungs_match_reference(fused, inject):
    (jhs, hs), (jhs0, _) = _merged_stats(13)
    jcfg, cfg = _cfgs(tol=1e-3, fused=fused, block_k=8 if fused else None)
    jcarry = jst.refit_step(jhs0, LAM, LAM_P, jcfg).carry
    want, jlog = jst.refit_with_escalation(jhs, LAM, LAM_P, jcfg, jcarry,
                                           inject_fail_attempts=inject)
    got, log = st.refit_with_escalation(hs, LAM, LAM_P, cfg,
                                        interop.refit_carry_from_numpy(jcarry, "cpu"),
                                        inject_fail_attempts=inject)
    assert [(e["attempt"], e["converged"]) for e in log] == [
        (e["attempt"], e["converged"]) for e in jlog]
    assert len(log) == min(inject + 1, 3)
    assert (got is None) == (want is None) == (inject >= 3)
    if got is not None:
        assert bool(torch.isfinite(got.beta_tilde).all())


def test_escalation_ladder_is_bounded():
    (_, hs), _ = _merged_stats(14)
    _, cfg = _cfgs(tol=1e-3)
    res, log = st.refit_with_escalation(hs, LAM, LAM_P, cfg, None,
                                        policy=st.EscalationPolicy(max_attempts=1),
                                        inject_fail_attempts=1)
    assert res is None and len(log) == 1 and not log[0]["converged"]
    for bad in (dict(max_attempts=0), dict(backoff_s=-1.0), dict(refactor_scale=0)):
        with pytest.raises(ValueError):
            st.EscalationPolicy(**bad).validate()


@pytest.mark.parametrize("fill", [float("nan"), float("inf")])
@pytest.mark.parametrize("fused", [False, True], ids=["scan", "fused"])
def test_nonfinite_stats_fail_the_verdict(fill, fused):
    (jhs, hs), _ = _merged_stats(15)
    jcfg, cfg = _cfgs(tol=1e-3, fused=fused)
    sigma = hs.sigma.clone()
    sigma[3, 5] = sigma[5, 3] = fill
    res = st.refit_step(hs._replace(sigma=sigma), LAM, LAM_P, cfg)
    want = jst.refit_step(jhs._replace(sigma=jnp.asarray(_np(sigma))), LAM, LAM_P, jcfg)
    assert not st.refit_converged(res, cfg) and not jst.refit_converged(want, jcfg)
    assert not bool(torch.isfinite(res.beta_tilde).any())


def test_spectral_factor_of_a_nonfinite_machine_is_all_nan():
    # a batch of machines: only the poisoned one's factor is NaN, and the
    # others' equal their factors alone (the NaN is selected, never mixed)
    a = torch.randn(3, 6, 6, generator=torch.Generator().manual_seed(0))
    sigma = a @ a.mT / 6
    poisoned = sigma.clone()
    poisoned[1, 0, 0] = float("inf")
    fac = spectral_factor(poisoned)
    assert bool(torch.isnan(fac.q[1]).all()) and bool(torch.isnan(fac.evals[1]).all())
    for m in (0, 2):
        alone = spectral_factor(sigma[m])
        assert torch.equal(fac.evals[m], alone.evals) and torch.equal(fac.q[m], alone.q)
    # an all-NaN 4 x 4 matrix makes LAPACK's eigh raise; the factor is NaN instead
    assert bool(torch.isnan(spectral_factor(torch.full((4, 4), float("nan"))).q).all())


def test_slot_status_matches_reference():
    for bound in range(4):
        for missed in range(-1, 6):
            assert st.slot_status(missed, bound) == jst.slot_status(missed, bound)
    assert (st.STATUS_LIVE, st.STATUS_STALE, st.STATUS_DEGRADED) == (
        jst.STATUS_LIVE, jst.STATUS_STALE, jst.STATUS_DEGRADED)


def test_serve_fault_schedule_is_seeded_and_validated():
    sched = st.ServeFaultSchedule(0.4, 0.5, 0.3, seed=7)
    a, b = sched.plan(32), sched.plan(32)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert a.corrupt.shape == (32,) and a.corrupt.dtype == torch.int32
    assert bool(a.corrupt.any()) and bool(a.diverge.any()) and bool(a.drop.any())
    hit = a.corrupt > 0
    assert torch.equal(a.corrupt[hit], (1 + torch.arange(32) % 3)[hit].to(torch.int32))
    assert set(a.diverge.tolist()) <= {0, 1, 2}
    quiet = st.ServeFaultSchedule().plan(16)
    assert not quiet.corrupt.any() and not quiet.diverge.any() and not quiet.drop.any()
    assert set(st.ServeFaultSchedule(1.0, corrupt_mode="inf").plan(5).corrupt.tolist()) == {2}
    for bad in (dict(corrupt_ingest=1.5), dict(drop_refresh=-0.1), dict(corrupt_mode="zero")):
        with pytest.raises(ValueError):
            st.ServeFaultSchedule(**bad).validate()


# ---------------------------------------------------------------------------
# the runtime, tick by tick against the reference
# ---------------------------------------------------------------------------


def _stream(seed, ticks, n_batch=40, n_query=128):
    rng = np.random.default_rng(seed)
    f = _fields()
    seed_xy = _two_class(rng, f, 160, 160)
    return seed_xy, [(_two_class(rng, f, n_batch, n_batch), *_labeled(rng, f, n_query))
                     for _ in range(ticks)]


def _drive(rt, ticks, plan, port: bool):
    """Run one runtime over the shared ticks: one record a tick (status, acceptance,
    refresh, version, predictions)."""
    if port:
        arr, stats, corrupt = torch.from_numpy, suff_stats, st.corrupt_batch_arrays
    else:
        arr, stats, corrupt = jnp.asarray, jax_suff_stats, jst.corrupt_batch_arrays
    out = []
    for t, ((x, y), z, _) in enumerate(ticks):
        pred, _ = rt.classify(arr(z))
        rec = {"status": rt.status, "pred": np.asarray(_np(pred))}
        bad = corrupt(int(plan.corrupt[t]), (arr(x), arr(y)))
        rec["accepted"] = rt.ingest_batch(stats(*bad), *bad)
        rec["refreshed"] = None
        if t % 2 == 1:
            rec["refreshed"] = rt.refresh(drop=bool(plan.drop[t]),
                                          inject_diverge=int(plan.diverge[t]))
        rec["version"] = int(rt.slot.version)
        out.append(rec)
    return out


@pytest.mark.parametrize("protect", [True, False], ids=["protected", "unprotected"])
def test_runtime_matches_reference_tick_by_tick(protect):
    ticks = 10
    (x, y), stream = _stream(16, ticks)
    jplan = jst.ServeFaultSchedule(corrupt_ingest=0.5, diverge_refit=0.6, drop_refresh=0.25,
                                   seed=3).plan(ticks)
    plan = interop.serve_fault_plan_from_numpy(*jplan)
    assert plan.corrupt.any() and plan.diverge.any() and plan.drop.any()
    jcfg, cfg = _cfgs(tol=1e-3)
    jaux, aux = _both_stats(x, y)
    jrt = jst.ServingRuntime(jaux, LAM, LAM_P, THRESH, cfg=jcfg, protect=protect)
    rt = st.ServingRuntime(aux, LAM, LAM_P, THRESH, cfg=cfg, protect=protect, device="cpu")
    want, got = _drive(jrt, stream, jplan, False), _drive(rt, stream, plan, True)
    for t, (g, w) in enumerate(zip(got, want)):
        for key in ("status", "accepted", "refreshed", "version"):
            assert g[key] == w[key], (t, key, g[key], w[key])
        np.testing.assert_array_equal(g["pred"], w["pred"], err_msg=f"tick {t}")
    assert [(e["attempt"], e["converged"]) for e in rt.ladder_log] == [
        (e["attempt"], e["converged"]) for e in jrt.ladder_log]
    if protect:
        assert any(not r["accepted"] for r in got) and any(r["refreshed"] is False for r in got)
    else:  # the fragile baseline serves non-finite scores, as the reference's does
        z = stream[-1][1]
        assert not bool(torch.isfinite(rt.classify(torch.from_numpy(z))[1]).all())
        assert not np.isfinite(np.asarray(jrt.classify(jnp.asarray(z))[1])).all()


def test_runtime_staleness_walk_and_last_good_slot():
    (x, y), _ = _stream(17, 0)
    _, cfg = _cfgs(tol=1e-3)
    rt = st.ServingRuntime(suff_stats(torch.from_numpy(x), torch.from_numpy(y)), LAM, LAM_P,
                           THRESH, cfg=cfg, staleness_bound=2, device="cpu",
                           escalation=st.EscalationPolicy(max_attempts=1))
    assert rt.status == st.STATUS_LIVE and int(rt.slot.version) == 1
    before = rt.slot.beta.clone()
    for want in (st.STATUS_STALE, st.STATUS_STALE, st.STATUS_DEGRADED):
        assert rt.refresh(drop=True) is False
        assert rt.status == want
    assert rt.refresh(inject_diverge=1) is False and rt.status == st.STATUS_DEGRADED
    assert torch.equal(rt.slot.beta, before)
    assert rt.refresh() is True
    assert rt.status == st.STATUS_LIVE and int(rt.slot.version) == 2


def test_comm_plan_shim_sets_staleness_and_screening():
    from repro_torch.core.transport import CommPlan

    (x, y), _ = _stream(18, 0)
    _, cfg = _cfgs(tol=1e-3)
    agg = faults.Aggregation(envelope=5.0)
    rt = st.ServingRuntime(suff_stats(torch.from_numpy(x), torch.from_numpy(y)), LAM, LAM_P,
                           THRESH, cfg=cfg, comm=CommPlan(staleness=4, aggregation=agg),
                           device="cpu")
    assert rt.staleness_bound == 4 and rt.ingest_policy == agg
    with pytest.raises(ValueError):
        st.ServingRuntime(rt.aux, LAM, LAM_P, THRESH, cfg=cfg, comm=CommPlan(staleness=-1),
                          device="cpu")


@pytest.mark.parametrize("head", ["binary", "multiclass"])
@pytest.mark.parametrize("fused", [False, True], ids=["scan", "fused"])
def test_counted_contracts(head, fused):
    rng = np.random.default_rng(19)
    if head == "binary":
        x, y = _two_class(rng, _fields(), 160, 160)
        aux = suff_stats(torch.from_numpy(x), torch.from_numpy(y))
    else:
        x = rng.standard_normal((300, D)).astype(np.float32)
        aux = mc_suff_stats(torch.from_numpy(x), torch.from_numpy(rng.integers(0, 4, 300)), 4)
    _, cfg = _cfgs(tol=1e-3, fused=fused, max_iters=100)
    rt = st.ServingRuntime(aux, LAM, LAM_P, THRESH, cfg=cfg, device="cpu", _defer_fit=True)
    res, refit = count_ops(st.refit_step, st.head_stats_of(rt.aux), LAM, LAM_P, cfg)
    assert check_entry("streaming.refit_step", refit, {"pallas_calls": 2 if fused else 0}) == []
    assert refit.eigh == 1
    rt._stage(res, 1)
    z = torch.from_numpy(rng.standard_normal((64, D)).astype(np.float32))
    _, served = count_ops(rt.classify, z)
    assert check_entry("streaming.classify_batch", served, {}) == []
    assert (served.eigh, served.matmul, sum(served.calls.values())) == (0, 1, 0)
    # the counter sees what it is asked to forbid
    _, bad = count_ops(lambda: (spectral_factor(torch.eye(3, dtype=torch.float64)),
                                z @ z.mT, z.mT @ z))
    tripped = {v.contract for v in check_entry("streaming.classify_batch", bad, {})}
    assert tripped == {"budget[eigh ==0]", "budget[dot_general ==1]",
                       "dtype[float <= float32]"}  # eigh, a second product, f64


def test_counter_sees_collectives(tmp_path):
    import torch.distributed as dist

    from repro_torch.core import collectives

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        x = torch.ones(3)
        axis = collectives.Axis("data", dist.group.WORLD)
        _, c = count_ops(lambda: dist.all_reduce(x))
        _, recorded = count_ops(lambda: collectives.all_reduce_sum(x, (axis,)))
    finally:
        dist.destroy_process_group()
    # a raw backend collective is seen, though no record accounts for it
    assert c.collective_count("psum") == 1 and c.unrecorded == {"psum": 1}
    assert [v.message for v in check_entry("streaming.refit_step", c, {"pallas_calls": 0})] == [
        "found 0 `eigh`, expected exactly 1",
        "found 1 `psum`, expected exactly 0"]
    assert recorded.unrecorded == {} and [r.op for r in recorded.collectives] == ["psum"]
    assert recorded.collectives[0].axes == ("data",) and recorded.collectives[0].bits == 96


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def test_snapshot_keys_are_the_reference_keys():
    rng = np.random.default_rng(20)
    x, y = _two_class(rng, _fields(), 40, 40)
    jaux, aux = _both_stats(x, y)
    assert sorted(ckpt._flatten(st.snapshot_template(st.stats_on(aux, "cpu")))) == sorted(
        jax_io._flatten(jst.snapshot_template(jaux)))
    lab = rng.integers(0, 3, 80)
    xy = np.concatenate([x, y])
    assert sorted(ckpt._flatten(st.snapshot_template(
        mc_suff_stats(torch.from_numpy(xy), torch.from_numpy(lab), 3)))) == sorted(
        jax_io._flatten(jst.snapshot_template(jax_mc_suff_stats(jnp.asarray(xy),
                                                                jnp.asarray(lab), 3))))


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_snapshot_restores_across_packages(tmp_path, writer):
    (x, y), stream = _stream(21, 1)
    (bx, by), z, _ = stream[0]
    jcfg, cfg = _cfgs(tol=1e-3)
    jaux, aux = _both_stats(x, y)
    ckpt_dir = str(tmp_path)
    if writer == "reference":
        live = jst.ServingRuntime(jaux, LAM, LAM_P, THRESH, cfg=jcfg, ckpt_dir=ckpt_dir)
        live.ingest_batch(jax_suff_stats(jnp.asarray(bx), jnp.asarray(by)), jnp.asarray(bx),
                          jnp.asarray(by))
        assert live.refresh()
        restored = st.ServingRuntime.restore(ckpt_dir, aux, LAM, LAM_P, THRESH, cfg=cfg,
                                             device="cpu")
        live_pred = np.asarray(live.classify(jnp.asarray(z))[0])
        got = _np(restored.classify(torch.from_numpy(z))[0])
        # the converter carries the same state across as the file does
        snap = interop.serving_snapshot_from_numpy(live.snapshot(), "cpu")
        for (key, a), (_, b) in zip(ckpt._leaves(snap), ckpt._leaves(
                {k: restored.snapshot()[k] for k in snap})):
            assert torch.equal(a.to(b.dtype), b), key
    else:
        live = st.ServingRuntime(aux, LAM, LAM_P, THRESH, cfg=cfg, ckpt_dir=ckpt_dir,
                                 device="cpu")
        live.ingest_batch(suff_stats(torch.from_numpy(bx), torch.from_numpy(by)),
                          torch.from_numpy(bx), torch.from_numpy(by))
        assert live.refresh()
        restored = jst.ServingRuntime.restore(ckpt_dir, jaux, LAM, LAM_P, THRESH, cfg=jcfg)
        live_pred = _np(live.classify(torch.from_numpy(z))[0])
        got = np.asarray(restored.classify(jnp.asarray(z))[0])
    assert int(restored.slot.version) == int(live.slot.version) == 2
    np.testing.assert_array_equal(got, live_pred)
    assert restored.refresh() is True  # the carry survived: the restored one refits


def test_latest_step_skips_torn_and_tmp_files(tmp_path):
    tree = {"a": torch.arange(6.0).reshape(2, 3), "b": (torch.ones(2), torch.tensor(3))}
    for step in (1, 2, 3):
        ckpt.save_checkpoint(str(tmp_path), step, tree)
    good = (tmp_path / "step_000000003.npz").read_bytes()
    (tmp_path / "step_000000004.npz").write_bytes(good[: len(good) // 2])  # torn mid-zip
    (tmp_path / "step_000000005.tmp").write_bytes(good)  # a killed writer's leftover
    assert ckpt.latest_step(str(tmp_path)) == 3 == jax_io.latest_step(str(tmp_path))
    assert ckpt.latest_step(str(tmp_path / "missing")) is None
    back = ckpt.restore_checkpoint(str(tmp_path), 3, tree, device="cpu")
    assert torch.equal(back["a"], tree["a"]) and torch.equal(back["b"][1], tree["b"][1])
    assert isinstance(back["b"], tuple)


def test_bf16_leaf_round_trips(tmp_path):
    x = torch.tensor([1.5, -2.25, 3.0e-3, float("inf")], dtype=torch.bfloat16)
    tree = {"w": x, "f": torch.ones(3)}
    ckpt.save_checkpoint(str(tmp_path), 7, tree)
    with np.load(tmp_path / "step_000000007.npz") as data:
        assert sorted(data) == ["__bf16__/w", "f"] and data["__bf16__/w"].dtype == np.uint16
    back = ckpt.restore_checkpoint(str(tmp_path), 7, tree, device="cpu")
    assert back["w"].dtype == torch.bfloat16 and torch.equal(back["w"], x)
    ref = jax_io.restore_checkpoint(str(tmp_path), 7, {"w": jnp.zeros(4, jnp.bfloat16),
                                                       "f": jnp.zeros(3)})
    np.testing.assert_array_equal(np.asarray(ref["w"], np.float32), x.float().numpy())


def test_restore_checks_shapes_and_keys(tmp_path):
    ckpt.save_checkpoint(str(tmp_path), 1, {"a": torch.zeros(2, 3)})
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore_checkpoint(str(tmp_path), 1, {"a": torch.zeros(3, 2)}, device="cpu")
    with pytest.raises(KeyError, match="missing"):
        ckpt.restore_checkpoint(str(tmp_path), 1, {"b": torch.zeros(2, 3)}, device="cpu")
    with pytest.raises(FileNotFoundError):
        st.ServingRuntime.restore(str(tmp_path / "none"), None, LAM, LAM_P, THRESH,
                                  device="cpu")


def test_serve_cli_smoke_chaos_on_the_cpu(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke", "--chaos", "--cpu",
         "--corrupt-ingest", "0.3", "--diverge-refit", "0.5", "--drop-refresh", "0.2",
         "--ckpt-dir", str(tmp_path / "ckpt")], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "checkpoint restore OK" in res.stdout and "fault-free twin accuracy" in res.stdout
    assert sorted(os.listdir(tmp_path / "ckpt"))[0] == "step_000000001.npz"
    shutil.rmtree(tmp_path / "ckpt")
