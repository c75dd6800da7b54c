"""The port's kernel modules (K1 gram, K2 and K3 fused ADMM, K4 shrink) against the JAX reference.

Inputs are made once with numpy from a seed and handed to both
packages.  The reference runs its Pallas kernels in interpret mode, as
its own kernel tests do; on the CPU the port's wrappers run their plain
PyTorch versions (the kernels themselves run only on the card, where
``chip_smoke.py`` holds each against its plain version).
"""

import ast
import re
from pathlib import Path

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
from repro_torch.kernels import _launch, build, ops, ref
from repro_torch.kernels import dantzig_fused as fused_model
from repro_torch.kernels import gram as gram_module
from repro_torch.kernels import soft_threshold as shrink_module
import test_torch_parity  # noqa: F401  (pins torch to one thread)


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


# +-0, +-inf, NaN, |x| == 0.25 (the scalar t) and numbers far below and above it
_EDGE = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 0.25, -0.25, 1e-30, -1e-30, 3e38, -3e38],
                 np.float32)


@pytest.mark.parametrize("shape", [(16,), (4, 36), (40, 33), (3, 9, 8)])
@pytest.mark.parametrize("per_column", [False, True], ids=["scalar-t", "per-column-t"])
def test_soft_threshold_edge_values_match_reference(shape, per_column):
    # NaN stays NaN (the plain version's clamp keeps it), +-inf shrink to
    # +-inf, and |x| == t gives zero; held against the reference's Pallas
    # kernel in interpret mode (scalar t, up to rank 2) and its plain jnp
    # version, NaN positions included
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    c = shape[-1]
    if per_column:
        t = rng.uniform(0.05, 0.3, shape[:-2] + (1, c) if len(shape) >= 2 else (c,))
        t = t.astype(np.float32)
        if len(shape) >= 2:  # the first two rows of every matrix hit their column's t
            x[..., 0, :], x[..., 1, :] = t[..., 0, :], -t[..., 0, :]
        else:
            x[:4] = t[:4] * np.array([1, -1, 1, -1], np.float32)
    else:
        t = 0.25
    flat = x.reshape(-1)
    flat[rng.permutation(flat.size)[:_EDGE.size]] = _EDGE
    got = ops.soft_threshold(_t(x), _t(t) if per_column else t).numpy()
    want = np.asarray(jax_ref.soft_threshold_ref(jnp.asarray(x), jnp.asarray(t)))
    np.testing.assert_array_equal(got, want)
    if not per_column and len(shape) <= 2:
        pallas = np.asarray(soft_threshold_pallas(jnp.asarray(x), t, block_r=8, block_c=16,
                                                  interpret=True))
        np.testing.assert_array_equal(got, pallas)
    assert np.isnan(got).sum() == 1 and np.isnan(got.reshape(-1)[np.isnan(flat)]).all()
    assert np.isinf(got).sum() == 2


@pytest.mark.parametrize("launch", [
    lambda: gram_module.gram_cuda(torch.ones(2, 3, 4), torch.ones(2, 4)),
    lambda: shrink_module.soft_threshold_cuda(torch.ones(3, 4), 0.1),
    lambda: shrink_module.soft_threshold_cuda(torch.ones(2, 3, 4), torch.ones(2, 1, 4)),
], ids=["gram", "soft_threshold", "soft_threshold-per-column"])
def test_cuda_launchers_raise_on_cpu_tensors(launch):
    # the kernels' own wrappers never fall back: only ops picks the plain version
    with pytest.raises(ValueError, match="CUDA"):
        launch()


_LAUNCHERS = [fn for mod in (gram_module, shrink_module, fused_model)
              for fn in vars(mod).values() if isinstance(fn, _launch.CFunction)]


@pytest.mark.parametrize("fn", _LAUNCHERS, ids=lambda fn: fn.symbol)
def test_launcher_binds_a_symbol_its_source_defines(fn):
    # a text check of the C sources, so a misspelt symbol or a lost
    # argument is caught before the card builds them
    assert fn.source in build.SOURCES
    text = (build.CSRC / f"{fn.source}.cu").read_text()
    found = re.search(rf'extern "C" int {fn.symbol}\(([^)]*)\)', text)
    assert found, f"csrc/{fn.source}.cu defines no extern \"C\" {fn.symbol}"
    assert len(found.group(1).split(",")) == len(fn.argtypes)


def test_every_kernel_source_is_built_and_k4_is_cuda():
    assert {"gram", "dantzig_fused", "soft_threshold"} <= set(build.SOURCES)
    assert {fn.source for fn in _LAUNCHERS} == set(build.SOURCES)
    assert all((build.CSRC / f"{name}.cu").exists() for name in build.SOURCES)


def test_port_imports_no_triton():
    port = Path(build.__file__).resolve().parents[1]
    for path in sorted(port.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            assert not any(n.split(".")[0] == "triton" for n in names), path


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
    assert ops.LAUNCHES == {"gram": 0, "dantzig_fused": 0, "dantzig_fused_state": 0,
                            "soft_threshold": 0}


def test_wrappers_count_each_launch_by_its_operand_shape(monkeypatch):
    # the count and its split by shape sit where a wrapper launches its
    # kernel; here the "kernels" are stand-ins on CPU tensors
    monkeypatch.setattr(ops, "_on_card", lambda t: True)
    monkeypatch.setattr(ops, "gram_cuda", ref.gram_ref)
    monkeypatch.setattr(ops, "dantzig_fused_cuda",
                        lambda a, q, inv, b, lam, rho, **kw: torch.zeros_like(b))
    ops.reset_launches()
    x = torch.randn(2, 3, 10, 6)
    ops.gram(x, x.mean(2))
    ops.dantzig_fused(torch.eye(6), torch.ones(4, 6, 3), 0.1, iters=3)
    ops.dantzig_fused(torch.eye(6), torch.ones(4, 6, 3), 0.1, iters=3)
    assert ops.LAUNCHES["gram"] == 1 and ops.LAUNCHES["dantzig_fused"] == 2
    assert ops.LAUNCH_SHAPES == {("gram", 6, 10, 6): 1, ("dantzig_fused", 4, 6, 3): 2}
    ops.reset_launches()
    assert not ops.LAUNCH_SHAPES and not any(ops.LAUNCHES.values())


# --- the Hopper blocking model ------------------------------------------------


def test_blocking_model_at_paper_shape():
    # d = 200: a 40-column tile fills 224,320 of the 232,448 bytes, so
    # k = 200 runs as 5 blocks of 40; one column alone also fits
    plan = fused_model.plan_launch
    assert plan(200, 48, block_k=48).block_k == 40  # the widest tile that fits
    assert plan(200, 200)[:2] == (40, 40)
    assert plan(200, 1)[:2] == (1, 1)
    assert plan(200, 41)[:2] == (21, 24)  # two equal blocks, in the 24-column tile
    assert (fused_model.blocking_smem_bytes(200, 40)
            <= fused_model.SMEM_BYTES < fused_model.blocking_smem_bytes(200, 48))


def test_fused_never_falls_back_to_scan():
    # the reference's TPU model sends d >~ 1250 to the scan; the port's
    # streams A and Q, so fused stays fused, and raises past one column:
    # K2's streamed block holds two product buffers, so one column fits
    # to d = 29,055
    cfg = DantzigConfig(fused=True)
    assert select_solver(cfg, 2000, 2000).kind == "fused_blocked"
    assert select_solver(cfg, 2000, 1) == ("fused", 1)
    with pytest.raises(ValueError, match="shared memory"):
        select_solver(cfg, 29_056, 1)


@pytest.mark.parametrize("d,k", [(24, 1), (24, 24), (32, 32), (40, 40), (40, 1)])
@pytest.mark.parametrize("fused", [False, True])
def test_select_solver_kind_matches_reference_at_test_shapes(d, k, fused):
    want = jax_select_solver(JaxDantzigConfig(fused=fused), d, k, backend="cpu")
    assert select_solver(DantzigConfig(fused=fused), d, k).kind == want.kind


def test_block_k_override_caps_at_widest_tile():
    assert select_solver(DantzigConfig(fused=True, block_k=8), 40, 40) == ("fused_blocked", 8)
    assert select_solver(DantzigConfig(fused=True, block_k=500), 200, 200) == ("fused_blocked", 40)
    assert fused_model.plan_launch(40, 40, block_k=8)[:2] == (8, 8)
    assert fused_model.plan_launch(200, 200, block_k=500)[:2] == (40, 40)


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


# --- K3: the warm-state, tol-gated fused ADMM ------------------------------------


def _state_inputs(m=None):
    """AR(0.3) sample covariance(s) at d = 24, k = 11 unit right-hand sides, per-column lam/rho.

    With ``block_k=4`` the columns form blocks of 4, 4 and a ragged
    tail of 3 that exit the 1e-3 gate at different counts.
    """
    d, k = 24, 11
    seeds = [1] if m is None else list(range(1, m + 1))
    covs = [_sample_cov(d, 0.3, 400, seed=s) for s in seeds]
    rng = np.random.default_rng(7)
    b = np.eye(d, dtype=np.float32)[:, :k]
    lam = np.linspace(0.05, 0.6, k).astype(np.float32)
    rho = rng.uniform(0.8, 1.25, k).astype(np.float32)
    sigma, q, evals = (np.stack(v) if m else v[0] for v in zip(*covs))
    return sigma, q, evals, b, lam, rho


def _pallas_state(sigma, q, evals, b, lam, rho, *, iters, tol, state=None, block_k=4):
    from repro.kernels.dantzig_fused import AdmmState as JaxAdmmState

    inv = (1.0 / (evals * evals + 1.0)).astype(np.float32)
    jstate = None if state is None else JaxAdmmState(*(jnp.asarray(v) for v in state))
    res = dantzig_fused_pallas(*(jnp.asarray(v) for v in (sigma, q, inv, b, lam)),
                               jnp.asarray(rho), iters=iters, block_k=block_k, interpret=True,
                               tol=tol, check_every=10, state=jstate, return_info=True)
    return np.asarray(res.beta), [np.asarray(v) for v in res.state], np.asarray(res.iters)


def _port_state(sigma, q, evals, b, lam, rho, *, iters, tol, state=None, block_k=4):
    factor = interop.factor_from_numpy(sigma, q, evals, device="cpu")
    st = None if state is None else interop.state_from_numpy(*state, device="cpu")
    res = ops.dantzig_fused(factor, _t(b), _t(lam), iters=iters, rho=_t(rho), block_k=block_k,
                            tol=tol, check_every=10, state=st, return_info=True)
    return res.beta.numpy(), [v.numpy() for v in res.state], res.iters.numpy()


def _assert_state_close(got, want):
    w, leaves, iters = got
    w_want, leaves_want, iters_want = want
    np.testing.assert_array_equal(iters, iters_want)
    scale = np.abs(w_want).max()
    assert np.abs(w - w_want).max() <= 1e-5 * scale
    for name, g, v in zip("z w u1 u2".split(), leaves, leaves_want):
        assert np.abs(g - v).max() <= 1e-5 * max(scale, np.abs(v).max()), name


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_dantzig_fused_state_matches_pallas_per_block(warm):
    # three blocks (4, 4, ragged 3) gated on their own: w, the four state
    # leaves within the 1e-5 pin, and every block's iteration count equal
    sigma, q, evals, b, lam, rho = _state_inputs()
    state = None
    if warm:
        _, state, _ = _pallas_state(sigma, q, evals, b, lam, rho, iters=40, tol=None)
    want = _pallas_state(sigma, q, evals, b, lam, rho, iters=200, tol=1e-3, state=state)
    got = _port_state(sigma, q, evals, b, lam, rho, iters=200, tol=1e-3, state=state)
    _assert_state_close(got, want)
    assert len(set(want[2].tolist())) >= 2, f"blocks exit together: {want[2]}"
    assert want[2].max() < 200


def test_dantzig_fused_state_fixed_iterations_from_a_warm_state_matches_pallas():
    sigma, q, evals, b, lam, rho = _state_inputs()
    _, state, _ = _pallas_state(sigma, q, evals, b, lam, rho, iters=30, tol=None)
    want = _pallas_state(sigma, q, evals, b, lam, rho, iters=70, tol=None, state=state)
    got = _port_state(sigma, q, evals, b, lam, rho, iters=70, tol=None, state=state)
    _assert_state_close(got, want)
    np.testing.assert_array_equal(got[2], [70, 70, 70])


def test_dantzig_fused_state_nan_residual_stops_the_block():
    # res > tol is False for NaN: a NaN block stops after its first chunk,
    # as in the reference, while the clean blocks run on
    sigma, q, evals, b, lam, rho = _state_inputs()
    b = b.copy()
    b[0, 0] = np.nan
    _, _, want = _pallas_state(sigma, q, evals, b, lam, rho, iters=200, tol=1e-3)
    _, _, got = _port_state(sigma, q, evals, b, lam, rho, iters=200, tol=1e-3)
    np.testing.assert_array_equal(got, want)
    assert got[0] == 10 and got[1:].min() > 10


def test_dantzig_fused_state_resume_is_exact():
    # a fixed-rho state determines the next iteration completely, so n1
    # iterations resumed for n2 more equal one run of n1 + n2, bit for bit
    sigma, q, evals, b, lam, rho = _state_inputs()
    factor = interop.factor_from_numpy(sigma, q, evals, device="cpu")
    kw = dict(rho=_t(rho), block_k=4, return_info=True)
    first = ops.dantzig_fused(factor, _t(b), _t(lam), iters=35, state=ref.AdmmState.zeros(24, 11),
                              **kw)
    resumed = ops.dantzig_fused(factor, _t(b), _t(lam), iters=45, state=first.state, **kw)
    whole = ops.dantzig_fused(factor, _t(b), _t(lam), iters=80, **kw)
    for got, want in zip(resumed.state, whole.state):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    np.testing.assert_array_equal(whole.iters.numpy(), [80, 80, 80])


def test_dantzig_fused_state_at_tol_none_equals_the_fixed_kernel():
    sigma, q, evals, b, lam, rho = _state_inputs()
    factor = interop.factor_from_numpy(sigma, q, evals, device="cpu")
    fixed = ops.dantzig_fused(factor, _t(b), _t(lam), iters=60, rho=_t(rho))
    state = ops.dantzig_fused(factor, _t(b), _t(lam), iters=60, rho=_t(rho), return_info=True)
    torch.testing.assert_close(state.beta, fixed, rtol=0, atol=1e-7)


def test_dantzig_fused_state_gates_each_machine_on_its_own():
    # machines on the leading axis: each (machine, block) keeps its own
    # count, equal to the machine solved alone
    sigma, q, evals, b, lam, rho = _state_inputs(m=3)
    factor = interop.factor_from_numpy(sigma, q, evals, device="cpu")
    kw = dict(iters=200, rho=_t(rho), block_k=4, tol=1e-3, return_info=True)
    batched = ops.dantzig_fused(factor, _t(b).expand(3, 24, 11), _t(lam), **kw)
    assert batched.iters.shape == (3, 3) and batched.iters.dtype == torch.int32
    for i in range(3):
        one = ops.dantzig_fused(type(factor)(*(f[i] for f in factor)), _t(b), _t(lam), **kw)
        torch.testing.assert_close(batched.iters[i], one.iters, rtol=0, atol=0)
        torch.testing.assert_close(batched.beta[i], one.beta, rtol=0, atol=1e-6)


def test_cpu_state_wrapper_launches_nothing():
    ops.reset_launches()
    ops.dantzig_fused(torch.eye(6), torch.eye(6), 0.1, iters=3, tol=1e-3, return_info=True)
    assert ops.LAUNCHES["dantzig_fused_state"] == 0


def test_state_io_blocking_model_at_paper_shape():
    # K3 keeps its chunk deltas in the product buffers, so at d = 200 it
    # takes the same 40-column tile as K2: CLIME's k = 200 is 5 blocks of
    # 40 (100 blocks for m = 20, one wave on 132 SMs), the k = 8 direction
    # fold one block of 8
    plan = fused_model.plan_launch
    assert plan(200, 48, block_k=48, state_io=True).block_k == 40
    assert plan(200, 200, state_io=True).block_k == 40
    assert plan(200, 8, state_io=True)[:2] == (8, 8)
    assert (fused_model.blocking_smem_bytes(200, 40, state_io=True)
            <= fused_model.SMEM_BYTES
            < fused_model.blocking_smem_bytes(200, 48, state_io=True))
    assert select_solver(DantzigConfig(fused=True, tol=1e-4), 200, 200) == ("fused_blocked", 40)
    # K3 keeps the 28·d·W-byte footprint, so it runs out first: one column
    # at d = 8301 fits K2's footprint and not K3's
    assert plan(8301, 8).block_k == 1
    with pytest.raises(ValueError, match="shared memory"):
        plan(8301, 1, state_io=True)
    with pytest.raises(ValueError, match="shared memory"):
        select_solver(DantzigConfig(fused=True, tol=1e-4), 8301, 1)


# --- the Hopper cluster model -----------------------------------------------------


@pytest.mark.parametrize("k, state_io, cluster, tile, smem", [
    (1, False, 4, "row", 124_000),  # the direction solve: 1 x 1 slices fit from 4 blocks
    (8, True, 8, "row", 74_096),  # the lambda path's fold: 1 x 1 tiles need 25 rows a block
    (200, False, 4, "block", 184_000),  # CLIME: 2 x 4 tiles, 50 rows a block
    (200, True, 4, "block", 184_096),  # K3 adds its cluster reduction scratch
], ids=["k=1", "fold k=8", "CLIME K2", "CLIME K3"])
def test_cluster_model_at_paper_shapes(k, state_io, cluster, tile, smem):
    # d = 200, m = 20: the cluster template at every main shape, with the
    # shared memory per block the card reports for it
    plan = fused_model.plan_launch(200, k, state_io=state_io)
    assert not plan.streamed and plan.cluster == cluster
    assert fused_model.cluster_tile(200, plan.width, cluster) == tile
    assert plan.smem_bytes == fused_model.cluster_smem_bytes(200, plan.width, cluster,
                                                             state_io) == smem
    assert smem + fused_model.CLUSTER_STATIC_SMEM_BYTES <= fused_model.SMEM_BYTES


@pytest.mark.parametrize("width, state_io, fits", [
    (1, False, {2: False, 4: True, 8: True, 16: True}),  # 3 slices of 100 rows: 245 KB
    (8, True, {2: False, 4: True, 8: True, 16: True}),  # 2 x 4 tiles at 4 blocks
    (40, False, {2: False, 4: True, 8: True, 16: True}),  # 100 rows: 500 tiles of 2 x 4
])
def test_cluster_fit_rule_prefers_the_row_tile_then_the_smallest_cluster(width, state_io,
                                                                         fits):
    # the fold fits a 2 x 4 tile at 4 blocks but takes the 1 x 1 one at 8
    assert {cs: fused_model.cluster_fits(200, width, cs, state_io)
            for cs in fused_model.CLUSTER_SIZES} == fits
    row = [cs for cs, ok in fits.items() if ok and fused_model.cluster_tile(200, width, cs) == "row"]
    first = (row or [cs for cs, ok in fits.items() if ok])[0]
    plan = fused_model.plan_launch(200, width, state_io=state_io)
    assert plan.width == width and plan.cluster == first


@pytest.mark.parametrize("d, k, cluster", [
    (400, 1, 16),  # slices fit only at 16 blocks a cluster
    (512, 40, 0),  # 14-column blocks: the 1 x 1 tile has too many rows, 2 x 4 too little room
    (550, 1, 0),  # three 35-row slices of 550 floats exceed a block's shared memory
    (37, 8, 2),  # a small d: two blocks of 19 rows
])
def test_cluster_model_sends_oversized_slices_to_the_streamed_template(d, k, cluster):
    plan = fused_model.plan_launch(d, k)
    assert plan.cluster == cluster and plan.streamed == (cluster == 0)
    fitting = [cs for cs in fused_model.CLUSTER_SIZES
               if fused_model.cluster_fits(d, plan.width, cs)]
    assert bool(fitting) == bool(cluster)
    for cs in fitting:
        assert (fused_model.cluster_smem_bytes(d, plan.width, cs)
                + fused_model.CLUSTER_STATIC_SMEM_BYTES <= fused_model.SMEM_BYTES)
    if not cluster:
        assert plan.smem_bytes == fused_model.streamed_smem_bytes(d, plan.width)


def test_resolve_cluster_takes_a_size_or_the_model():
    # the plan's template: the model's pick, or a forced cluster size (0: streamed)
    assert fused_model.plan_launch(200, 1).cluster == 4
    assert fused_model.plan_launch(200, 1, cluster=0).cluster == 0
    forced = fused_model.plan_launch(200, 1, cluster=16)
    assert forced.cluster == 16
    assert forced.smem_bytes == fused_model.cluster_smem_bytes(200, 1, 16)
    with pytest.raises(ValueError, match="cluster"):
        fused_model.plan_launch(200, 1, cluster=3)
    with pytest.raises(ValueError, match="micro-tile"):
        fused_model.cluster_smem_bytes(200, 48, 2)
