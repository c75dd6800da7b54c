#!/usr/bin/env python3
"""Drives the PyTorch port's main path on one NVIDIA card and checks every kernel on it.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. build: compiles the CUDA C++ kernels (K1 gram, K2 fused ADMM) from
   ``repro_torch/kernels/csrc`` with one nvcc per source, all at once,
   and JIT-compiles the Triton kernel (K4 shrink);
2. kernels: each kernel against its plain PyTorch version on the card,
   at the main path's shapes and at ragged ones, plus K2's bit-identity
   across column blockings;
3. main path: Algorithm 1 at the paper's §5.1 size (d = 200, AR(0.8),
   10 signal coordinates, N = 10,000 over m = 20 machines, 500 ADMM
   iterations) through the entry points a user calls, twice --
   (a) ``DantzigConfig(fused=True)``: K1 + K2, and
   (b) ``DantzigConfig(use_kernel=True)``: K1 + K4 under the adaptive-rho
   scan -- each held against the same estimators on the card's plain path,
   with the kernels' launch counts read around each run;
4. times: each kernel, its plain version and the one PyTorch call that
   computes the same function (where there is one), with CUDA events.

The last lines are the kernels' JSON, the card's name and power limit,
and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

from repro_torch.configs import SYNTHETIC

# Dense peaks of an H100 SXM from NVIDIA's data sheet: FP32 outside the
# tensor cores, and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

# The paper's §5.1 design: d = 200, AR(0.8), 10 signal coordinates,
# N = 10,000 split over m = 20 machines (one of its machine counts), n1 = n2.
D, RHO, N_SIGNAL = SYNTHETIC.d, SYNTHETIC.rho, SYNTHETIC.n_signal
M = 20
N_PER = SYNTHETIC.N // M
ITERS, N_TEST, SEED = 500, 4000, 0
DEVICE = "cuda:0"
CHECK_ITERS = 200  # K2 vs its plain version: f32 drift grows with the iteration count


FAILURES: list[str] = []


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    """Record a failed check; the run goes on so one run reports every failure, then exits 1."""
    if not cond:
        print(f"chip_smoke: CHECK FAILED: {msg}", file=sys.stderr)
        FAILURES.append(msg)


def sync_time(fn):
    """(result, wall seconds) of fn() run to completion on the card."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds of fn() over ``reps`` back-to-back runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """The least milliseconds the card could take, and what bounds it."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check runs on an NVIDIA card")

    from repro_torch.core import pipeline
    from repro_torch.core.dantzig import DantzigConfig
    from repro_torch.core.distributed import (
        simulated_distributed_slda,
        simulated_naive_averaged_slda,
    )
    from repro_torch.core.clime import solve_clime_columns
    from repro_torch.core.slda import centralized_slda, hard_threshold
    from repro_torch.core.solver_dispatch import solve_dantzig
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels.dantzig_fused import dantzig_fused_cuda, pick_block_k
    from repro_torch.kernels.gram import gram_cuda
    from repro_torch.kernels.soft_threshold import soft_threshold_triton
    from repro_torch.kernels.spectral import spectral_factor
    from repro_torch.quickstart import format_table, metrics, tuning
    from repro_torch.stats import synthetic

    dev = torch.device(DEVICE)
    print(f"torch {torch.__version__}  cuda {torch.version.cuda}  "
          f"card {torch.cuda.get_device_name(0)}  python {sys.version.split()[0]}")

    # ---- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    seconds = build.build()
    for name in build.SOURCES:
        for line in build.log_path(name).read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    _, triton_s = sync_time(lambda: soft_threshold_triton(torch.ones(8, device=dev), 0.5))
    print(f"[build] nvcc {json.dumps({k: round(v, 2) for k, v in seconds.items()})}  "
          f"triton jit {triton_s:.2f} s  total {time.perf_counter() - t0:.2f} s")

    # ---- main-path inputs (the paper's §5.1 design) -------------------------
    problem = synthetic.make_problem(d=D, n_signal=N_SIGNAL, rho=RHO, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    n1 = n2 = N_PER // 2
    xs, ys = synthetic.sample_machines(gen, problem, M, n1, n2, device=dev)
    z, labels = synthetic.sample_labeled(gen, problem, N_TEST, device=dev)
    lam, lam_c, t = tuning(problem.beta_star, D, N_PER, M * N_PER)
    mu1_all, mu2_all = xs.reshape(-1, D).mean(0), ys.reshape(-1, D).mean(0)

    # ---- 2. kernels against their plain versions ---------------------------
    errs = {}
    mu1 = xs.mean(1)
    for label, (x, mu) in {
        "main": (xs, mu1),
        "ragged": (lambda r: (r, r.mean(1)))(
            torch.randn(3, 37, 203, generator=gen, device=dev)),
    }.items():
        got, want = gram_cuda(x, mu), ref.gram_ref(x, mu)
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        print(f"[kernels] K1 gram {label} {tuple(x.shape)}: max abs err {err:.3e} "
              f"(max |G| {scale:.3e}), symmetric {bool(torch.equal(got, got.mT))}")
        # f32 sums in another order than cuBLAS's: 1e-5 of the largest entry
        check(err <= 1e-5 * scale, f"K1 {label}: err {err} > 1e-5 * {scale}")
        check(torch.equal(got, got.mT), f"K1 {label}: not exactly symmetric")
        errs.setdefault("gram", err)

    stats = pipeline.suff_stats(xs, ys, use_kernel=False)
    factor = spectral_factor(stats.sigma)
    q = factor.q.contiguous()  # cuSOLVER returns the eigenvectors column-major
    eye = torch.eye(D, device=dev).expand(M, D, D).contiguous()
    rho_cols = torch.ones(M, D, device=dev)
    x_shrink = factor.q @ eye  # a (m, d, d) block of the scan's shape
    t_cols = 0.05 + 0.1 * torch.rand(M, 1, D, generator=gen, device=dev)
    for label, tt in (("scalar t", 0.05), ("per-column t", t_cols)):
        got, want = soft_threshold_triton(x_shrink, tt), ref.soft_threshold_ref(x_shrink, tt)
        print(f"[kernels] K4 shrink {label}: bit-identical {bool(torch.equal(got, want))}")
        check(torch.equal(got, want), f"K4 {label}: differs from the plain version")
    col = x_shrink[..., :1].contiguous()
    check(torch.equal(soft_threshold_triton(col, t_cols[..., :1]),
                      ref.soft_threshold_ref(col, t_cols[..., :1])), "K4 (m, d, 1) differs")
    errs["soft_threshold"] = 0.0

    def k2(b, block_k=None, iters=CHECK_ITERS):
        k = b.shape[-1]
        return dantzig_fused_cuda(stats.sigma, q, factor.inv_eig, b.contiguous(),
                                  torch.full((M, k), lam, device=dev),
                                  rho_cols[:, :k].contiguous(), iters=iters, alpha=1.7,
                                  block_k=block_k)

    def k2_plain(b):
        return ref.dantzig_fused_ref(stats.sigma, factor.q, factor.inv_eig, b, lam,
                                     iters=CHECK_ITERS, rho=1.0, alpha=1.7)

    for label, b in (("CLIME k=200", eye), ("direction k=1", stats.mu_d.unsqueeze(-1))):
        got, want = k2(b), k2_plain(b)
        k = b.shape[-1]
        # the plain version's own spread: the same columns solved inside
        # a batch of 8 more, which sends cuBLAS a product of another width
        wide = k2_plain(torch.cat([b, eye[..., :8]], dim=-1))[..., :k]
        err = float((got - want).abs().max())
        spread = float((wide - want).abs().max())
        scale = float(want.abs().max())
        print(f"[kernels] K2 fused {label}, {CHECK_ITERS} iters: max abs err {err:.3e} "
              f"(max |w| {scale:.3e}; plain vs plain at another product width {spread:.3e}), "
              f"support equal {bool(((got != 0) == (want != 0)).all())}")
        # the repo's 1e-5 pin relative to the largest entry, or, where
        # the summation order alone moves the plain version further, no
        # more than twice that spread
        check(err <= max(1e-5 * max(1.0, scale), 2 * spread),
              f"K2 {label}: err {err} > max(1e-5 * {scale}, 2 * {spread})")
        errs["dantzig_fused"] = max(errs.get("dantzig_fused", 0.0), err)
    full = k2(eye)
    bk = pick_block_k(D, D)
    same = {
        f"block_k=24 (tail of {D % 24})": torch.equal(k2(eye, block_k=24), full),
        f"one block of {bk}": torch.equal(k2(eye[..., :bk]), full[..., :bk]),
        "column 0 alone (k=1)": torch.equal(k2(eye[..., :1]), full[..., :1]),
    }
    print(f"[kernels] K2 default block_k={bk} bit-identical to: {json.dumps(same)}")
    check(all(same.values()), f"K2 output depends on the blocking: {same}")

    # ---- 3. the main path ---------------------------------------------------
    def estimators(cfg, use_kernel, times):
        out = {}
        out["distributed (paper)"], times["distributed"] = sync_time(
            lambda: simulated_distributed_slda(xs, ys, lam, lam, t, cfg, use_kernel=use_kernel))
        out["centralized"], times["centralized"] = sync_time(lambda: hard_threshold(
            centralized_slda(xs.reshape(-1, D), ys.reshape(-1, D), lam_c, cfg,
                             use_kernel=use_kernel), 0.5 * t))
        out["naive averaged"], times["naive"] = sync_time(
            lambda: simulated_naive_averaged_slda(xs, ys, lam, cfg, use_kernel=use_kernel))
        return out

    runs = {
        "a": (DantzigConfig(max_iters=ITERS, fused=True),
              DantzigConfig(max_iters=ITERS, adapt_rho=False)),
        "b": (DantzigConfig(max_iters=ITERS, use_kernel=True),
              DantzigConfig(max_iters=ITERS)),
    }
    launches = {name: 0 for name in ops.LAUNCHES}
    phase_s = {}
    tables = {}
    for run, (cfg, plain_cfg) in runs.items():
        ops.reset_launches()
        dist_only, _ = sync_time(
            lambda: simulated_distributed_slda(xs, ys, lam, lam, t, cfg))
        dist_launches = dict(ops.LAUNCHES)
        ops.reset_launches()
        times = {}
        betas = estimators(cfg, None, times)
        run_launches = dict(ops.LAUNCHES)
        for name, n in run_launches.items():
            launches[name] += n
        phase_s[run] = times
        for name, beta in betas.items():
            check(beta.shape == (D,) and bool(torch.isfinite(beta).all()),
                  f"run ({run}) {name}: shape {tuple(beta.shape)} or non-finite values")
        plain_times = {}
        plain = estimators(plain_cfg, False, plain_times)
        phase_s[f"{run} plain"] = plain_times
        rows = metrics(betas, problem.beta_star, z, labels, mu1_all, mu2_all)
        plain_rows = metrics(plain, problem.beta_star, z, labels, mu1_all, mu2_all)
        tables[run] = rows
        rerun = float((betas["distributed (paper)"] - dist_only).abs().max())
        print(f"[main ({run})] {cfg}\n  launches: distributed alone {dist_launches}, "
              f"all three estimators {run_launches}; two distributed runs differ by {rerun:.3e}")
        print(format_table(rows))
        print(f"[main ({run}) plain path on the card] {plain_cfg}, plain gram")
        print(format_table(plain_rows))
        for name in rows:
            f1, l2 = rows[name][0], rows[name][1]
            gap_l2 = abs(l2 - plain_rows[name][1])
            gap_beta = float((betas[name] - plain[name]).abs().max())
            print(f"  {name}: F1 {f1:.4f} vs {plain_rows[name][0]:.4f}, "
                  f"l2 gap {gap_l2:.3e}, max |beta - plain| {gap_beta:.3e}")
            check(f1 == plain_rows[name][0], f"run ({run}) {name}: F1 differs from plain")
            check(gap_l2 <= 1e-4, f"run ({run}) {name}: l2 gap {gap_l2} > 1e-4")
        print(f"  wall seconds: kernel path {json.dumps(times)}, "
              f"plain path {json.dumps(plain_times)}")
        check(run_launches["gram"] > 0, f"run ({run}): K1 never launched")
        if run == "a":
            check(dist_launches["dantzig_fused"] == 2,
                  f"run (a): distributed launched K2 {dist_launches['dantzig_fused']} times, not 2")
            check(dist_launches["gram"] > 0, "run (a): distributed never launched K1")
        else:
            check(run_launches["soft_threshold"] > 0, "run (b): K4 never launched")

    # ---- 4. times -------------------------------------------------------------
    name_card = torch.cuda.get_device_name(0)
    kernels = []

    def row(name, route, source, replaces, ms, plain_ms, flops, nbytes, library_ms):
        bound_ms, bound_by = bound(flops, nbytes)
        kernels.append(dict(name=name, route=route, source=source, replaces=replaces,
                            launches=launches[name], max_abs_err=errs[name], ms=ms,
                            kernel_ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by, library_ms=library_ms))

    xc = xs - mu1.unsqueeze(1)
    n = n1
    row("gram", "cuda", "repro_torch/kernels/csrc/gram.cu", "src/repro/kernels/gram.py:28",
        cuda_ms(lambda: gram_cuda(xs, mu1), 50), cuda_ms(lambda: ref.gram_ref(xs, mu1), 50),
        M * (n * D * (D + 1) + n * D), 4 * (M * n * D + M * D + M * D * D),
        cuda_ms(lambda: torch.bmm(xc.mT, xc), 50))  # library: centering excluded

    lam_cols = torch.full((M, D), lam, device=dev)
    k2_ms = cuda_ms(lambda: dantzig_fused_cuda(stats.sigma, q, factor.inv_eig, eye,
                                               lam_cols, rho_cols, iters=ITERS, alpha=1.7), 3)
    k2_plain_ms = cuda_ms(lambda: ref.dantzig_fused_ref(
        stats.sigma, factor.q, factor.inv_eig, eye, lam, iters=ITERS, rho=1.0), 1)
    k2_dir_ms = cuda_ms(lambda: dantzig_fused_cuda(
        stats.sigma, q, factor.inv_eig, stats.mu_d.unsqueeze(-1).contiguous(),
        lam_cols[:, :1].contiguous(), rho_cols[:, :1].contiguous(), iters=ITERS, alpha=1.7), 3)
    k2_dir_plain_ms = cuda_ms(lambda: ref.dantzig_fused_ref(
        stats.sigma, factor.q, factor.inv_eig, stats.mu_d.unsqueeze(-1), lam, iters=ITERS,
        rho=1.0), 1)
    # per iteration: four (d, d) x (d, k) products and ~20 elementwise operations per entry
    row("dantzig_fused", "cuda", "repro_torch/kernels/csrc/dantzig_fused.cu",
        "src/repro/kernels/dantzig_fused.py:202", k2_ms, k2_plain_ms,
        ITERS * M * (8 * D * D * D + 20 * D * D),
        4 * (2 * M * D * D + M * D + 2 * M * D * D + 2 * M * D), None)

    numel = x_shrink.numel()
    st_ms = cuda_ms(lambda: soft_threshold_triton(x_shrink, t_cols), 200)
    st_scalar_ms = cuda_ms(lambda: soft_threshold_triton(x_shrink, 0.05), 200)
    row("soft_threshold", "triton", "repro_torch/kernels/soft_threshold.py",
        "src/repro/kernels/soft_threshold.py:24", st_ms,
        cuda_ms(lambda: ref.soft_threshold_ref(x_shrink, t_cols), 200),
        4 * numel, 4 * (2 * numel + M * D),
        cuda_ms(lambda: torch.nn.functional.softshrink(x_shrink, 0.05), 200))
    print(f"[times] K2 direction solve (m={M}, d={D}, k=1, {ITERS} iters): {k2_dir_ms:.3f} ms"
          f" (plain {k2_dir_plain_ms:.3f} ms);"
          f" K4 with a scalar t: {st_scalar_ms:.4f} ms (the library_ms column is"
          f" F.softshrink with a scalar t)")
    print(f"[times] main-path wall seconds: {json.dumps(phase_s)}")
    # the distributed estimator layer by layer, each stage run to completion
    for run, (cfg, _) in runs.items():
        stages = {}
        hs, stages["suff_stats"] = sync_time(lambda: pipeline.BinaryHead().stats(xs, ys))
        fac, stages["eigh"] = sync_time(lambda: spectral_factor(hs.sigma))
        beta_hat, stages["direction solve"] = sync_time(
            lambda: solve_dantzig(fac, hs.rhs, lam, cfg))
        theta, stages["CLIME solve"] = sync_time(
            lambda: solve_clime_columns(fac, torch.arange(D, device=dev), lam, cfg))
        _, stages["debias + mean + HT"] = sync_time(lambda: hard_threshold(
            (beta_hat - theta.mT @ (hs.sigma @ beta_hat - hs.rhs)).mean(0)[:, 0], t))
        print(f"[times] distributed ({run}) by stage, ms: "
              f"{json.dumps({k: round(1e3 * v, 3) for k, v in stages.items()})}")
    print(f"[result] {json.dumps({r: tables[r] for r in tables})}")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    print(json.dumps({"kernels": kernels}))
    print(smi.stdout.strip().splitlines()[0])
    if FAILURES:
        fail(f"{len(FAILURES)} check(s) failed: {FAILURES}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name_card,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
