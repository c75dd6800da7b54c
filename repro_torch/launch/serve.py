"""Sparse-LDA classify-as-a-service from the command line (twin of ``repro.launch.serve``).

``python -m repro_torch.launch.serve --smoke`` streams synthetic
two-class (or ``--classes K``) traffic through
:class:`repro_torch.core.streaming.ServingRuntime`: every tick serves
one query batch through the hot path, ingests one (screened) data batch
into the merged sufficient statistics, and attempts a model refresh on
its schedule.  Chaos flags drive the seedable :class:`ServeFaultSchedule`::

    python -m repro_torch.launch.serve --smoke --chaos \\
        --corrupt-ingest 0.3 --diverge-refit 0.5 --drop-refresh 0.2

``--chaos`` asserts the degradation contract inline (finite scores
always; accuracy within the slack of a fault-free twin) and exits
non-zero on a violation.  ``--ckpt-dir`` snapshots every publish and
ends with a restore parity check; ``--unprotected`` runs the fragile
baseline.  It runs on the card; ``--cpu`` runs the plain PyTorch path on
the CPU, and ``--fused`` solves the refits in the fused kernels (K3 on
the card) in place of the adaptive-rho scan.  Every stream draws from
one ``torch.Generator`` seeded by ``--seed`` on the chosen device.
"""

from __future__ import annotations

import argparse
import subprocess
import time
from typing import Iterator

import torch

from repro_torch.core.dantzig import DantzigConfig
from repro_torch.core.pipeline import mc_suff_stats, suff_stats
from repro_torch.core.streaming import (
    ServeFaultPlan,
    ServeFaultSchedule,
    ServingRuntime,
    corrupt_batch_arrays,
)
from repro_torch.device import require_device
from repro_torch.stats.synthetic import (
    make_mc_problem,
    make_problem,
    sample_labeled,
    sample_mc_machines,
    sample_two_class,
)


def binary_stream(gen: torch.Generator, problem, n_seed: int, n_batch: int, n_query: int, *,
                  device: str | torch.device = "cuda"):
    """``(seed_aux, tick, stats_of)``: the seed fit's statistics; ``tick()`` draws one
    tick's ``((x, y) batch, queries, labels)``; ``stats_of`` a batch's statistics."""
    x, y = sample_two_class(gen, problem, n_seed, n_seed, device=device)

    def tick():
        bx, by = sample_two_class(gen, problem, n_batch, n_batch, device=device)
        z, lab = sample_labeled(gen, problem, n_query, device=device)
        return (bx, by), z, lab

    return suff_stats(x, y), tick, lambda arrs: suff_stats(*arrs)


def mc_stream(gen: torch.Generator, problem, classes: int, n_seed: int, n_batch: int,
              n_query: int, *, device: str | torch.device = "cuda"):
    """:func:`binary_stream` for the K-class head: ``n_seed`` and ``n_batch`` are per
    class of a two-class draw, so each draws twice as many labelled samples."""
    xs, labs = sample_mc_machines(gen, problem, 1, n_seed * 2, device=device)

    def tick():
        bx, blab = sample_mc_machines(gen, problem, 1, n_batch * 2, device=device)
        z, lab = sample_mc_machines(gen, problem, 1, n_query, device=device)
        return (bx[0], blab[0]), z[0], lab[0]

    return (mc_suff_stats(xs[0], labs[0], classes), tick,
            lambda arrs: mc_suff_stats(arrs[0], arrs[1], classes))


def serve_ticks(rt: ServingRuntime, tick, stats_of, ticks: int, refit_every: int,
                plan: ServeFaultPlan | None = None, twin: ServingRuntime | None = None
                ) -> Iterator[dict]:
    """Drive ``rt`` for ``ticks`` ticks; yields one record a tick (with the served
    predictions and scores).

    Each tick serves its queries (timed on the host clock, synchronised
    on the card), ingests its batch corrupted as ``plan`` says, and
    every ``refit_every`` ticks refreshes (dropped or poisoned as
    ``plan`` says).  A fault-free ``twin`` serves the same queries and,
    at each refresh, ingests the clean batch and refreshes.
    """
    for t in range(ticks):
        raw, z, lab = tick()
        t0 = time.perf_counter()
        pred, scores = rt.classify(z)
        if pred.is_cuda:
            torch.cuda.synchronize(pred.device)
        rec = {"t": t, "classify_s": time.perf_counter() - t0, "queries": int(z.shape[0]),
               "pred": pred, "scores": scores, "finite": bool(torch.isfinite(scores).all()),
               "accuracy": float((pred == lab).float().mean()), "status": rt.status}
        if twin is not None:
            rec["twin_accuracy"] = float((twin.classify(z)[0] == lab).float().mean())
        code = 0 if plan is None else int(plan.corrupt[t])
        faulted = corrupt_batch_arrays(code, raw)
        rec["accepted"] = rt.ingest_batch(stats_of(faulted), *faulted)
        rec["refreshed"] = None
        if (t + 1) % refit_every == 0:
            drop = False if plan is None else bool(plan.drop[t])
            diverge = 0 if plan is None else int(plan.diverge[t])
            rec["refreshed"] = rt.refresh(drop=drop, inject_diverge=diverge)
            if twin is not None:
                twin.ingest_batch(stats_of(raw), *raw)
                twin.refresh()
        rec["version"] = int(rt.slot.version)
        yield rec


def card_line(dev: torch.device) -> str:
    """The card's name and power limit, as nvidia-smi gives them (empty off the card)."""
    if dev.type != "cuda":
        return ""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else (
        f"{torch.cuda.get_device_name(dev)} (nvidia-smi failed)")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--d", type=int, default=60)
    ap.add_argument("--classes", type=int, default=2)
    ap.add_argument("--batch", type=int, default=256, help="query batch size per tick")
    ap.add_argument("--ingest", type=int, default=60,
                    help="arriving data samples per class per tick")
    ap.add_argument("--ticks", type=int, default=24)
    ap.add_argument("--refit-every", type=int, default=2)
    ap.add_argument("--staleness-bound", type=int, default=2)
    ap.add_argument("--lam", type=float, default=0.1)
    ap.add_argument("--lam-prime", type=float, default=0.2)
    ap.add_argument("--threshold", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny sizes for CI (overrides --d/--ticks/--batch/--ingest)")
    ap.add_argument("--chaos", action="store_true",
                    help="assert the degradation contract inline")
    ap.add_argument("--acc-slack", type=float, default=0.02)
    ap.add_argument("--corrupt-ingest", type=float, default=0.0)
    ap.add_argument("--diverge-refit", type=float, default=0.0)
    ap.add_argument("--drop-refresh", type=float, default=0.0)
    ap.add_argument("--corrupt-mode", default="mix")
    ap.add_argument("--unprotected", action="store_true",
                    help="fragile baseline: no screening/verdict/staleness")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--fused", action="store_true",
                    help="solve the refits in the fused kernels (K3 on the card)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    args = ap.parse_args(argv)

    if args.smoke:
        args.d, args.ticks, args.batch, args.ingest = 28, 10, 128, 40
    dev = require_device("cpu" if args.cpu else "cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    if args.classes == 2:
        problem = make_problem(d=args.d, n_signal=max(4, args.d // 8), rho=0.5, device=dev)
        aux0, tick, stats_of = binary_stream(gen, problem, 4 * args.ingest, args.ingest,
                                             args.batch, device=dev)
    else:
        # rho=0.5 matches the binary stream's conditioning: the AR(1)
        # default (0.8) needs a far larger ADMM budget at tol=1e-3
        problem = make_mc_problem(d=args.d, num_classes=args.classes,
                                  n_signal=max(4, args.d // 10), rho=0.5, device=dev)
        aux0, tick, stats_of = mc_stream(gen, problem, args.classes, 4 * args.ingest,
                                         args.ingest, args.batch, device=dev)

    cfg = DantzigConfig(tol=1e-3, fused=args.fused)
    kw = dict(cfg=cfg, staleness_bound=args.staleness_bound, device=dev)
    rt = ServingRuntime(aux0, args.lam, args.lam_prime, args.threshold,
                        protect=not args.unprotected, ckpt_dir=args.ckpt_dir, **kw)
    plan = ServeFaultSchedule(args.corrupt_ingest, args.diverge_refit, args.drop_refresh,
                              args.corrupt_mode, args.seed).plan(args.ticks)
    # the fault-free twin for the chaos contract: same stream, no faults
    twin = (ServingRuntime(aux0, args.lam, args.lam_prime, args.threshold, **kw)
            if args.chaos else None)

    records = []
    for rec in serve_ticks(rt, tick, stats_of, args.ticks, args.refit_every, plan, twin):
        if args.chaos and not rec["finite"]:
            raise SystemExit(f"tick {rec['t']}: non-finite served scores")
        records.append(rec)

    served = sum(r["queries"] for r in records)
    qps = served / max(sum(r["classify_s"] for r in records), 1e-9)
    statuses = [r["status"] for r in records]
    counts = {s: statuses.count(s) for s in ("live", "stale", "degraded")}
    quarantined = sum(not r["accepted"] for r in records)
    acc = sum(r["accuracy"] for r in records) / len(records)
    print(f"served {served} queries over {args.ticks} ticks "
          f"(d={args.d}, K={args.classes}, protect={not args.unprotected}, fused={args.fused}, "
          f"device={dev})")
    print(f"sustained qps (classify wall-clock only): {qps:,.0f}")
    print(f"mean accuracy: {acc:.4f}  status counts: {counts}  "
          f"quarantined batches: {quarantined}  model version: {int(rt.slot.version)}")
    ladder = [e["attempt"] for e in rt.ladder_log if not e["converged"]]
    if ladder:
        print(f"escalations past a failed rung: {ladder}")

    if args.chaos:
        twin_acc = sum(r["twin_accuracy"] for r in records) / len(records)
        drop = twin_acc - acc
        print(f"fault-free twin accuracy: {twin_acc:.4f}  (faulted run within {drop:+.4f})")
        if drop > args.acc_slack:
            raise SystemExit(f"degradation contract violated: accuracy dropped {drop:.4f} "
                             f"> slack {args.acc_slack}")

    if args.ckpt_dir is not None:
        restored = ServingRuntime.restore(args.ckpt_dir, aux0, args.lam, args.lam_prime,
                                          args.threshold, **kw)
        _, z, _ = tick()
        p_live, _ = rt.classify(z)
        p_rest, _ = restored.classify(z)
        if (int(restored.slot.version) == int(rt.slot.version)
                and not bool(torch.equal(p_live, p_rest))):
            raise SystemExit("restore parity violated: same slot version, different predictions")
        print(f"checkpoint restore OK (version {int(restored.slot.version)})")
    if dev.type == "cuda":
        print(card_line(dev))


if __name__ == "__main__":
    main()
