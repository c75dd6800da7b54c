"""End to end on a mesh: Algorithm 1 as it runs across ranks (twin of ``examples/mesh_distributed_lda.py``).

Spawns a (data=4, model=2) mesh of 8 ranks, shards the sample set over
the data axis (each data slice is one of the paper's machines), and
runs the one-shot distributed estimator: the CLIME columns shard over
the model axis inside each machine, and the only traffic between
machines is one mean of a d-vector.  Then it serves batched
classification requests with the fitted rule, and fits the K-class
head on the same mesh, whose round moves one (d, K) block.

Both heads run in the one spawn of the mesh (the K-class fit runs right
after the binary one); serving runs here, on the fitted rule the mesh
returned.  The ranks share one card by gloo, or run on the CPU.

    python -m repro_torch.mesh_distributed_lda          # 8 ranks on the card
    python -m repro_torch.mesh_distributed_lda --cpu    # 8 ranks on the CPU
"""

from __future__ import annotations

import argparse
import math
import time

import torch

from repro_torch.core import classifier
from repro_torch.core import multiclass as mc
from repro_torch.core.dantzig import DantzigConfig
from repro_torch.device import require_device
from repro_torch.launch.mesh import run_on_mesh
from repro_torch.launch.mesh_cases import MeshCase, run_cases
from repro_torch.stats import synthetic


def main(device: str | torch.device = "cuda", d: int = 128, m: int = 4, model: int = 2,
         n_per_machine: int = 500, num_classes: int = 4, cfg: DantzigConfig | None = None,
         seed: int = 0, n_batches: int = 8, batch: int = 512, n_test: int = 2000) -> dict:
    """Fit both heads on a (m, model) mesh, serve, print; returns the fits and the mesh reports.

    The returned dict carries the draws and tuning too, so a caller can
    hold the mesh against the simulated faces on the same split.
    """
    dev = require_device(device)
    cfg = DantzigConfig(max_iters=500) if cfg is None else cfg
    problem = synthetic.make_problem(d=d, n_signal=10, rho=0.8, device=dev)
    n1 = n2 = n_per_machine // 2
    N = m * n_per_machine
    gen = torch.Generator(device=dev).manual_seed(seed)
    xs, ys = synthetic.sample_machines(gen, problem, m, n1, n2, device=dev)
    b1 = float(problem.beta_star.abs().sum())
    lam = 0.3 * math.sqrt(math.log(d) / n_per_machine) * b1
    t = 0.5 * math.sqrt(math.log(d) / N) * b1
    mc_problem = synthetic.make_mc_problem(d=d, num_classes=num_classes, n_signal=8, device=dev)
    mxs, mlabels = synthetic.sample_mc_machines(gen, mc_problem, m, n_per_machine, device=dev)
    b1k = float(mc_problem.betas.abs().sum(0).max())
    lam_k = 0.3 * math.sqrt(math.log(d) / n_per_machine) * b1k
    t_k = 0.5 * math.sqrt(math.log(d) / N) * b1k

    arrays = dict(x=xs.reshape(-1, d).cpu(), y=ys.reshape(-1, d).cpu(),
                  xk=mxs.reshape(-1, d).cpu(), labels=mlabels.reshape(-1).cpu())
    cases = [MeshCase("binary", "binary", dict(lam=lam, lam_prime=lam, t=t, cfg=cfg)),
             MeshCase("multiclass", "multiclass",
                      dict(num_classes=num_classes, lam=lam_k, lam_prime=lam_k, t=t_k, cfg=cfg))]
    print(f"mesh (data={m}, model={model}): {m * model} ranks; each data slice is one of the "
          f"paper's m={m} machines")
    spawned = time.time()
    reports = run_on_mesh(run_cases, m, model, arrays, cases, device=dev.type, backend="gloo")
    spawn_s = max(reports["_started"]) - spawned

    fit = reports["binary"]
    beta = fit["out"].to(dev)
    print(f"one-shot distributed estimate in {max(fit['wall_s']):.2f}s on the slowest rank "
          f"(spawn and init {spawn_s:.1f}s; between machines: one mean of a {d}-vector = "
          f"{4 * d} bytes a worker)")
    f1 = float(classifier.f1_score(beta, problem.beta_star))
    l2 = float(classifier.estimation_errors(beta, problem.beta_star)["l2"])
    support = int((beta != 0).sum())
    print(f"support F1 {f1:.3f}   l2 err {l2:.3f}   support size {support} "
          f"(true {int((problem.beta_star != 0).sum())})")

    # serve batched classification requests with the fitted rule
    mu1, mu2 = xs.reshape(-1, d).mean(0), ys.reshape(-1, d).mean(0)
    served = correct = 0
    t0 = time.perf_counter()
    for _ in range(n_batches):
        z, labels = synthetic.sample_labeled(gen, problem, batch, device=dev)
        correct += int((classifier.fisher_rule(z, beta, mu1, mu2) == labels).sum())
        served += batch
    serve_s = time.perf_counter() - t0
    print(f"served {served} requests in {serve_s:.2f}s ({served / serve_s:.0f} req/s), "
          f"accuracy {correct / served:.3f}")

    fit_k = reports["multiclass"]
    beta_k, means_k = (v.to(dev) for v in fit_k["out"])
    zs, zl = synthetic.sample_mc_machines(gen, mc_problem, 1, n_test, device=dev)
    acc_k = float((mc.mc_classify(zs[0], beta_k, means_k) == zl[0]).float().mean())
    print(f"\nK={num_classes} classes on the same mesh in {max(fit_k['wall_s']):.2f}s "
          f"(between machines: one mean of a ({d}, {num_classes}) block = "
          f"{4 * d * num_classes} bytes a worker), held-out accuracy {acc_k:.3f}")
    return dict(reports=reports, beta=beta, beta_k=beta_k, means_k=means_k, f1=f1, l2=l2,
                support=support, accuracy=correct / served, accuracy_k=acc_k,
                spawn_s=spawn_s, serve_s=serve_s, problem=problem, mc_problem=mc_problem,
                xs=xs, ys=ys, mxs=mxs, mlabels=mlabels, lam=lam, t=t, lam_k=lam_k, t_k=t_k,
                cfg=cfg, z_k=zs[0], labels_k=zl[0])


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true", help="run the ranks on the CPU")
    args = parser.parse_args()
    main(device="cpu" if args.cpu else "cuda")
