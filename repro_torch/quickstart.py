"""Quickstart: the paper's Algorithm 1 on the port (twin of ``examples/quickstart.py``).

Generates the synthetic design of §5.1 (AR(0.8) covariance, sparse
discriminant direction), runs the distributed, centralized and naive
averaged estimators, and prints support recovery, estimation error and
misclassification rate.

    python -m repro_torch.quickstart            # on the card
    python -m repro_torch.quickstart --cpu      # plain PyTorch on the CPU
"""

from __future__ import annotations

import argparse
import math

import torch

from repro_torch.core import classifier
from repro_torch.core.dantzig import DantzigConfig
from repro_torch.core.distributed import (
    simulated_distributed_slda,
    simulated_naive_averaged_slda,
)
from repro_torch.core.slda import centralized_slda, hard_threshold
from repro_torch.device import require_device
from repro_torch.stats import synthetic

METHODS = ("distributed (paper)", "centralized", "naive averaged")


def tuning(beta_star: torch.Tensor, d: int, n_per_machine: int, N: int):
    """(lam, lam_c, t): the worker box radius, the centralized one and the HT threshold."""
    b1 = float(beta_star.abs().sum())
    lam = 0.3 * math.sqrt(math.log(d) / n_per_machine) * b1  # worker scale
    lam_c = 0.3 * math.sqrt(math.log(d) / N) * b1            # centralized scale
    t = 0.5 * math.sqrt(math.log(d) / N) * b1                # HT threshold
    return lam, lam_c, t


def estimators(xs, ys, lam, lam_c, t, cfg: DantzigConfig, use_kernel: bool | None = None):
    """The three estimators of the table, keyed by the names in ``METHODS``."""
    d = xs.shape[-1]
    dist = simulated_distributed_slda(xs, ys, lam, lam, t, cfg, use_kernel=use_kernel)
    naive = simulated_naive_averaged_slda(xs, ys, lam, cfg, use_kernel=use_kernel)
    cent = hard_threshold(
        centralized_slda(xs.reshape(-1, d), ys.reshape(-1, d), lam_c, cfg,
                         use_kernel=use_kernel), 0.5 * t)
    return dict(zip(METHODS, (dist, cent, naive)))


def metrics(betas: dict, beta_star, z, labels, mu1, mu2) -> dict:
    """{method: (F1, l2 error, linf error, misclassification rate)} as floats."""
    rows = {}
    for name, beta in betas.items():
        err = classifier.estimation_errors(beta, beta_star)
        rows[name] = (float(classifier.f1_score(beta, beta_star)), float(err["l2"]),
                      float(err["linf"]),
                      float(classifier.misclassification_rate(z, labels, beta, mu1, mu2)))
    return rows


def format_table(rows: dict) -> str:
    lines = [f"{'method':<22}{'F1':>6}{'l2 err':>9}{'linf err':>10}{'misclass':>10}"]
    for name, (f1, l2, linf, rate) in rows.items():
        lines.append(f"{name:<22}{f1:>6.3f}{l2:>9.3f}{linf:>10.3f}{rate:>10.3f}")
    return "\n".join(lines)


def main(device: str | torch.device = "cuda", d: int = 120, m: int = 8,
         n_per_machine: int = 400, cfg: DantzigConfig | None = None, seed: int = 0,
         n_test: int = 4000) -> dict:
    """Draw the §5.1 design, run the three estimators, print and return the table rows."""
    dev = require_device(device)
    cfg = DantzigConfig(max_iters=500) if cfg is None else cfg
    problem = synthetic.make_problem(d=d, n_signal=10, rho=0.8, device=dev)
    n1 = n2 = n_per_machine // 2
    N = m * n_per_machine
    gen = torch.Generator(device=dev).manual_seed(seed)
    xs, ys = synthetic.sample_machines(gen, problem, m, n1, n2, device=dev)
    lam, lam_c, t = tuning(problem.beta_star, d, n_per_machine, N)
    betas = estimators(xs, ys, lam, lam_c, t, cfg)
    z, labels = synthetic.sample_labeled(gen, problem, n_test, device=dev)
    mu1 = xs.reshape(-1, d).mean(0)
    mu2 = ys.reshape(-1, d).mean(0)
    rows = metrics(betas, problem.beta_star, z, labels, mu1, mu2)
    print(f"d={d}  machines={m}  N={N}   (communication: one {d}-float vector per worker)")
    print(format_table(rows))
    return rows


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    args = parser.parse_args()
    main(device="cpu" if args.cpu else "cuda")
