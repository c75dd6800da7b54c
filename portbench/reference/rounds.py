"""Masked multi-round refinement in plain PyTorch.

The machines' solves are the one-shot fit's (:func:`fit.solves`), made
once.  With anchor_1 each machine's own beta_hat, every round t = 1..T:

* each machine's correction around its anchor, ``fit.debias``;
* a machine's weight is 1 where it is live in round t and its whole
  correction is finite, else 0;
* the aggregate is the sum of the weighted machines' corrections over
  max(sum of weights, 1), or the last good aggregate (zeros before any)
  where no machine has weight;
* the aggregate is every machine's next anchor.

Leading dimensions are datasets; machines are the axis before (d, 1).
"""

from __future__ import annotations

import torch

from portbench.reference import fit


def refine(s: fit.Solves, live: torch.Tensor, mm) -> torch.Tensor:
    """The (..., T, d) aggregates of every round; ``live`` (..., m, T) is 1 where a machine's
    uplink arrives in a round and 0 where it is dropped."""
    anchor = s.beta_hat  # (..., m, d, 1)
    last = torch.zeros_like(anchor[..., 0, :, :])
    out = []
    for t in range(live.shape[-1]):
        corr = fit.debias(s, anchor, mm)
        w = (live[..., t] > 0) & torch.isfinite(corr).all(-1).all(-1)  # (..., m)
        num = torch.where(w[..., None, None], corr, torch.zeros_like(corr)).sum(-3)
        den = w.to(corr.dtype).sum(-1)[..., None, None]
        last = torch.where(den > 0, num / den.clamp_min(1.0), last)
        out.append(last[..., 0])
        anchor = last.unsqueeze(-3).expand_as(anchor)
    return torch.stack(out, -2)


def fit_rounds(xs, ys, live, *, lam, lam_prime, iters: int, mm) -> torch.Tensor:
    """The (..., T, d) aggregates, before the threshold, of T masked rounds on the machines'
    samples xs (..., m, n1, d), ys (..., m, n2, d)."""
    return refine(fit.solves(xs, ys, lam, lam_prime, iters, mm), live, mm)
