"""Classify-as-a-service in plain PyTorch: the same three verbs as the port's serving runtime.

* ``classify``: scores (z - c_k / 2)^T beta_k + log pi_k for the two
  columns beta_1 = beta / 2, beta_2 = -beta / 2 with anchors
  c_k = mu_k + (mu1 + mu2) / 2, and the argmax.
* ``ingest``: a batch is accepted when every entry of its raw arrays is
  finite and within the envelope; an accepted batch's statistics are
  merged into the running ones: counts add, means are count-weighted,
  and the pooled scatters add with each class's rank-1 mean-shift term
  n_a n_b / (n_a + n_b) (mu_a - mu_b)(mu_a - mu_b)^T.
* ``refresh``: from the merged statistics, one eigendecomposition, both
  solves gated at ``tol`` (CLIME in blocks of ``gate_block_cols``
  columns), warm from the last published refit's ADMM state,
  then cold, then on the symmetrized covariance with ``refactor_scale``
  times the iterations; the first attempt whose output is finite and
  whose solves stopped before their cap is debiased, thresholded at
  ``threshold`` and published with the next version.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from portbench.reference import admm
from portbench.reference.fit import hard_threshold, pooled_stats


class Slot(NamedTuple):
    beta: torch.Tensor  # (d, 2) the two score columns
    means: torch.Tensor  # (2, d) anchors
    priors: torch.Tensor  # (2,)
    version: int
    raw: torch.Tensor  # (d,) the debiased direction before the threshold


class Stats(NamedTuple):
    sigma: torch.Tensor  # (d, d) pooled within-class covariance
    mu1: torch.Tensor
    mu2: torch.Tensor
    n1: float
    n2: float


def stats_of(x, y, mm) -> Stats:
    sigma, mu1, mu2 = pooled_stats(x, y, mm)
    return Stats(sigma, mu1, mu2, float(x.shape[0]), float(y.shape[0]))


def merge(a: Stats, b: Stats) -> Stats:
    na, nb = a.n1 + a.n2, b.n1 + b.n2
    scatter = a.sigma * na + b.sigma * nb
    for ma, ka, mb, kb in ((a.mu1, a.n1, b.mu1, b.n1), (a.mu2, a.n2, b.mu2, b.n2)):
        delta = ma - mb
        scatter = scatter + (ka * kb / (ka + kb)) * torch.outer(delta, delta)
    return Stats(scatter / (na + nb), (a.n1 * a.mu1 + b.n1 * b.mu1) / (a.n1 + b.n1),
                 (a.n2 * a.mu2 + b.n2 * b.mu2) / (a.n2 + b.n2), a.n1 + b.n1, a.n2 + b.n2)


class Server:
    """``publish_unconverged`` (the control's) publishes the last attempt when every rung fails,
    and reports it published: in TF32 the solves do not reach ``tol``, and the control still has
    to give numbers to read."""

    def __init__(self, x, y, c: dict, mm, publish_unconverged: bool = False):
        self.c, self.mm = c, mm
        self.publish_unconverged = publish_unconverged
        self.stats = stats_of(x, y, mm)
        self.carry = None
        self.slot = None
        if not self.refresh():
            raise RuntimeError("reference: the seed fit did not converge")

    def classify(self, z: torch.Tensor):
        s = self.slot
        scores = (self.mm(z, s.beta) - 0.5 * torch.sum(s.means * s.beta.mT, dim=-1)
                  + torch.log(s.priors))
        return scores.argmax(-1), scores

    def ingest(self, x: torch.Tensor, y: torch.Tensor) -> bool:
        env = self.c["envelope"]
        ok = all(bool((torch.isfinite(a) & (a.abs() <= env)).all()) for a in (x, y))
        if ok:
            self.stats = merge(self.stats, stats_of(x, y, self.mm))
        return ok

    def _attempt(self, sigma, rhs, iters, carry):
        c, mm = self.c, self.mm
        f = admm.factor(sigma)
        eye = torch.eye(sigma.shape[-1], dtype=sigma.dtype, device=sigma.device)
        kw = dict(iters=iters, mm=mm, tol=c["tol"], check_every=c["check_every"])
        beta_hat, st_b, n_b = admm.solve(f, rhs, c["lam"], state=carry and carry[0], **kw)
        theta, st_t, n_t = admm.solve(f, eye, c["lam_prime"], block=c["gate_block_cols"],
                                      state=carry and carry[1], **kw)
        tilde = beta_hat - mm(theta.mT, mm(sigma, beta_hat) - rhs)
        ok = (bool(torch.isfinite(tilde).all() & torch.isfinite(theta).all())
              and max(int(n_b.max()), int(n_t.max())) < iters)
        return ok, tilde[:, 0], (st_b, st_t)

    def refresh(self) -> bool:
        c = self.c
        sigma, mu1, mu2, n1, n2 = self.stats
        rhs = (mu1 - mu2).unsqueeze(-1)
        # the rungs: warm (with a carry), cold, then the symmetrized matrix with more iterations
        ladder = [(sigma, c["max_iters"], None),
                  (0.5 * (sigma + sigma.mT), c["max_iters"] * c["refactor_scale"], None)]
        if self.carry is not None:
            ladder.insert(0, (sigma, c["max_iters"], self.carry))
        for sig, iters, carry in ladder[:c["max_attempts"]]:
            ok, tilde, carry = self._attempt(sig, rhs, iters, carry)
            if ok:
                break
        else:
            if not self.publish_unconverged:
                return False
        beta = hard_threshold(tilde, c["threshold"])
        mu_bar = 0.5 * (mu1 + mu2)
        priors = torch.tensor([n1, n2], dtype=torch.float32, device=sigma.device) / (n1 + n2)
        version = 1 if self.slot is None else self.slot.version + 1
        self.slot = Slot(torch.stack([0.5 * beta, -0.5 * beta], dim=1),
                         torch.stack([mu1 + mu_bar, mu2 + mu_bar]), priors, version, tilde)
        self.carry = carry
        return True
