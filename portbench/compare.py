"""The numbers the correctness check compares: widest gaps of the port's answers from the reference's.

Every gap is relative to the largest magnitude of the reference's own
answer, so one limit serves answers of any scale.  A missing or
non-finite answer reads as infinity.
"""

from __future__ import annotations

import math

import torch


def _scale(ref: torch.Tensor) -> torch.Tensor:
    return ref.abs().max().clamp_min(torch.finfo(ref.dtype).tiny)


def _value(x: torch.Tensor) -> float:
    v = float(x)
    return math.inf if math.isnan(v) else v


def rel_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max |want|."""
    return _value((got - want).abs().max() / _scale(want))


def thresholded_gap(got: torch.Tensor, raw: torch.Tensor, t: float, limit: float) -> float:
    """Widest gap of ``got``, a hard-thresholded vector, from HT(raw, t), relative to max |raw|.

    An entry of ``raw`` whose magnitude lies within ``limit`` (relative)
    of the threshold may land on either side of it in a sound run, so
    there the nearer of 0 and the raw value counts.
    """
    scale = _scale(raw)
    want = torch.where(raw.abs() > t, raw, torch.zeros_like(raw))
    gap = (got - want).abs()
    other = (got - torch.where(want == 0, raw, torch.zeros_like(raw))).abs()
    near = (raw.abs() - t).abs() <= limit * scale
    return _value(torch.where(near, torch.minimum(gap, other), gap).max() / scale)


def pred_gap(pred: torch.Tensor, scores: torch.Tensor) -> float:
    """Widest margin by which the reference scores a predicted class below its best one,
    relative to the largest score magnitude: 0 when every prediction is the reference's argmax."""
    best = scores.max(-1).values
    chosen = torch.take_along_dim(scores, pred.long().unsqueeze(-1), dim=-1)[..., 0]
    return _value((best - chosen).max() / _scale(scores))


def verdict(checks: dict, limits: dict) -> bool:
    """True when every compared number is at most its limit (a number with no limit fails)."""
    return all(name in limits and value <= limits[name] for name, value in checks.items())
