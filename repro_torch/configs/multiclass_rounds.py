"""The multiclass and refinement-round designs the port's card runs drive.

Each names the reference benchmark whose ``--paper`` mode defines it.
"""

from typing import NamedTuple


class MulticlassConfig(NamedTuple):
    """``benchmarks/fig_multiclass.py --paper`` (its K = 5 rows, at m = 20): K classes on
    disjoint 5-coordinate mean supports (signal 1.2), AR(0.8), lam = 0.3 sqrt(log d / n) b1
    with b1 the largest column l1 norm of the true directions."""

    d: int = 120
    num_classes: int = 5
    n_signal: int = 5
    rho: float = 0.8
    n_per_machine: int = 400
    m: int = 20
    max_iters: int = 600
    n_test: int = 2000


class RoundsConfig(NamedTuple):
    """``benchmarks/fault_rounds.py --paper``: the paper's §5.1 design at N = 10,000 over
    m = 80 machines (n1 = n2 = 62), AR(0.8), 10 signal coordinates, T = 3 rounds, top-20%
    int8 uplinks (k_top = d // 5), 10% dropout, lam = lam' = 0.3 sqrt(log d / n) b1."""

    d: int = 200
    rho: float = 0.8
    n_signal: int = 10
    N: int = 10_000
    m: int = 80
    rounds: int = 3
    max_iters: int = 600
    dropout: float = 0.1


MULTICLASS = MulticlassConfig()
ROUNDS = RoundsConfig()
