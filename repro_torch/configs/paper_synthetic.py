"""The paper's own experimental configs (section 5)."""

from typing import NamedTuple


class SyntheticConfig(NamedTuple):
    d: int = 200
    rho: float = 0.8
    n_signal: int = 10
    N: int = 10_000
    r: float = 0.5  # n1 / n
    machines: tuple = (1, 5, 10, 20, 50, 100)
    repeats: int = 20


class FixedNConfig(NamedTuple):
    d: int = 200
    rho: float = 0.8
    n_signal: int = 10
    n_per_machine: int = 200
    machines: tuple = (1, 5, 10, 20, 50)
    repeats: int = 20


class RealDataConfig(NamedTuple):
    """UCI Heart-Disease surrogate (offline container; see DESIGN.md)."""

    n: int = 920
    d: int = 22
    sites: int = 4
    repeats: int = 10


SYNTHETIC = SyntheticConfig()
FIXED_N = FixedNConfig()
REAL = RealDataConfig()
