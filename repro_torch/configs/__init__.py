"""Experiment configs for the paper's own studies (twin of ``repro.configs``)."""

from repro_torch.configs.paper_synthetic import (  # noqa: F401
    FIXED_N,
    REAL,
    SYNTHETIC,
    FixedNConfig,
    RealDataConfig,
    SyntheticConfig,
)
