"""Experiment configs for the paper's own studies (twin of ``repro.configs``) and the
multiclass, refinement-round and serving designs of the reference's benchmarks."""

from repro_torch.configs.multiclass_rounds import (  # noqa: F401
    MULTICLASS,
    ROUNDS,
    MulticlassConfig,
    RoundsConfig,
)

from repro_torch.configs import paper_synthetic
from repro_torch.configs.paper_synthetic import (  # noqa: F401
    FIXED_N,
    REAL,
    SYNTHETIC,
    FixedNConfig,
    RealDataConfig,
    SyntheticConfig,
)
from repro_torch.configs.serving import SERVING, ServingConfig  # noqa: F401

# the reference's name for the paper's section-5 grid module
PAPER_SYNTHETIC = paper_synthetic
