"""Algorithm 1's estimators on tensors (twin of ``repro.core``)."""
