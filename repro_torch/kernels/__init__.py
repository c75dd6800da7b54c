"""Hand-written Hopper kernels and their plain PyTorch versions (twin of ``repro.kernels``).

- ``gram`` (K1, CUDA C++): mean-centered Gram/covariance accumulation.
- ``dantzig_fused`` (K2, CUDA C++): the whole fixed-iteration ADMM
  Dantzig/CLIME solve, machines and column blocks in one grid.
- ``soft_threshold`` (K4, Triton): the ADMM shrink step of the scan solver.
- ``spectral``: the SpectralFactor every solver entry point accepts.

Each kernel's plain version is in :mod:`repro_torch.kernels.ref`, and
:mod:`repro_torch.kernels.ops` picks between them by the tensor's device.
"""
