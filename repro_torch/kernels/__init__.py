"""Hand-written Hopper kernels and their plain PyTorch versions (twin of ``repro.kernels``).

- ``gram`` (K1, CUDA C++): mean-centered Gram/covariance accumulation.
- ``dantzig_fused`` (K2 and K3, CUDA C++): the whole ADMM Dantzig/CLIME
  solve, machines and column blocks in one grid; K2 runs fixed
  iterations from zero, K3 resumes a warm state and can stop each
  column block at a residual tolerance.
- ``soft_threshold`` (K4, CUDA C++): the ADMM shrink step of the scan solver.
- ``spectral``: the SpectralFactor every solver entry point accepts.

Each kernel's plain version is in :mod:`repro_torch.kernels.ref`, and
:mod:`repro_torch.kernels.ops` picks between them by the tensor's device.
"""
