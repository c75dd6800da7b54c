"""PyTorch/CUDA port of the distributed sparse-LDA system.

The JAX package ``repro`` (under ``src/``) is the reference; this
package mirrors its layout (``repro_torch/core/pipeline.py`` is the
twin of ``src/repro/core/pipeline.py``) and imports neither ``jax`` nor
``repro``.  Machines are a leading tensor axis written out (the
reference's ``vmap``), the Pallas TPU kernels are hand-written Hopper
kernels under :mod:`repro_torch.kernels`, and everything runs in f32.

TF32 is switched off here, once, for the whole port: it keeps about
three decimal digits and would break every 1e-5 parity pin against
the reference.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
