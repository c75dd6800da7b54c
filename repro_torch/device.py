"""Where the port's entry points create their tensors."""

from __future__ import annotations

import torch


def require_device(device: str | torch.device) -> torch.device:
    """``device`` as a :class:`torch.device`; raises when it is CUDA and no card is present.

    Entry points default to ``"cuda"`` and never drop to the CPU on
    their own: a caller that wants the CPU says so.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this machine; pass device='cpu' to run "
            "the port's plain PyTorch path on the CPU")
    return dev
