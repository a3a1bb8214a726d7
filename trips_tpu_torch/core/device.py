"""The device an entry point puts its tensors on.

Entry points run on the CUDA card unless the caller asks for the CPU with
``device="cpu"``; without a card they raise at construction, before any
tensor is made, rather than run on the CPU unasked.
"""
from __future__ import annotations

import torch

DEFAULT = "cuda"


def resolve(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device needs a card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} asked for (the default), but no CUDA card "
            f"is available: pass device='cpu' to run on the CPU")
    return dev
