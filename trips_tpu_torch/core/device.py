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


def check_operators(dev, *ops):
    """Raise unless every operator given (None skipped) lives on ``dev``'s
    device type: a solve on ``dev`` does not move them."""
    for op in ops:
        if op is not None and torch.device(op.device).type != dev.type:
            raise ValueError(f"operator on {op.device}, solve asked on {dev}")
