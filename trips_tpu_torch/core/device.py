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


def svd(M, full_matrices=True):
    """``torch.linalg.svd``, on the card with cuSOLVER's QR-iteration
    driver ``gesvd``, the algorithm LAPACK runs at these sizes.

    PyTorch's default there is Jacobi (``gesvdj``, batched for matrices up
    to 32 x 32). Its float32 factors of the fused solvers' projected
    pencils are far from LAPACK's: on the 1D deblurring demo the GCV
    curve of fused GKS's last iteration came out 25 times lower at small
    lam, and the solve ended at relError 0.060, where the CPU, JAX and
    ``gesvd`` end at 0.024 (``demo_reference.py deblur_probe``, NVIDIA
    H100 80GB HBM3, 700 W: 2.1 ms a call of 18 x 18 against 0.25 ms)."""
    return torch.linalg.svd(M, full_matrices=full_matrices,
                            driver="gesvd" if M.is_cuda else None)


def check_operators(dev, *ops):
    """Raise unless every operator given (None skipped) lives on ``dev``'s
    device type: a solve on ``dev`` does not move them."""
    for op in ops:
        if op is not None and torch.device(op.device).type != dev.type:
            raise ValueError(f"operator on {op.device}, solve asked on {dev}")
