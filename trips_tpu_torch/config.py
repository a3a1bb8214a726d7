"""Global configuration for trips_tpu_torch.

Counterpart of ``trips_tpu/config.py``. The reference library (TRIPs-Py)
runs float64 NumPy on the CPU; the port runs float32 on the CUDA card and
float64 where a caller (the CPU tests) asks for it.
"""
from __future__ import annotations

import torch


def default_dtype():
    """torch's default floating dtype (float32 unless the caller set
    another with ``torch.set_default_dtype``)."""
    return torch.get_default_dtype()


def is_cuda() -> bool:
    """Whether a CUDA card is there (the JAX package's ``is_tpu``)."""
    return torch.cuda.is_available()


# Padding granularity kept from the JAX package (the TPU's lane and sublane
# widths): the banded packs pad their detector axis to LANE.
LANE = 128
SUBLANE = 8


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m
