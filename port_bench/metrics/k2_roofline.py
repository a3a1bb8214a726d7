"""K2's share of its roofline (``csrc/banded.cu`` ``fwd_kernel``, the
product A x): the least time one apply can take on the card, its least
bytes at the peak HBM bandwidth, over K2's mean device time per launch in
the traced sub-window. Moves ``recon_per_s``.

The least bytes are counted from A, whatever layout the pack gives it:
each nonzero's value once at the cell's storage width, the image read
once and the sinogram written once, both in float32. A x does 2 flops per
nonzero, far under the card's float32 peak at these bytes, so the bytes
bound it. ``k1_roofline`` says why an L2-resident A could read above
100%."""

from .k1_roofline import HBM_BYTES_PER_S

KERNEL = "fwd_kernel"


def least_bytes(nnz, n, m, value_bytes):
    return nnz * value_bytes + (n + m) * 4


def read(run):
    us = [d for name, _, d in run.kernels if KERNEL in name]
    if not us or run.m is None:
        return None
    bound_s = least_bytes(run.nnz, run.n, run.m,
                          run.value_bytes) / HBM_BYTES_PER_S
    return 100.0 * bound_s / (sum(us) / len(us) / 1e6)
