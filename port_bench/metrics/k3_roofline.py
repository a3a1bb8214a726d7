"""K3's share of its roofline (``csrc/banded.cu``, the product A^T y): the
least time one apply can take on the card, at ``k2_roofline``'s least
bytes (A's values once, the sinogram read and the image written once in
float32), over K3's mean device time per apply in the traced sub-window.
Moves ``recon_per_s``.

An apply is two launches, as K1's is: ``adj_kernel``, then the
``fixed_to_float`` that writes the image out of the fixed-point
accumulator (the one after K1's ``ata_kernel`` is not K3's)."""

from .k1_roofline import FINISH, HBM_BYTES_PER_S
from .k2_roofline import least_bytes

KERNEL = "adj_kernel"
OTHERS = ("ata_kernel", "fwd_kernel")


def read(run):
    applies, us, last = 0, 0.0, None
    for name, _, d in run.kernels:  # in the order they started
        if KERNEL in name:
            applies, us, last = applies + 1, us + d, KERNEL
        elif FINISH in name:
            us += d if last == KERNEL else 0.0
            last = None
        elif any(k in name for k in OTHERS):
            last = None
    if not applies or run.m is None:
        return None
    bound_s = least_bytes(run.nnz, run.n, run.m,
                          run.value_bytes) / HBM_BYTES_PER_S
    return 100.0 * bound_s / (us / applies / 1e6)
