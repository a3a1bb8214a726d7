"""K1's share of its roofline (``csrc/banded.cu``, the fused A^T A apply):
the least time one apply can take on the card, its least bytes at the
peak HBM bandwidth, over K1's mean device time per apply in the traced
sub-window. Moves ``recon_per_s``.

An apply is two launches of ``banded.cu``: ``ata_kernel``, then
``fixed_to_float``, which writes the image out of the fixed-point
accumulator (it follows K3's ``adj_kernel`` too; those are not K1's). The
apply's zeroing of the accumulator and its max|x| run as PyTorch kernels,
not told apart by name, and are left out: a few microseconds.

The least bytes are counted from A, whatever layout the pack gives it:
each nonzero's value once at the cell's storage width, and the image read
once and written once in float32. A^T A x does 4 flops per nonzero, far
under the card's float32 peak at these bytes, so the bytes bound it.

These least bytes (20.8 MB tomo256x60, 32.3 MB dyn128x33) fit in the
card's 50 MB L2, which a replayed loop could keep A in from apply to
apply; the ceiling is still HBM's, since no L2 bandwidth is published.
A pack that shrinks towards A's nonzeros could then read above 100%."""

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet, 700 W
KERNEL = "ata_kernel"
FINISH = "fixed_to_float"
OTHERS = ("adj_kernel", "fwd_kernel")


def least_bytes(nnz, n, value_bytes):
    return nnz * value_bytes + 2 * n * 4


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
    if not applies:
        return None
    bound_s = least_bytes(run.nnz, run.n, run.value_bytes) / HBM_BYTES_PER_S
    return 100.0 * bound_s / (us / applies / 1e6)
