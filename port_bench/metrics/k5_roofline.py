"""K5's share of its roofline (``csrc/shear.cu``, the rotation's exact
adjoint: ``rotate_adj_tile_kernel``, then ``rotate_adj_reduce``, which sums
its blocks' partial planes per quarter turn), at ``k4_roofline``'s least
bytes: the stack of canvases read once at the cell's storage width and the
three float32 quarters written once. The partial planes are the layout's,
not the work's. Over K5's mean device time per apply (both launches) in
the traced sub-window. Moves ``recon_per_s``."""

from ..reference.shear_fan import canvas_views
from .k1_roofline import HBM_BYTES_PER_S
from .k4_roofline import least_bytes, us_per_apply

KERNELS = ("rotate_adj_tile_kernel",)
FINISH = ("rotate_adj_reduce",)


def read(run):
    us = us_per_apply(run, KERNELS, FINISH)
    dims = canvas_views(run.n, run.m) if run.m else None
    if us is None or dims is None:
        return None
    _, C, views = dims
    bound_s = least_bytes(C, views, run.value_bytes) / HBM_BYTES_PER_S
    return 100.0 * bound_s / (us / 1e6)
