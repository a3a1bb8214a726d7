"""K4's share of its roofline (``csrc/shear.cu`` ``rotate_tile_kernel``,
the shear rotation of ``ShearFanProjector``): the least time one apply can
take on the card, its least bytes at the peak HBM bandwidth, over K4's
mean device time per launch in the traced sub-window. Moves
``recon_per_s``.

The least bytes are the work's own: the three float32 quarter-turned
canvases read once and the stack of rotated canvases, one a view, written
once at the cell's storage width (G's). The shifts (4 x views x C values,
about 1% of it) are left out. Three 2-tap shears are about 12 flops an
output, far under the card's peak at these bytes, so the bytes bound it.
The canvas side and the views come from the operator's shape in the
reference geometry (``reference.shear_fan.canvas_views``).

Kernels are matched by their exact short name, so K5's
``rotate_adj_tile_kernel`` is not K4's."""

from ..harness import short_name
from ..reference.shear_fan import canvas_views
from .k1_roofline import HBM_BYTES_PER_S

KERNELS = ("rotate_tile_kernel",)


def least_bytes(C, views, value_bytes):
    return 3 * C * C * 4 + views * C * C * value_bytes


def us_per_apply(run, first, rest=()):
    """Mean device microseconds of an apply: every launch named in
    ``first`` or ``rest`` over the launches named in ``first`` (one an
    apply); None where none ran."""
    applies, us = 0, 0.0
    for name, _, d in run.kernels:
        k = short_name(name)
        if k in first:
            applies, us = applies + 1, us + d
        elif k in rest:
            us += d
    return us / applies if applies else None


def read(run):
    us = us_per_apply(run, KERNELS)
    dims = canvas_views(run.n, run.m) if run.m else None
    if us is None or dims is None:
        return None
    _, C, views = dims
    bound_s = least_bytes(C, views, run.value_bytes) / HBM_BYTES_PER_S
    return 100.0 * bound_s / (us / 1e6)
