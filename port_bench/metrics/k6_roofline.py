"""K6's share of its roofline (``csrc/shear.cu``, the fused stage-B
contraction ``(R G) G^T`` of ``ShearFanProjector.normal_matvec``: the
first product ``ata_p1_tf32`` or ``ata_p1_wgmma``, the sum of its split
``ata_reduce_kernel``, the second product ``ata_p2_tf32`` or
``ata_p2_wgmma``): the least time one apply can take on the card, its
least bytes at the peak HBM bandwidth, over K6's mean device time per
apply (the three launches) in the traced sub-window. Moves
``recon_per_s``.

The least bytes are the work's own, not the layout's: the stack of
rotated canvases read once at the cell's storage width and written once
in float32, and G's nonzero weights (``run.nnz``, counted by the
reference) once at its width. The kernels stream G whole, zeros included
(99.6% of it at tomo256x60_shear), so a K6 that skips them cannot read
above 100%. At G's nonzeros the flops (4 an entry a view) are far under
the card's peak, so the bytes bound it."""

from ..reference.shear_fan import canvas_views
from .k1_roofline import HBM_BYTES_PER_S
from .k4_roofline import us_per_apply

KERNELS = ("ata_p1_tf32", "ata_p1_wgmma")
REST = ("ata_reduce_kernel", "ata_p2_tf32", "ata_p2_wgmma")


def least_bytes(C, views, g_nnz, value_bytes):
    return views * C * C * (value_bytes + 4) + g_nnz * value_bytes


def read(run):
    us = us_per_apply(run, KERNELS, REST)
    dims = canvas_views(run.n, run.m) if run.m else None
    if us is None or dims is None:
        return None
    _, C, views = dims
    bound_s = least_bytes(C, views, run.nnz,
                          run.value_bytes) / HBM_BYTES_PER_S
    return 100.0 * bound_s / (us / 1e6)
