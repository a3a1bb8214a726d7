"""Static fan-beam CT through the port's matrix-free shear-rotate projector:
the scan of ``fan_static`` (its data, taken with the Siddon matrix at the
shifted angles), reconstructed with ``ShearFanProjector`` in place of a
stored matrix.

``data`` and ``reference_matrix`` are the benchmark's (plain NumPy, no
import of the program); ``build`` is the program's set-up from the
geometry: the operator's constant ``G`` and shifts on the device, with
``normal_matvec`` as the configuration states it (``fused_ata``).
"""
from __future__ import annotations

from ..reference import shear_fan
from .fan_static import angles, data, dims  # noqa: F401  (the same scan)


def _geometry(cfg):
    return dict(det_count=cfg["det_count"], det_spacing=cfg["det_spacing"],
                source_origin=cfg["source_origin"],
                origin_det=cfg["origin_det"])


def _check(cfg):
    """The operator's detector count is the reference geometry's, which the
    kernels' rooflines count by (``shear_fan.canvas_views``)."""
    if cfg["det_count"] != shear_fan.det_count(cfg["nx"]):
        raise ValueError(f"fan_shear: det_count {cfg['det_count']} is not "
                         f"the reference geometry's "
                         f"{shear_fan.det_count(cfg['nx'])} for nx "
                         f"{cfg['nx']}")


def reference_matrix(cfg):
    """A, worked out again from the geometry (float64 CSR)."""
    _check(cfg)
    return shear_fan.shear_fan_matrix(cfg["nx"], angles(cfg),
                                      **_geometry(cfg))


def build(cfg, device, dtype):
    """(operator, nonzeros of G as the reference counts them) of the
    program; ``dtype`` is the storage type of G and of the rotated
    canvases."""
    import torch

    from trips_tpu_torch.operators import ShearFanProjector

    _check(cfg)
    op = ShearFanProjector(
        cfg["nx"], angles=angles(cfg), det_count=cfg["det_count"],
        det_width=cfg["det_spacing"], source_origin=cfg["source_origin"],
        origin_det=cfg["origin_det"], dtype=torch.float32,
        g_dtype=getattr(torch, dtype), fused_ata=cfg["fused_ata"],
        device=device)
    return op, shear_fan.g_nonzeros(cfg["nx"], **_geometry(cfg))
