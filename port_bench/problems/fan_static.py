"""Static fan-beam CT: one image, one fixed geometry.

``data`` and ``reference_matrix`` are the benchmark's (plain NumPy, no
import of the program); ``build`` is the program's set-up from the
geometry to the packed operator on the device: the port's matrix builder
and the bucketed banded pack of K1-K3.
"""
from __future__ import annotations

import numpy as np

from ..reference import phantoms, siddon


def angles(cfg):
    return np.linspace(0, np.pi, cfg["views"], endpoint=False)


def _geometry(cfg):
    return dict(det_count=cfg["det_count"], det_width=cfg["det_spacing"],
                source_origin=cfg["source_origin"],
                origin_det=cfg["origin_det"])


def data(cfg):
    """The true image and its noise-free sinogram (float64, host), the
    data taken at the angles shifted by ``data_angle_shift`` as the
    upstream demo does to avoid the inverse crime."""
    nx = cfg["nx"]
    x = phantoms.grains(nx, seed=cfg["phantom_seed"]).reshape(-1)
    A = siddon.fan_beam_matrix(nx, angles(cfg) + cfg["data_angle_shift"],
                               **_geometry(cfg))
    return x, A @ x


def reference_matrix(cfg):
    """A, worked out again from the geometry (float64 CSR)."""
    return siddon.fan_beam_matrix(cfg["nx"], angles(cfg), **_geometry(cfg))


def dims(cfg):
    return (cfg["nx"], cfg["nx"], 1)


def build(cfg, device, dtype):
    """(operator, nonzeros of the host matrix A) of the program."""
    from trips_tpu_torch.problems.projector import fan_beam_matrix
    from trips_tpu_torch.sparse import BucketedBandedProjector

    nx, th = cfg["nx"], angles(cfg)
    A = fan_beam_matrix(nx, nx, angles=th, **_geometry(cfg))
    op = BucketedBandedProjector.from_scipy_fan(
        A, nx, views=None, angles=th, n_groups=cfg["n_groups"],
        n_buckets=cfg["n_buckets"], dtype=dtype, device=device)
    return op, A.nnz
