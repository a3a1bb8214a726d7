"""Dynamic fan-beam CT: ``nt`` frames, each imaged at ``views`` angles
that turn by ``angle_step_deg`` from frame to frame; the block-diagonal
system over the frames.

``data`` and ``reference_matrix`` are the benchmark's (plain NumPy);
``build`` is the program's set-up: the port's matrix builder per frame and
the frame-varying banded pack (one launch of K1-K3 over all frames).
"""
from __future__ import annotations

import numpy as np
from scipy import sparse as sp

from ..reference import phantoms, siddon


def angles(cfg):
    step = np.deg2rad(cfg["angle_step_deg"])
    return [step * t + np.linspace(0, np.pi, cfg["views"], endpoint=False)
            for t in range(cfg["nt"])]


def _frames(cfg, builder):
    return [builder(cfg["nx"], th, cfg["det_count"], cfg["det_spacing"],
                    cfg["source_origin"], cfg["origin_det"])
            for th in angles(cfg)]


def data(cfg):
    """The frames (frame-major) and their noise-free sinograms (float64,
    host), both taken with the reconstruction's own matrices."""
    x = getattr(phantoms, cfg["phantom"])(cfg["nx"], cfg["nt"])
    b = np.concatenate([A @ xt for A, xt in
                        zip(_frames(cfg, siddon.fan_beam_matrix), x)])
    return x.reshape(-1), b


def reference_matrix(cfg):
    return sp.block_diag(_frames(cfg, siddon.fan_beam_matrix), format="csr")


def dims(cfg):
    return (cfg["nx"], cfg["nx"], cfg["nt"])


def build(cfg, device, dtype):
    """(operator, nonzeros of the host matrices) of the program."""
    from trips_tpu_torch.problems.projector import fan_beam_matrix
    from trips_tpu_torch.sparse import DynamicBandedOperator

    def port(nx, th, p, d, so, od):
        return fan_beam_matrix(nx, nx, angles=th, det_count=p, det_width=d,
                               source_origin=so, origin_det=od)

    AA = _frames(cfg, port)
    op = DynamicBandedOperator.from_frames(
        AA, cfg["nx"], angles(cfg), n_groups=cfg["n_groups"], dtype=dtype,
        device=device)
    return op, sum(A.nnz for A in AA)
