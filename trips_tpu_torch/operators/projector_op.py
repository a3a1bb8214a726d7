"""Matrix-free on-the-fly tomography projectors (counterpart of
``trips_tpu/operators/projector_op.py``).

Each apply generates the projector's weights for one view at a time from
per-view scalars and contracts them with the image at once; no matrix is
stored. The JAX operators map over views with ``lax.map``; here a Python
loop over views does, in plain PyTorch, on ``device`` (the CUDA card
unless ``device="cpu"``). Products run in full float32 (the
package turns TF32 off) or float64; the JAX package's
``TRIPS_TPU_PROJ_PRECISION`` knob sets a TPU matrix-unit pass count and has
no counterpart.

- ``OnTheFlyParallelProjector``: Joseph ('linear') parallel beam, equal to
  ``parallel_beam_matrix(..., model='linear')``.
- ``OnTheFlyFanProjector``: fan beam with exact chord lengths, equal to the
  Siddon ``fan_beam_matrix`` to roundoff.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.device import DEFAULT, resolve
from ..core.linop import LinearOperator


def _angle_params(theta, nx, ny, det_count, det_width):
    """Per-angle affine map for the Joseph crossing position.

    Joseph interpolates the image at the point where ray d crosses each
    line of the driving axis: the perpendicular pixel coordinate of that
    crossing is affine in both the driving index i and the detector index
    d:  pos(i, d) = P0 + Pi*i + Pd*d. Derived by inverting the ray
    parametrization used by ``problems.projector._joseph_parallel``
    (point = offs*u + t*dir, offs_d = (d-(p-1)/2)*det_width).
    """
    half = (det_count - 1) / 2.0
    c, sn = np.cos(theta), np.sin(theta)
    drive_is_y = abs(c) >= abs(sn)
    if drive_is_y:
        # drive over image rows i; perpendicular = column coordinate
        # x(offs, i) = offs/cos - yc(i)*tan ; xi = x + nx/2 - 0.5
        P0 = -half * det_width / c - (ny / 2.0 - 0.5) * np.tan(theta) \
            + nx / 2.0 - 0.5
        Pi = np.tan(theta)
        Pd = det_width / c
        step = 1.0 / abs(c)
    else:
        # drive over image columns j; perpendicular = row coordinate
        # y(offs, j) = offs/sin - xc(j)*cot ; yi = ny/2 - 0.5 - y
        P0 = ny / 2.0 - 0.5 + half * det_width / sn \
            + (-nx / 2.0 + 0.5) * (c / sn)
        Pi = c / sn
        Pd = -det_width / sn
        step = 1.0 / abs(sn)
    return drive_is_y, P0, Pi, Pd, step


class OnTheFlyParallelProjector(LinearOperator):
    """Parallel-beam Joseph projector, weights generated per apply.

    Rows are angle-major (angle * det_count + detector), matching
    ``parallel_beam_matrix``. Image is (ny, nx) row-major, ny == nx.
    """

    def __init__(self, nx, angles, det_count=None, det_width=1.0, ny=None,
                 dtype=torch.float32, device=DEFAULT):
        ny = ny or nx
        if ny != nx:
            raise NotImplementedError("square grids only")
        self.nx, self.ny = nx, ny
        self.det_count = det_count if det_count is not None else nx
        self.det_width = float(det_width)
        self.angles = np.asarray(angles, dtype=float)
        self.n_angles = len(self.angles)
        self.shape = (self.n_angles * self.det_count, nx * ny)
        self.dtype, self.device = dtype, resolve(device)
        params = [_angle_params(th, nx, ny, self.det_count, self.det_width)
                  for th in self.angles]
        self.drive_is_y = tuple(bool(pr[0]) for pr in params)
        self.P0, self.Pi, self.Pd, self.step = (
            torch.tensor([pr[k] for pr in params], dtype=dtype,
                         device=self.device) for k in range(1, 5))

    def _interp(self, a):
        """M (nx_drive, p, nx_perp) for angle a:
        M[i, d, c] = hat(pos(i, d) - c) * step  (Joseph linear weights)."""
        kw = dict(dtype=self.dtype, device=self.device)
        i_idx = c_idx = torch.arange(self.nx, **kw)  # square grid
        d_idx = torch.arange(self.det_count, **kw)
        pos = (self.P0[a] + self.Pi[a] * i_idx[:, None]
               + self.Pd[a] * d_idx[None, :])                  # (i, d)
        diff = pos[:, :, None] - c_idx[None, None, :]          # (i, d, c)
        return torch.clamp(1.0 - diff.abs(), min=0.0) * self.step[a]

    def matvec(self, x):
        X = x.reshape(self.ny, self.nx)
        y = [torch.einsum("idc,ic->d", self._interp(a),
                          X if self.drive_is_y[a] else X.T)
             for a in range(self.n_angles)]
        return torch.stack(y).reshape(-1)

    def rmatvec(self, y):
        Y = y.reshape(self.n_angles, self.det_count)
        out = torch.zeros((self.ny, self.nx), dtype=Y.dtype, device=Y.device)
        for a in range(self.n_angles):
            Xd = torch.einsum("idc,d->ic", self._interp(a), Y[a])
            out += Xd if self.drive_is_y[a] else Xd.T
        return out.reshape(-1)


class OnTheFlyFanProjector(LinearOperator):
    """Fan-beam 'line' (exact chord-length) projector, weights generated per
    apply.

    For each (angle, detector) the ray's crossings of every row band (and,
    for shallow rays, column band) are rational-affine in the detector
    index; the chord length inside pixel (i, c) is the clipped band
    interval overlap scaled by the band segment length. Matches the Siddon
    CSR matrix to ~1e-6 (f32) / 1e-12 (f64); rows are angle-major like the
    matrix builder.
    """

    def __init__(self, nx, angles=None, views=None, det_count=None,
                 det_width=None, source_origin=None, origin_det=None,
                 ny=None, dtype=torch.float32, device=DEFAULT):
        ny = ny or nx
        if ny != nx:
            raise NotImplementedError("square grids only")
        self.nx, self.ny = nx, ny
        if angles is None:
            angles = np.linspace(0, np.pi, views, endpoint=False)
        angles = np.asarray(angles, dtype=float)
        self.n_angles = len(angles)
        p = det_count if det_count is not None else int(np.sqrt(2) * nx)
        so = source_origin if source_origin is not None else 3 * nx
        od = origin_det if origin_det is not None else nx
        dw = det_width if det_width is not None else (so + od) / so
        self.det_count = p
        self.shape = (self.n_angles * p, nx * ny)
        self.dtype, self.device = dtype, resolve(device)

        offs = (np.arange(p) - (p - 1) / 2.0) * dw
        Sx = so * np.sin(angles)
        Sy = -so * np.cos(angles)
        D0x = -od * np.sin(angles)
        D0y = od * np.cos(angles)
        ux, uy = np.cos(angles), np.sin(angles)
        # per (angle, detector) ray endpoints
        Dx = D0x[:, None] + offs[None, :] * ux[:, None]
        Dy = D0y[:, None] + offs[None, :] * uy[:, None]
        self.Sx, self.Sy, self.Dx, self.Dy = (
            torch.tensor(v, dtype=dtype, device=self.device)
            for v in (Sx, Sy, Dx, Dy))
        # views whose whole fan shares one driving axis skip the other
        # axis's weights: "y" (rows), "x" (columns) or "m" (both)
        yd = np.abs(Dy - Sy[:, None]) >= np.abs(Dx - Sx[:, None])
        self._branch = tuple("y" if r.all() else "x" if not r.any() else "m"
                             for r in yd)

    def _band_weights(self, par_c, perp_c, S_par, S_perp, d_par, d_perp,
                      mask):
        """Crossings of bands along the 'par' axis; interp over 'perp'.

        par_c: band-center coordinates (n,), perp_c: pixel-center
        coordinates along the other axis (n,).
        Returns W (band, det, perp_pixel).
        """
        eps = 1e-12 if self.dtype == torch.float64 else 1e-6
        slope = d_perp / torch.where(d_par.abs() < eps,
                                     torch.full_like(d_par, eps), d_par)
        t1 = (par_c[:, None] - 0.5 - S_par) * slope[None, :] + S_perp
        t2 = (par_c[:, None] + 0.5 - S_par) * slope[None, :] + S_perp
        lo = torch.minimum(t1, t2)  # (band, det)
        hi = torch.maximum(t1, t2)
        span = hi - lo
        seglen = torch.sqrt(span * span + 1.0)
        # overlap with pixel intervals [perp_c - .5, perp_c + .5]
        ov = torch.clamp(
            torch.minimum(hi[:, :, None], perp_c[None, None, :] + 0.5)
            - torch.maximum(lo[:, :, None], perp_c[None, None, :] - 0.5),
            min=0.0)
        frac = ov / torch.clamp(span, min=eps)[:, :, None]
        inside = (lo[:, :, None] - perp_c[None, None, :]).abs() <= 0.5
        w = torch.where(span[:, :, None] < eps,
                        torch.where(inside, seglen[:, :, None],
                                    torch.zeros_like(frac)),
                        frac * seglen[:, :, None])
        return w * mask[None, :, None]

    def _grid_centers(self):
        kw = dict(dtype=self.dtype, device=self.device)
        yc = (self.ny / 2.0 - 0.5) - torch.arange(self.nx, **kw)
        xc = (-self.nx / 2.0 + 0.5) + torch.arange(self.nx, **kw)
        return yc, xc

    def _weights_y(self, a):
        dx = self.Dx[a] - self.Sx[a]
        dy = self.Dy[a] - self.Sy[a]
        yc, xc = self._grid_centers()
        mask = (dy.abs() >= dx.abs()).to(self.dtype)
        return self._band_weights(yc, xc, self.Sy[a], self.Sx[a], dy, dx,
                                  mask)

    def _weights_x(self, a):
        dx = self.Dx[a] - self.Sx[a]
        dy = self.Dy[a] - self.Sy[a]
        yc, xc = self._grid_centers()
        mask = (dy.abs() < dx.abs()).to(self.dtype)
        return self._band_weights(xc, yc, self.Sx[a], self.Sy[a], dx, dy,
                                  mask)

    def matvec(self, x):
        X = x.reshape(self.ny, self.nx)
        y = []
        for a, br in enumerate(self._branch):
            v = 0
            if br in "ym":
                v = v + torch.einsum("idc,ic->d", self._weights_y(a), X)
            if br in "xm":
                v = v + torch.einsum("jdr,rj->d", self._weights_x(a), X)
            y.append(v)
        return torch.stack(y).reshape(-1)

    def rmatvec(self, y):
        Y = y.reshape(self.n_angles, self.det_count)
        out = torch.zeros((self.ny, self.nx), dtype=Y.dtype, device=Y.device)
        for a, br in enumerate(self._branch):
            if br in "ym":
                out += torch.einsum("idc,d->ic", self._weights_y(a), Y[a])
            if br in "xm":
                out += torch.einsum("jdr,d->rj", self._weights_x(a), Y[a])
        return out.reshape(-1)
