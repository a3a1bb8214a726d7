"""Shear-rotate fan-beam projector (counterpart of
``trips_tpu/operators/fan_shear.py``).

A matrix-free fan-beam projector for the reference geometry
(``Tomography``'s: ``p = int(sqrt(2) * nx)`` detectors, ``so = 3 nx``,
``od = nx``, ``det_width = (so + od) / so``) in two dense stages:

A. **Rotate** each view's image into one canonical frame: an exact quarter
   turn (``rot90``) and a 3-shear rotation by the residual angle in
   [-45, 45) degrees, on a zero-padded C x C canvas sized so that no
   content wraps (kernel K4, ``shear_kernels.shear_rotate``).
B. **Fan contraction**: in that frame the geometry is the same for every
   view, so the sinogram is one product ``y[a, d] = sum_{i,c} R[a, i, c]
   G[i, c, d]`` with a view-independent constant ``G (C, C, p_pad)`` of
   2-tap hat weights at the ray/row crossings times the ray's step length.

The adjoint runs the transposed product and the exact transpose of the
rotation (K5), so ``<Ax, y> == <x, A'y>`` to roundoff. With
``TRIPS_TPU_SHEAR_ATA=1``, ``normal_matvec`` replaces the two stage-B
products by the fused contraction K6 (``gcontract_ata``), as the JAX
package does on a TPU; by default it is ``rmatvec(matvec(x))``.

The kernels' wrappers choose by device: on the CPU they run their plain
PyTorch versions (which also take float64), on a CUDA card the kernels.
The stage-B products are matrix products outside any kernel: float32 sums
and a float32 result also for a bfloat16 ``G``, as JAX's
``preferred_element_type=float32`` gives.
"""
from __future__ import annotations

import copy
import os

import numpy as np
import torch

from ..core.device import DEFAULT, resolve
from ..core.linop import LinearOperator
from .shear_kernels import gcontract_ata, shear_rotate, shear_rotate_adjoint


def _round_up(x, m):
    return ((x + m - 1) // m) * m


def _acc(dtype):
    return torch.float64 if dtype == torch.float64 else torch.float32


def _mm(a, b, acc):
    """``a @ b`` with ``acc`` sums and result; bfloat16 operands are
    multiplied exactly (on the card by a bf16 GEMM with a float32 output,
    elsewhere after a cast to ``acc``)."""
    if a.dtype == b.dtype == acc:
        return a @ b
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16 \
            and acc == torch.float32:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.to(acc) @ b.to(acc)


class ShearFanProjector(LinearOperator):
    """Fan-beam projector via shear rotation and one constant contraction.

    Sinogram rows are angle-major (``angle * p + detector``); the image is
    (ny, nx) row-major with row 0 at the top, as ``fan_beam_matrix``.
    ``dtype`` is the operator's working type (float32 on the card; float64
    only on the CPU). ``g_dtype`` is the storage type of ``G`` (float32 or
    bfloat16; the rotated canvases are rounded to it before stage B).
    ``device``: the CUDA card unless "cpu" is asked for.
    """

    _rot = staticmethod(shear_rotate)             # K4
    _rot_t = staticmethod(shear_rotate_adjoint)   # K5
    _ata = staticmethod(gcontract_ata)            # K6

    capturable = True  # K4-K6 and cuBLAS products; plans kept

    def __init__(self, nx, angles=None, views=None, det_count=None,
                 det_width=None, source_origin=None, origin_det=None,
                 ny=None, dtype=torch.float32, g_dtype=None, device=DEFAULT):
        ny = ny or nx
        if ny != nx:
            raise NotImplementedError("square grids only")
        if angles is None:
            angles = np.linspace(0, np.pi, views, endpoint=False)
        angles = np.asarray(angles, dtype=float)
        p = int(det_count) if det_count is not None else int(np.sqrt(2) * nx)
        so = float(source_origin) if source_origin is not None else 3.0 * nx
        od = float(origin_det) if origin_det is not None else float(nx)
        dw = float(det_width) if det_width is not None else (so + od) / so

        # canvas sizing: the largest shear excursion of the image disc
        r = nx / np.sqrt(2.0)
        bulge = r * np.sqrt(1.0 + np.tan(np.pi / 8) ** 2) + 3.0
        C = int(_round_up(int(np.ceil(2 * bulge)) + 2, 16))
        cc = (C - 1) / 2.0

        # per view: exact quarter turns k and the residual phi in [-45, 45);
        # the image is rotated by -theta, as shears in pull-back form
        # (out(c) = in(c + shift)): sx = -tan(phi/2) y per row, sy =
        # -sin(phi) x per column, applied as x, y, x
        k = np.round(angles / (np.pi / 2)).astype(int)
        phi = angles - k * (np.pi / 2)
        t_sh = np.tan(-phi / 2.0)
        m_sh = -np.sin(phi)
        y_line = cc - np.arange(C)
        x_line = np.arange(C) - cc
        sx = t_sh[:, None] * y_line[None, :]
        sy = m_sh[:, None] * x_line[None, :]
        kx, ky = np.floor(sx).astype(np.int64), np.floor(sy).astype(np.int64)
        self._setup(nx, p, so, od, dw, C, k, kx, sx - kx, ky, sy - ky, dtype,
                    g_dtype or dtype, device)
        self.G = self._build_g()

    @classmethod
    def from_numpy(cls, G, kx, fx, ky, fy, kq, C, nx, det_count,
                   source_origin, origin_det, det_width, dtype=torch.float32,
                   g_dtype=None, device=DEFAULT):
        """The operator from another build's arrays (the JAX operator's
        ``G``, ``_kx``, ``_fx``, ``_ky``, ``_fy``, ``_kq``, ``_C`` and
        geometry, as NumPy): the same bytes in both packages. ``G`` comes as
        float32 or float64 and is stored as ``g_dtype``."""
        op = cls.__new__(cls)
        op._setup(nx, det_count, source_origin, origin_det, det_width, C,
                  np.asarray(kq), np.asarray(kx), np.asarray(fx),
                  np.asarray(ky), np.asarray(fy), dtype, g_dtype or dtype,
                  device)
        op.G = torch.as_tensor(np.array(G), device=op.device).to(
            op.g_dtype).contiguous()
        return op

    def _setup(self, nx, p, so, od, dw, C, kq, kx, fx, ky, fy, dtype,
               g_dtype, device):
        na = len(kq)
        self.nx = self.ny = int(nx)
        self.det_count = int(p)
        self.n_angles = na
        self.shape = (na * self.det_count, self.nx * self.ny)
        self.dtype, self.g_dtype = dtype, g_dtype
        self.device = resolve(device)
        self._so, self._od, self._dw = float(so), float(od), float(dw)
        self._C = int(C)
        self._kq = tuple(int(v) for v in kq)
        dev = self.device

        def t(a, dt):
            return torch.as_tensor(np.array(a), device=dev).to(dt)

        self._kq_t = t(self._kq, torch.int32)
        self._kx, self._fx = t(kx, torch.int32), t(fx, dtype)
        self._ky, self._fy = t(ky, torch.int32), t(fy, dtype)

    def _build_g(self):
        """(C, C, p_pad) hat weights, computed in float64 on the device and
        rounded once to ``g_dtype``; the detector axis is padded to a
        multiple of 128 with zero columns."""
        C, p, nx = self._C, self.det_count, self.nx
        so, od, dw = self._so, self._od, self._dw
        cc = (C - 1) / 2.0
        r = nx / np.sqrt(2.0)
        f64 = dict(dtype=torch.float64, device=self.device)
        u = (torch.arange(p, **f64) - (p - 1) / 2.0) * dw
        yrow = cc - torch.arange(C, **f64)
        # ray d crosses row y at x = u_d * (y + so) / (so + od)
        q = u[None, :] * (yrow[:, None] + so) / (so + od) + cc        # (C, p)
        step = torch.sqrt(1.0 + (u / (so + od)) ** 2)
        live = (yrow.abs() <= (r + 1.5)).to(torch.float64)
        c0 = torch.floor(q)
        f = q - c0
        w = step[None, :] * live[:, None]                             # (C, p)
        i_idx, d_idx = torch.meshgrid(torch.arange(C, device=self.device),
                                      torch.arange(p, device=self.device),
                                      indexing="ij")
        G = torch.zeros((C, C, _round_up(p, 128)), dtype=self.g_dtype,
                        device=self.device)
        for col, val in ((c0, w * (1.0 - f)), (c0 + 1.0, w * f)):
            m = (col >= 0) & (col < C)
            G[i_idx[m], col[m].long(), d_idx[m]] = val[m].to(self.g_dtype)
        return G

    def to(self, device):
        """A copy with every tensor on ``device``."""
        op = copy.copy(self)
        op.device = torch.device(device)
        for name in ("G", "_kq_t", "_kx", "_fx", "_ky", "_fy"):
            setattr(op, name, getattr(self, name).to(op.device))
        return op

    # -- stages ------------------------------------------------------------
    def _quarters(self, X):
        C, nx = self._C, self.nx
        off = (C - nx) // 2
        canvas = torch.zeros((C, C), dtype=X.dtype, device=X.device)
        canvas[off:off + nx, off:off + nx] = X
        return torch.stack([canvas, torch.rot90(canvas, -1, (0, 1)),
                            torch.rot90(canvas, -2, (0, 1))])

    def _shifts(self):
        return self._kx, self._fx, self._ky, self._fy, self._kq_t

    def _rotate(self, X):
        """(ny, nx) image -> (na, C, C) rotated canvases in the G dtype."""
        Q = self._quarters(X.to(_acc(self.dtype)))
        return self._rot(Q, *self._shifts(), out_dtype=self.g_dtype)

    def _rotate_adjoint(self, Radj):
        """(na, C, C) cotangents -> (ny, nx) image."""
        Q = self._rot_t(Radj, *self._shifts())
        canvas = (Q[0] + torch.rot90(Q[1], 1, (0, 1))
                  + torch.rot90(Q[2], 2, (0, 1)))
        off = (self._C - self.nx) // 2
        return canvas[off:off + self.ny, off:off + self.nx]

    def _g2(self):
        return self.G.view(self._C * self._C, self.G.shape[2])

    def matvec(self, x):
        na, C = self.n_angles, self._C
        R = self._rotate(x.reshape(self.ny, self.nx).to(self.dtype))
        y = _mm(R.view(na, C * C), self._g2(), _acc(self.dtype))
        return y[:, :self.det_count].reshape(-1).to(self.dtype).to(x.dtype)

    def rmatvec(self, y):
        na, C = self.n_angles, self._C
        Y = y.reshape(na, self.det_count).to(self.dtype)
        Yp = torch.nn.functional.pad(
            Y, (0, self.G.shape[2] - self.det_count)).to(self.g_dtype)
        Radj = _mm(Yp, self._g2().T, _acc(self.dtype)).to(self.g_dtype)
        xt = self._rotate_adjoint(Radj.view(na, C, C))
        return xt.reshape(-1).to(y.dtype)

    def normal_matvec(self, x):
        """x -> A^T A x. With ``TRIPS_TPU_SHEAR_ATA=1`` the fused
        G-contraction K6 between the rotation and its adjoint (read at each
        call, as the JAX package reads it); otherwise the product pair."""
        if os.environ.get("TRIPS_TPU_SHEAR_ATA", "0") != "1":
            return self.rmatvec(self.matvec(x))
        R = self._rotate(x.reshape(self.ny, self.nx).to(self.dtype))
        Radj = self._ata(R, self.G).to(self.g_dtype)
        return self._rotate_adjoint(Radj).reshape(-1).to(x.dtype)

    def rmatmat(self, Y):
        return torch.stack([self.rmatvec(c) for c in Y.T], dim=1)
